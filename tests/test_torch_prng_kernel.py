"""The per-leaf ``jax.random.normal`` draw of the port (``kernels/prng``):
its plain versions against the JAX package, and the routes through it.

* ``bits`` equal JAX's bit for bit, and the plain ``normal`` lies within
  ``NORMAL_ULP`` of ``jax.random.normal`` (its ``erfinv`` goes through
  libm's ``log1p``, XLA's own in JAX); at counters that cross 2**32 (no
  leaf today reaches them) both are held to JAX's ``threefry_2x32`` on the
  same ``(hi, lo)`` counters and to XLA's float32 transform of those
  words.
* ``normal_combine_ref`` equals ``corrected_noise``'s former window loop
  (``xi_t * sc - (xi_{t-1} * sc) * gate`` added window by window) bit for
  bit, with both windows cut small so that windows and ragged tails occur:
  with and without a previous step, at ``lam == 0`` and over a stacked
  leaf's tensors at their offsets; the same for the admin ``xi`` with an
  ``XiCorrection`` (``admin_xi``, ``add_admin_noise``, a closing row).
* ``corrected_noise`` and ``add_admin_noise`` on the CPU still equal JAX's
  ``corrected_noise`` and ``admin_xi`` trees within ``NOISY_ATOL``.
* CPU tensors launch nothing; the wrappers refuse what the kernel does not
  take.

The card's cases (kernel == plain version bit for bit at ragged sizes and
past 2**32, one launch a leaf tensor) are in
``tests/test_torch_cuda_kernels.py``, which imports no JAX and runs on the
GPU machine; ``chip_smoke.py --normal`` runs the full check there.
"""
import jax
import jax.extend.random as jrandom
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro.core import masking as jmask
from repro.core import noise_correction as jnoise
from repro_torch.core import flatbuf, masking, noise_correction, prng
from repro_torch.core.noise_correction import NoiseState
from repro_torch.kernels import dispatch
from repro_torch.kernels.prng import ops, ref

NORMAL_ULP = 3      # plain normal vs jax.random.normal: log1p's last bits
NOISY_ATOL = 4e-6   # noise trees of std about 1.5 vs JAX's, as above
KEY, PREV = (2705940334, 2639757084), (4086990474, 1067026239)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(a, b):
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


def _jax_words(key, offset, n):
    """``y0 ^ y1`` of JAX's ``threefry_2x32`` at counters ``(i >> 32, i &
    M32)``, i = offset .. offset + n - 1."""
    i = np.arange(offset, offset + n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y = np.asarray(jrandom.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                         jnp.concatenate([hi, lo])))
    return y[:n] ^ y[n:]


def _jax_normal_of_words(w):
    """XLA's float32 ``jax.random.normal`` transform of uint32 words: the
    mantissa uniform on [nextafter(-1, 0), 1), ``erf_inv``, sqrt(2)."""
    f = jax.lax.bitcast_convert_type((jnp.asarray(w, jnp.uint32) >> 9)
                                     | jnp.uint32(0x3F800000),
                                     jnp.float32) - 1.0
    lo = jnp.nextafter(jnp.float32(-1.0), jnp.float32(0.0))
    u = jnp.maximum(lo, f * (jnp.float32(1.0) - lo) + lo)
    return np.asarray(jnp.float32(np.sqrt(2.0)) * jax.lax.erf_inv(u))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 129), (1 << 15,)])
def test_plain_normal_and_bits_match_jax(shape):
    jkey = jax.random.wrap_key_data(jnp.asarray(KEY, jnp.uint32))
    np.testing.assert_array_equal(
        prng.bits(KEY, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    got = prng.normal(KEY, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _ulp(got.numpy(), want).max() <= NORMAL_ULP
    # the words JAX's normal is made of are the words of threefry_2x32
    n = int(np.prod(shape))
    np.testing.assert_array_equal(_jax_words(KEY, 0, n),
                                  np.asarray(jax.random.bits(
                                      jkey, (n,), jnp.uint32)))


@pytest.mark.parametrize("offset", [(1 << 32) - 700, (1 << 33) + 5,
                                    (3 << 40) - 1])
def test_counters_past_2_32_match_jax_threefry(offset):
    n = 1500
    words = _jax_words(KEY, offset, n)
    np.testing.assert_array_equal(
        prng.bits(KEY, (n,), offset).numpy().astype(np.uint32), words)
    z = ref.normal_ref(KEY, n, offset)
    assert _ulp(z.numpy(), _jax_normal_of_words(words)).max() <= NORMAL_ULP
    # a draw that starts below 2**32 and one that starts at its crossing
    # agree where they overlap
    part = ref.normal_ref(KEY, 900, offset + 600)
    assert torch.equal(part, z[600:])


def _old_corrected_noise(tree, key_t, state, sigma_c, lam, window):
    """``corrected_noise`` as the port ran it before the kernel: per leaf
    tensor, ``window`` counters at a time, xi_t and xi_{t-1} drawn whole,
    combined and added in place."""
    layout = flatbuf.layout_of(tree)
    keys_t = prng.split(key_t, layout.n_leaves)
    keys_p = prng.split(state.prev_key, layout.n_leaves) if lam != 0.0 \
        else None
    sc = torch.tensor(sigma_c, dtype=torch.float32)
    gate = torch.tensor(lam if state.has_prev else 0.0, dtype=torch.float32)
    for i, offset, t in flatbuf.leaf_slices(layout, tree):
        flat = t.view(-1)
        for a in range(0, flat.numel(), window):
            b = min(a + window, flat.numel())
            z = ref.normal_ref(keys_t[i], b - a, offset + a).mul_(sc)
            if keys_p is not None:
                zp = ref.normal_ref(keys_p[i], b - a, offset + a)
                z.sub_(zp.mul_(sc).mul_(gate))
            flat[a:b].add_(z)
    return tree


def _tree(seed):
    """A tree with a stacked leaf (its tensors at offsets 0, 300, 600)."""
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal(1000).astype(
                np.float32)),
            "b": torch.from_numpy(rng.standard_normal((3, 77)).astype(
                np.float32)),
            "e": [torch.from_numpy(rng.standard_normal((5, 60)).astype(
                np.float32)) for _ in range(3)]}


def _pack(tree):
    return flatbuf.pack(flatbuf.layout_of(tree), tree)


@pytest.mark.parametrize("has_prev,lam", [(True, 0.7), (False, 0.7),
                                          (True, 0.0)])
def test_normal_combine_ref_equals_the_window_loop(has_prev, lam,
                                                   monkeypatch):
    want = _old_corrected_noise(_tree(0), KEY, NoiseState(PREV, has_prev),
                                1.2, lam, window=96)
    monkeypatch.setattr(ref, "WINDOW", 64)  # windows, ragged tails
    got, st = noise_correction.corrected_noise(
        _tree(0), KEY, NoiseState(PREV, has_prev), torch.tensor(1.2), lam)
    assert torch.equal(_pack(got), _pack(want))
    assert st.prev_key == KEY and st.has_prev
    # the entry alone: a stacked leaf's tensor at its offset, written (not
    # added) and added
    kt, kp = prng.split(KEY, 3)[2], prng.split(PREV, 3)[2]
    sc, g = torch.tensor(1.2), torch.tensor(lam)
    out = torch.full((5, 60), 0.5)
    ops.normal_combine(out, kt, kp, 300, sc, sc, g)
    z = ref.normal_ref(kt, 300, 300).mul_(sc)
    z.sub_(ref.normal_ref(kp, 300, 300).mul_(sc).mul_(g))
    assert torch.equal(out.view(-1), z)
    ops.normal_combine(out, kt, None, 300, sc, accumulate=True)
    assert torch.equal(out.view(-1), z + ref.normal_ref(kt, 300, 300) * sc)


@pytest.mark.parametrize("has_prev", [True, False])
def test_admin_xi_combine_equals_plain_draws(has_prev, monkeypatch):
    """The admin ``xi`` with an ``XiCorrection`` (one ``normal_combine``)
    equals ``x = xi * sc; c = xi_c * csc; x - c * clam`` drawn window by
    window, in ``admin_xi``, ``add_admin_noise`` and the closing row."""
    t = _tree(1)
    layout = flatbuf.layout_of(t)
    sc, csc = torch.tensor(1.5), torch.tensor(1.25)
    clam = torch.tensor(0.7 if has_prev else 0.0)
    corr = masking.XiCorrection(PREV, csc, clam)
    kxis = masking._leaf_keys(KEY, layout.n_leaves)[1]
    ckeys = masking._leaf_keys(PREV, layout.n_leaves)[1]
    want = torch.empty(layout.total)
    for i, offset, x in flatbuf.leaf_slices(layout, t):
        base = layout.offsets[i] + offset
        for a in range(0, x.numel(), 50):
            b = min(a + 50, x.numel())
            v = ref.normal_ref(kxis[i], b - a, offset + a).mul_(sc)
            c = ref.normal_ref(ckeys[i], b - a, offset + a).mul_(csc)
            want[base + a:base + b] = v.sub_(c.mul_(clam))
    want = flatbuf.zero_padding(layout, want)
    monkeypatch.setattr(masking, "WINDOW", 100)
    monkeypatch.setattr(ref, "WINDOW", 64)
    xi = masking.admin_xi(KEY, t, sc)  # no correction: xi * sc alone
    noisy = masking.add_admin_noise(_tree(1), KEY, sc, corr)
    assert torch.equal(_pack(noisy), _pack(_tree(1)) + want)
    no_corr = masking.add_admin_noise(
        {k: [torch.zeros_like(x) for x in v] if isinstance(v, list)
         else torch.zeros_like(v) for k, v in t.items()}, KEY, sc)
    assert torch.equal(_pack(no_corr), _pack(xi))
    # the closing row of one silo: xi - correction, then u subtracted
    row = masking.admin_mask_row(KEY, t, 1, 0, sc, 8.0, correction=corr)
    assert torch.equal(_pack(row), want)


@pytest.mark.parametrize("has_prev,lam", [(False, 0.7), (True, 0.7),
                                          (True, 0.0)])
def test_corrected_noise_and_admin_noise_match_jax(has_prev, lam):
    t = _tree(2)
    zeros = {k: [torch.zeros_like(x) for x in v] if isinstance(v, list)
             else torch.zeros_like(v) for k, v in t.items()}
    jt = {k: jnp.zeros((len(v),) + tuple(v[0].shape)) if isinstance(v, list)
          else jnp.zeros(tuple(v.shape)) for k, v in t.items()}
    jlayout = jflat.layout_of(jt)
    jn, _ = jnoise.corrected_noise(
        jt, jnp.asarray(KEY, jnp.uint32),
        jnoise.NoiseState(jnp.asarray(PREV, jnp.uint32),
                          jnp.asarray(has_prev)), jnp.float32(1.2), lam)
    tn, _ = noise_correction.corrected_noise(
        zeros, KEY, NoiseState(PREV, has_prev), torch.tensor(1.2), lam)
    np.testing.assert_allclose(_pack(tn).numpy(),
                               np.asarray(jflat.pack(jlayout, jn)),
                               atol=NOISY_ATOL, rtol=0)
    # admin: xi_t(KEY) - lam * xi(PREV), JAX's admin_xi trees
    jkey = jax.random.wrap_key_data(jnp.asarray(KEY, jnp.uint32))
    jprev = jax.random.wrap_key_data(jnp.asarray(PREV, jnp.uint32))
    gate = lam if has_prev else 0.0
    want = jax.tree.map(lambda a, b: a - gate * b,
                        jmask.admin_xi(jkey, jt, jnp.float32(1.2)),
                        jmask.admin_xi(jprev, jt, jnp.float32(1.2)))
    got = masking.add_admin_noise(
        {k: [torch.zeros_like(x) for x in v] if isinstance(v, list)
         else torch.zeros_like(v) for k, v in t.items()}, KEY,
        torch.tensor(1.2), masking.XiCorrection(PREV, torch.tensor(1.2),
                                                torch.tensor(gate)))
    np.testing.assert_allclose(_pack(got).numpy(),
                               np.asarray(jflat.pack(jlayout, want)),
                               atol=NOISY_ATOL, rtol=0)


def test_cpu_tensors_launch_nothing():
    dispatch.reset_launches()
    t = _tree(3)
    prng.normal(KEY, (100,), 5)
    ops.normal(KEY, 3, torch.empty(4, 5))
    ops.normal_combine(torch.zeros(9), KEY, PREV, 0, torch.tensor(1.0),
                       torch.tensor(1.0), torch.tensor(0.7), True)
    noise_correction.corrected_noise(t, KEY, NoiseState(PREV, True),
                                     torch.tensor(1.0), 0.7)
    masking.add_admin_noise(t, KEY, torch.tensor(1.0),
                            masking.XiCorrection(PREV, torch.tensor(1.0),
                                                 torch.tensor(0.7)))
    masking.admin_masks(KEY, t, 3, 1.0, 8.0)
    assert not any(dispatch.launch_counts().values())
    assert {"normal", "normal_combine"} <= set(dispatch.KERNELS)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    sc = torch.tensor(1.0)
    with pytest.raises(ValueError, match="contiguous fp32"):
        ops.normal(KEY, 0, torch.empty(4, 6).t())
    with pytest.raises(ValueError, match="contiguous fp32"):
        ops.normal(KEY, 0, torch.empty(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="out of range"):
        ops.normal(KEY, -1, torch.empty(4))
    with pytest.raises(ValueError, match="out of range"):
        ops.normal_combine(torch.empty(4), KEY, None, (1 << 63) - 2, sc)
    with pytest.raises(ValueError, match="0-dim fp32 tensor"):
        ops.normal_combine(torch.empty(4), KEY, None, 0, 1.0)
    with pytest.raises(ValueError, match="0-d"):
        ops.normal_combine(torch.empty(4), KEY, PREV, 0, sc, sc,
                           torch.ones(1))
    with pytest.raises(ValueError, match="dtype"):
        ops.normal_combine(torch.empty(4), KEY, None, 0,
                           torch.tensor(1.0, dtype=torch.float64))
    # a key of more than 32 bits a word is refused where it is checked:
    # on the card (the plain version masks nothing either way)
    assert ops.normal(KEY, 0, torch.empty(0)).numel() == 0
