"""The per-leaf wrappers at one launch a tree: ``zsmask_buffer`` (the
per-leaf mask over every tensor of a packed buffer, the lambda-correction's
pass fused in) and ``per_example_sumsq_tree`` (every leaf's per-example sums of
squares), with the per-leaf clip route's one ``clip_accumulate`` over the
whole buffer and the padding zeroed in one fill.

On the CPU their plain versions are held bit for bit to the per-leaf loops
they replace (a ``zsmask`` per tensor, a second over zeros on ``prev_key``
with ``b = 0``, ``lam * prev`` and a subtraction; a ``per_example_sumsq``
and a ``clip_accumulate`` per leaf), and the callers to the JAX package:
the perleaf ``silo_contribution`` to JAX's ``DPPipeline.silo_contribution``
under the perleaf policy, the per-leaf clip route to JAX's
``_clip_and_sum_perleaf``. The tables the kernels walk are held to
``flatbuf.leaf_slices`` and ``masking.fold_leaf``. The card case (tree ==
per-leaf launches, bit for bit) skips without a CUDA device; the JAX
package is imported inside the tests that hold the port to it, so the file
also runs on a card's machine without JAX
(``python -m pytest -q tests/test_torch_tree_kernels.py -k card``).

Tolerances against JAX, each with what was measured on this CPU:
* a contribution carries ``+-b * r`` terms up to about ``10 B``; libm's
  ``log`` and XLA's fusions move a normal by an ulp or two: held to
  ``AGG_ATOL_PER_B * B`` (8 ulps of ``10 B``), as
  ``test_torch_barrier.py`` (measured 3.8e-6 at B = 4.8, 4.6e-5 allowed);
* norms 1e-6 relative and the clipped sum 1e-6 absolute on values up to
  0.51, as ``test_torch_per_example.py`` (measured 1.2e-7 and 6.0e-8).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import flatbuf, masking
from repro_torch.core.barrier import BarrierKeys
from repro_torch.core.dp_pipeline import DPPipeline
from repro_torch.core.noise_correction import NoiseState
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_clip import ops as clip_ops
from repro_torch.kernels.dp_clip import ref as clip_ref
from repro_torch.kernels.zsmask import ops as zs_ops
from repro_torch.kernels.zsmask import ref as zs_ref

AGG_ATOL_PER_B = 8 * 2.0 ** -23 * 10
RTOL = 1e-6
ATOL = 1e-6
N = 4
KEYS = ((3704974950, 1863054868), (2705940334, 2639757084),
        (788428910, 4288801516))
PREV_KEY = (4086990474, 1067026239)
M32 = 0xFFFFFFFF
PAD = 3.25  # what the padding holds; no tree kernel may touch it


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_leaves(seed, batch=None):
    """A small model's leaves, one stacked (``e``), as numpy: per-example
    ``(batch, ...)`` leaves when ``batch`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    shapes = {"a": (37,), "b": (3, 50), "c.d": (129,), "e": (3, 2, 64),
              "f": ()}
    leaves = {k: rng.standard_normal(lead + s).astype(np.float32)
              for k, s in shapes.items()}
    if batch is not None:  # norms over two decades
        w = np.logspace(-1, 1, batch, dtype=np.float32)
        leaves = {k: v * w.reshape((batch,) + (1,) * (v.ndim - 1))
                  for k, v in leaves.items()}
    return leaves


def _torch_tree(leaves, stacked_axis=0):
    return {k: ([torch.from_numpy(np.ascontiguousarray(
                    np.take(v, l, axis=stacked_axis)))
                 for l in range(v.shape[stacked_axis])] if k == "e"
                else torch.from_numpy(v)) for k, v in leaves.items()}


def _jax_tree(leaves):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, {
        "a": leaves["a"], "b": leaves["b"], "c": {"d": leaves["c.d"]},
        "e": leaves["e"], "f": leaves["f"]})


def _padded_buffer(layout, tree):
    """The packed buffer of ``tree`` with every padding position ``PAD``."""
    buf = flatbuf.pack(layout, tree)
    mask = torch.ones(layout.total, dtype=torch.bool)
    for off, numel, *_ in flatbuf.leaf_table(layout):
        mask[off:off + numel] = False
    buf[mask] = PAD
    return buf, mask


# ---------------------------------------------------------------------------
# the tables


def test_leaf_table_follows_leaf_slices_and_the_key_folds():
    """Rows in ``leaf_slices`` order: buffer offset, numel, leaf index, the
    counter offset mod 2**32 (a stacked leaf's third layer past 2**32 here:
    meta tensors, no memory), the prefix; the plain version folds leaf i's
    keys as ``masking.fold_leaf``."""
    big = (1 << 31) + 7
    tree = {"a": torch.empty(5, device="meta"),
            "w": [torch.empty(big, device="meta") for _ in range(3)],
            "z.b": torch.empty((4, 3), device="meta")}
    layout = flatbuf.layout_of(tree)
    rows = flatbuf.leaf_table(layout)
    start = 0
    got = []
    for (i, offset, t), row in zip(flatbuf.leaf_slices(layout, tree), rows,
                                   strict=True):
        got.append(row)
        assert row == (layout.offsets[i] + offset, t.numel(), i,
                       offset & M32, start)
        start += t.numel()
    assert [r[3] for r in rows] == [0, 0, big, (2 * big) & M32, 0]
    assert (2 * big) & M32 == 14 and 2 * big > M32
    assert flatbuf.leaf_table(layout) == rows
    for i in range(layout.n_leaves):
        for key, mult in ((KEYS[0], masking.R_FOLD),
                          (KEYS[1], masking.XI_FOLD),
                          (PREV_KEY, masking.XI_FOLD)):
            assert zs_ref.fold_key(key, mult, i) == \
                masking.fold_leaf(np.asarray(key, np.uint32), mult, i)


def test_zero_padding_is_one_fill_of_every_padding_position():
    """``padding_index`` holds every position no tensor covers, the tail
    past the last leaf included, ascending; ``zero_padding`` zeroes those
    and nothing else, as the slice a leaf it replaces did."""
    tree = _torch_tree(_numpy_leaves(1))
    layout = flatbuf.layout_of(tree)
    buf, pad = _padded_buffer(layout, tree)
    idx = flatbuf.padding_index(layout, buf.device)
    assert torch.equal(idx, pad.nonzero().view(-1))
    assert flatbuf.padding_index(layout, buf.device) is idx
    assert int(idx[-1]) == layout.total - 1  # the tail up to ALIGN
    want = buf.clone()
    for size, p, off in zip(layout.sizes, layout.padded, layout.offsets):
        want[off + size:off + p] = 0.0
    want[layout.offsets[-1] + layout.padded[-1]:] = 0.0
    got = flatbuf.zero_padding(layout, buf)
    assert got is buf
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[~pad], flatbuf.pack(layout, tree)[~pad])
    with pytest.raises(ValueError, match="layout"):
        flatbuf.zero_padding(layout, buf[:-1])


def test_variant_counts_count_each_instantiation_apart():
    """``zsmask_buffer`` counts its instantiations apart (the fp32 ones
    here; the bf16 ones, ``bf16`` and ``bf16_prev``, launched nothing),
    beside its total; ``reset_launches`` zeroes both."""
    k = dispatch.KERNELS["zsmask_buffer"]
    dispatch.reset_launches()
    k.count("prev")
    k.count("prev")
    k.count("plain")
    assert dispatch.launch_counts()["zsmask_buffer"] == 3
    counts = dispatch.variant_counts()
    assert counts.pop("zsmask_buffer") == {"plain": 1, "prev": 2,
                                           "bf16": 0, "bf16_prev": 0}
    # the other kernels built in more than one instantiation (the attention
    # and page-pool kernels, one a dtype) launched nothing
    assert all(n == 0 for v in counts.values() for n in v.values())
    dispatch.reset_launches()
    assert dispatch.launch_counts()["zsmask_buffer"] == 0
    assert dispatch.variant_counts()["zsmask_buffer"] == {
        "plain": 0, "prev": 0, "bf16": 0, "bf16_prev": 0}
    with pytest.raises(KeyError):
        k.count("other")
    dispatch.reset_launches()


def test_zsmask_buffer_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only; ``ops`` routes CPU ones to
    the plain version."""
    from repro_torch.kernels.zsmask.zsmask import zsmask_buffer_cuda
    tree = _torch_tree(_numpy_leaves(1))
    layout = flatbuf.layout_of(tree)
    buf = flatbuf.pack(layout, tree)
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        zsmask_buffer_cuda(buf, layout, one, one, KEYS[0], KEYS[1], 1, 2, N)


# ---------------------------------------------------------------------------
# zsmask_buffer's plain version against the per-leaf route


def _two_pass_route(buf, layout, silo, sigma_c, b, prev_key, lam):
    """Today's per-leaf route over a packed buffer: ``mask_leaf`` on each
    tensor in place, then with ``prev_key`` the mask-only pass over zeros
    with ``b = 0`` into scratch, ``lam * prev`` subtracted."""
    tree = flatbuf.unpack(layout, buf)
    most = max(t.numel() for t in flatbuf.flat_tensors(layout, tree))
    zeros = torch.zeros(most, device=buf.device)
    scratch = torch.empty(most, device=buf.device)
    for i, offset, t in flatbuf.leaf_slices(layout, tree):
        flat = t.view(-1)
        masking.mask_leaf(flat, KEYS[0], KEYS[1], i, offset, silo, N,
                          sigma_c, b, out=flat)
        if prev_key is not None:
            n = flat.numel()
            prev = masking.mask_leaf(zeros[:n], KEYS[0], prev_key, i, offset,
                                     silo, N, sigma_c, 0.0, out=scratch[:n])
            flat.sub_(lam * prev)
    return buf


@pytest.mark.parametrize("silo", [0, 3])
@pytest.mark.parametrize("use_prev,has_prev", [(False, True), (True, True),
                                               (True, False)])
def test_zsmask_tree_plain_equals_the_two_pass_route(silo, use_prev,
                                                     has_prev):
    layout = flatbuf.layout_of(_torch_tree(_numpy_leaves(1)))
    buf, pad = _padded_buffer(layout, _torch_tree(_numpy_leaves(1)))
    sigma_c = torch.tensor(0.3, dtype=torch.float32) * torch.tensor(2.0)
    b = 8.0 * sigma_c
    hp = torch.full((), 1.0 if has_prev else 0.0, dtype=torch.float32)
    lam = 0.7 * hp * 1.0
    prev_key = PREV_KEY if use_prev else None
    want = _two_pass_route(buf.clone(), layout, silo, sigma_c, b, prev_key,
                           lam)
    before = dispatch.launch_counts()
    got = masking.mask_buffer(buf, layout, KEYS[0], KEYS[1], silo, N,
                              sigma_c, b, prev_key, lam)
    assert dispatch.launch_counts() == before  # CPU: the plain version
    assert got is buf
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[pad] == PAD).all())
    assert bool(torch.isfinite(got).all())


def test_zsmask_tree_plain_wraps_the_counter_as_the_tensor_kernel():
    """A hand-made table whose second row starts 1000 counters before
    2**32: each row equals ``apply_zsmask`` at that offset."""
    g = torch.from_numpy(_numpy_leaves(2)["b"].reshape(-1))
    ctr = (1 << 32) - 1000
    table = ((0, 70, 4, 0, 0), (70, 80, 4, ctr, 70))
    got = zs_ref.zsmask_buffer_ref(g[:150].clone(), table, KEYS[0], KEYS[1],
                                   2, N, 1.2, 9.6)
    kr = zs_ref.fold_key(KEYS[0], zs_ref.R_FOLD, 4)
    kx = zs_ref.fold_key(KEYS[1], zs_ref.XI_FOLD, 4)
    for off, numel, _, c, _ in table:
        want = zs_ops.apply_zsmask(g[off:off + numel], kr, kx, 2, N, 1.2,
                                   9.6, offset=c)
        assert torch.equal(got[off:off + numel], want)


# ---------------------------------------------------------------------------
# the perleaf contribution: one tree dispatch, against JAX


def _pipelines(priv):
    from repro.configs.base import PrivacyConfig as JaxPrivacy
    from repro.core import flatbuf as jflat
    from repro.core.dp_pipeline import DPPipeline as JaxPipeline
    leaves = _numpy_leaves(3)
    jl = jflat.layout_of(_jax_tree(leaves))
    tl = flatbuf.layout_of(_torch_tree(leaves))
    assert (jl.offsets, jl.total) == (tl.offsets, tl.total)
    jpipe = JaxPipeline(JaxPrivacy(**priv), jl, N, policy="perleaf")
    pipe = DPPipeline(PrivacyConfig(**priv), tl, N, policy="perleaf")
    assert jpipe.policy.mode == pipe.policy.mode == "perleaf"
    return jpipe, pipe


@pytest.mark.parametrize("has_prev,lam", [(False, 0.7), (True, 0.7),
                                          (True, 0.0)])
def test_contribution_perleaf_matches_jax(has_prev, lam):
    import jax.numpy as jnp

    from repro.core import flatbuf as jflat
    from repro.core.barrier import BarrierKeys as JaxKeys
    from repro.core.noise_correction import NoiseState as JaxNoiseState
    priv = dict(enabled=True, sigma=0.3, clip_bound=2.0, noise_lambda=lam,
                sync_path="barrier")
    jpipe, pipe = _pipelines(priv)
    bound = 2.0
    jkeys = JaxKeys(*(jnp.asarray(k, jnp.uint32) for k in KEYS))
    jstate = JaxNoiseState(jnp.asarray(PREV_KEY, jnp.uint32),
                           jnp.asarray(has_prev), jnp.ones(N, bool))
    state = NoiseState(PREV_KEY, has_prev, np.ones(N, bool))
    atol = AGG_ATOL_PER_B * PrivacyConfig().mask_scale * 0.3 * bound
    for i in range(N):
        leaves = _numpy_leaves(10 + i)
        jg, tg = _jax_tree(leaves), _torch_tree(leaves)
        jscale = jpipe.clip_scale(jpipe.norm_tree(jg), bound)
        jc = jpipe.silo_contribution(jg, i, jscale, jnp.ones(N, bool), jkeys,
                                     jstate, jnp.float32(bound))
        scale = pipe.clip_scale(pipe.norm_tree(tg), torch.tensor(bound))
        np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-5)
        got = pipe.silo_contribution(tg, i, scale, np.ones(N, bool),
                                     BarrierKeys(*KEYS), state,
                                     torch.tensor(bound))
        np.testing.assert_allclose(
            flatbuf.pack(pipe.layout, got).numpy(),
            np.asarray(jflat.pack(jpipe.layout, jc)), atol=atol, rtol=0)
        # and bit for bit the per-leaf route it replaces
        hp = torch.full((), 1.0 if has_prev else 0.0, dtype=torch.float32)
        sigma_c = 0.3 * torch.tensor(bound, dtype=torch.float32)
        want = _two_pass_route(
            torch.mul(flatbuf.pack(pipe.layout, tg), scale), pipe.layout, i,
            sigma_c, PrivacyConfig().mask_scale * sigma_c,
            PREV_KEY if lam > 0 else None, lam * hp * 1.0)
        assert torch.equal(flatbuf.pack(pipe.layout, got), flatbuf.pack(
            pipe.layout, flatbuf.unpack(pipe.layout, want)))


def test_contribution_perleaf_works_in_place():
    """``out`` the packed gradient itself: the tree is views of it."""
    priv = dict(enabled=True, sigma=0.3, clip_bound=2.0, noise_lambda=0.7,
                sync_path="barrier")
    _, pipe = _pipelines(priv)
    g = flatbuf.pack(pipe.layout, _torch_tree(_numpy_leaves(4)))
    args = (1, torch.tensor(0.5), None, BarrierKeys(*KEYS),
            NoiseState(PREV_KEY, True, np.ones(N, bool)), torch.tensor(2.0))
    want = flatbuf.pack(pipe.layout, pipe.silo_contribution(g.clone(), *args))
    tree = pipe.silo_contribution(g, *args, out=g)
    assert tree["a"].data_ptr() == g.data_ptr()
    assert torch.equal(g, want)


# ---------------------------------------------------------------------------
# per_example_sumsq_tree and the one-launch clip route


def _per_example_buffer(B, seed):
    leaves = _numpy_leaves(seed, batch=B)
    ttree = _torch_tree(leaves, stacked_axis=1)
    layout = flatbuf.layout_of({k: [t[0] for t in v] if isinstance(v, list)
                                else v[0] for k, v in ttree.items()})
    return leaves, layout, flatbuf.pack_rows(layout, ttree)


def _per_leaf_loop(buf, clip_bound, layout):
    """Today's per-leaf clip route: a ``sumsq`` and a ``clip_accumulate``
    a leaf, the per-leaf sums added in leaf order."""
    cols = [buf[:, off:off + size]
            for off, size in zip(layout.offsets, layout.sizes)]
    sums = [clip_ops.sumsq(c) for c in cols]
    total = sum(sums)
    scale = clip_ref.clip_scales(total, clip_bound)
    summed = torch.empty(layout.total, device=buf.device)
    for off, size, c in zip(layout.offsets, layout.sizes, cols):
        summed[off:off + size] = clip_ops.clip_accumulate(c, scale)
    flatbuf.zero_padding(layout, summed)
    return summed, torch.sqrt(total), sums


@pytest.mark.parametrize("B", [1, 5])
def test_sumsq_tree_plain_and_the_clip_route_equal_the_per_leaf_loop(B):
    _, layout, buf = _per_example_buffer(B, seed=5)
    want_sum, want_norms, want_sums = _per_leaf_loop(buf, 1.5, layout)
    total, per_leaf = clip_ops.sumsq_tree(buf, layout, per_leaf=True)
    assert per_leaf.shape == (layout.n_leaves, B)
    for l, s in enumerate(want_sums):
        assert torch.equal(per_leaf[l], s)
    assert torch.equal(total, sum(want_sums))
    assert torch.equal(total, clip_ref.per_example_sumsq_tree_ref(
        buf, layout.offsets, layout.sizes))
    before = dispatch.launch_counts()
    tree, norms = clip_ops.clip_and_sum_tree(buf, 1.5, "perleaf",
                                             layout=layout)
    assert dispatch.launch_counts() == before
    assert torch.equal(norms, want_norms)
    assert torch.equal(flatbuf.pack(layout, tree), want_sum)


def test_perleaf_clip_route_matches_jax():
    from repro.core import flatbuf as jflat
    from repro.kernels.dp_clip import ops as jclip_ops
    leaves, layout, buf = _per_example_buffer(4, seed=6)
    jtree = _jax_tree(leaves)
    jsum, jnorms = jclip_ops._clip_and_sum_perleaf(jtree, 2.0)
    tree, norms = clip_ops.clip_and_sum_tree(buf, 2.0, "perleaf",
                                             layout=layout)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=RTOL)
    np.testing.assert_allclose(
        flatbuf.pack(layout, tree).numpy(),
        np.asarray(jflat.pack(jflat.layout_of(jsum), jsum)), atol=ATOL,
        rtol=0)


def test_clip_accumulate_writes_into_out():
    g = torch.from_numpy(_numpy_leaves(7, batch=3)["b"].reshape(3, -1))
    scale = torch.tensor([0.5, 1.0, 0.25])
    out = torch.full((150,), 9.0)
    assert clip_ops.clip_accumulate(g, scale, out=out) is out
    assert torch.equal(out, clip_ref.clip_accumulate_ref(g, scale))


# ---------------------------------------------------------------------------
# the card: the tree kernels == the per-leaf launches, bit for bit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


@pytest.mark.parametrize("use_prev", [False, True])
def test_tree_kernels_equal_the_per_leaf_launches_on_the_card(cuda,
                                                              use_prev):
    tree = _torch_tree(_numpy_leaves(8))
    layout = flatbuf.layout_of(tree)
    buf, pad = _padded_buffer(layout, tree)
    buf, pad = buf.to(cuda), pad.to(cuda)
    sigma_c = torch.full((), 0.6, device=cuda)
    b = 8.0 * sigma_c
    lam = 0.7 * torch.full((), 1.0, device=cuda)
    prev_key = PREV_KEY if use_prev else None
    dispatch.reset_launches()
    want = _two_pass_route(buf.clone(), layout, 1, sigma_c, b, prev_key, lam)
    n_tensors = len(flatbuf.leaf_table(layout))
    assert dispatch.KERNELS["zsmask"].launches == \
        n_tensors * (2 if use_prev else 1)
    got = masking.mask_buffer(buf.clone(), layout, KEYS[0], KEYS[1], 1, N,
                              sigma_c, b, prev_key, lam)
    again = masking.mask_buffer(buf.clone(), layout, KEYS[0], KEYS[1], 1, N,
                                sigma_c, b, prev_key, lam)
    plain = zs_ref.zsmask_buffer_ref(
        buf.clone(), flatbuf.leaf_table(layout), KEYS[0], KEYS[1], 1, N,
        sigma_c, b, prev_key, lam)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["zsmask_buffer"].launches == 2
    assert dispatch.variant_counts()["zsmask_buffer"] == {
        "plain": 0 if use_prev else 2, "prev": 2 if use_prev else 0,
        "bf16": 0, "bf16_prev": 0}
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got, plain)
    assert bool((got[pad] == PAD).all())
    # the per-example norms: the tree's per-leaf sums == a launch a leaf
    _, layout_pe, pe = _per_example_buffer(5, seed=9)
    pe = pe.to(cuda)
    dispatch.reset_launches()
    want_sum, want_norms, want_sums = _per_leaf_loop(pe, 1.5, layout_pe)
    total, per_leaf = clip_ops.sumsq_tree(pe, layout_pe, per_leaf=True)
    tree_pe, norms = clip_ops.clip_and_sum_tree(pe, 1.5, "perleaf",
                                                layout=layout_pe)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["per_example_sumsq_tree"].launches == 2
    assert torch.equal(per_leaf, torch.stack(want_sums))
    assert torch.equal(total, sum(want_sums))
    assert torch.equal(norms, want_norms)
    assert torch.equal(flatbuf.pack(layout_pe, tree_pe), want_sum)
    # a buffer the kernels do not take raises: no per-leaf fallback
    with pytest.raises(ValueError, match="layout"):
        masking.mask_buffer(buf[:-1].clone(), layout, KEYS[0], KEYS[1], 1, N,
                            sigma_c, b, prev_key, lam)
    with pytest.raises(ValueError, match="dtype"):
        masking.mask_buffer(buf.double(), layout, KEYS[0], KEYS[1], 1, N,
                            sigma_c, b, prev_key, lam)
    with pytest.raises(ValueError, match="columns"):
        clip_ops.sumsq_tree(pe[:, :-4], layout_pe)
