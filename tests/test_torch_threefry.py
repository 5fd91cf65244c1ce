"""The port's PRNG against the JAX package: threefry2x32 bits, the derived
keys (``fold_in``, ``split``, ``step_keys``, the noise state's first key)
and the normal draws.

Bits and keys must be equal. The polynomial cos/sin are separate fp32
multiplies and adds in both packages, so they are bit-equal too. The
Box-Muller radius goes through libm's ``log``, which is not bit-portable
between XLA and torch: normals are held to a few ulp (measured max 2 ulp
over 262,144 pairs), and ``jax.random.normal`` (via ``erfinv``) to 2e-6
(measured max 4.8e-7 over 200 keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.barrier import step_keys as jax_step_keys
from repro.kernels.zsmask import threefry as jtf
from repro_torch.core import barrier, prng
from repro_torch.kernels.zsmask import threefry as ttf


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NORMAL_ULP = 4       # normal_pair: measured max 2 ulp (log's last bit)
ERFINV_ATOL = 2e-6   # jax.random.normal vs torch.erfinv: measured 4.8e-7


def _counters(seed, n=4096):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    # the top of the uint32 range, where an int64 emulation could overflow
    c0[:64] = np.arange(2 ** 32 - 64, 2 ** 32, dtype=np.uint64).astype(np.uint32)
    c1[64:128] = 2 ** 32 - 1
    return c0, c1


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def _ulp(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", [0, 1])
def test_threefry_bits_equal_jax(seed):
    c0, c1 = _counters(seed)
    for k0, k1 in [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (12345, 2 ** 31 + 7)]:
        y0, y1 = ttf.threefry2x32(k0, k1, _t(c0), _t(c1))
        j0, j1 = jtf.threefry2x32(k0, k1, jnp.asarray(c0), jnp.asarray(c1))
        np.testing.assert_array_equal(y0.numpy(), np.asarray(j0, np.int64))
        np.testing.assert_array_equal(y1.numpy(), np.asarray(j1, np.int64))


def test_turn_polynomials_bit_equal_jax():
    u = np.random.default_rng(2).random(8192, dtype=np.float32)
    u[:3] = [0.0, 0.5, 1.0]
    for tf, jf in ((ttf.cos_turn, jtf.cos_turn), (ttf.sin_turn, jtf.sin_turn)):
        np.testing.assert_array_equal(tf(torch.from_numpy(u)).numpy(),
                                      np.asarray(jf(jnp.asarray(u))))
    bits = _counters(3)[0]
    np.testing.assert_array_equal(ttf.uniform01(_t(bits)).numpy(),
                                  np.asarray(jtf.uniform01(jnp.asarray(bits))))


def test_normal_pair_within_a_few_ulp_of_jax():
    c0, c1 = _counters(4)
    z0, z1 = ttf.normal_pair(7, 11, _t(c0), _t(c1))
    j0, j1 = jtf.normal_pair(7, 11, jnp.asarray(c0), jnp.asarray(c1))
    u0, u1 = _ulp(z0.numpy(), np.asarray(j0)), _ulp(z1.numpy(), np.asarray(j1))
    assert max(u0.max(), u1.max()) <= NORMAL_ULP, (u0.max(), u1.max())
    stream = ttf.normal_stream(7, 11, _t(c0), 3)
    jstream = jtf.normal_stream(7, 11, jnp.asarray(c0), 3)
    assert _ulp(stream.numpy(), np.asarray(jstream)).max() <= NORMAL_ULP


def test_key_vectors_pinned():
    assert prng.fold_in(prng.PRNGKey(0), 0xD0) == (4086990474, 1067026239)
    assert prng.fold_in(prng.PRNGKey(0), 1) == (928981903, 3453687069)
    assert prng.split(prng.PRNGKey(0), 3) == [
        (1797259609, 2579123966), (928981903, 3453687069),
        (4146024105, 2718843009)]
    keys = barrier.step_keys(prng.PRNGKey(1), 0)
    assert keys.key_r == (3704974950, 1863054868)
    assert keys.key_xi == (2705940334, 2639757084)
    assert keys.key_clip == (788428910, 4288801516)
    assert abs(prng.normal(keys.key_clip) - (-0.8433168)) <= ERFINV_ATOL


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 5), (7, 123456),
                                       (2 ** 31 + 3, 2 ** 32 - 1)])
def test_keys_equal_jax(seed, step):
    root = jax.random.PRNGKey(seed)
    raw = lambda k: tuple(int(x) for x in np.asarray(jax.random.key_data(k)))
    assert prng.PRNGKey(seed) == raw(root)
    assert prng.fold_in(prng.PRNGKey(seed), step) == \
        raw(jax.random.fold_in(root, step))
    assert prng.split(prng.PRNGKey(seed), 5) == \
        [raw(k) for k in jax.random.split(root, 5)]
    jk = jax_step_keys(root, step)
    tk = barrier.step_keys(prng.PRNGKey(seed), step)
    for a, b in zip(tk, jk):
        assert a == tuple(int(x) for x in np.asarray(b))
    want = float(jax.random.normal(jax.random.wrap_key_data(jk.key_clip), ()))
    assert abs(prng.normal(tk.key_clip) - want) <= ERFINV_ATOL
