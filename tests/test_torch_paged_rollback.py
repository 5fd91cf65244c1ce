"""The port's rollback (the speculative rejected-tail eraser) against the
JAX package's ``paged_rollback``: the Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU, bit for bit, and JAX's jnp
reference by value. The same numpy pools go to both; the Pallas path's jit
donates its inputs, so every JAX call gets fresh arrays. On CPU tensors the
port runs the plain version; the CUDA kernel is held to it on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jax_ops
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.paged_attention import (
    PAGED_ROLLBACK, pool_zero_cuda)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, N, P, H, D = 2, 8, 4, 2, 8
ROW = np.array([5, 2, 7, 0], np.int32)  # a slot's four distinct pages


def _pools(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, N, P, H, D)).astype(np.float32)
    v = rng.standard_normal((L, N, P, H, D)).astype(np.float32)
    return k, v


def _port(k, v, row, start, end):
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ops.paged_rollback(kt, vt, torch.from_numpy(row), start, end)
    return kt.numpy(), vt.numpy()


def _jax(k, v, row, start, end, impl):
    kj, vj = jax_ops.paged_rollback(jnp.array(k), jnp.array(v),
                                    jnp.asarray(row), start, end, impl=impl)
    return np.asarray(kj), np.asarray(vj)


def _assert_bits_equal(got, want):
    """Bit equality: tells +0.0 from -0.0, and NaN from a number."""
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _dead(row, start, end):
    """(page, offset) of every position in [start, end) of ``row``."""
    return [(int(row[p // P]), p % P) for p in range(start, end)]


@pytest.mark.parametrize("start,end", [
    (5, 7),     # within one page
    (3, 6),     # straddling a page boundary
    (2, 13),    # spanning pages
    (13, 16),   # ending at the row's end
    (6, 6),     # empty
    (9, 4),     # empty, reversed
])
def test_plain_rollback_bit_equal_to_pallas(start, end):
    k, v = _pools()
    got = _port(k, v, ROW, start, end)
    want = _jax(k, v, ROW, start, end, "pallas")
    for g, w, orig in zip(got, want, (k, v)):
        _assert_bits_equal(g, w)
        expect = orig.copy()
        for page, off in _dead(ROW, start, end):
            expect[:, page, off] = 0.0
        _assert_bits_equal(g, expect)  # the range zeroed, nothing else


def test_padded_row_with_duplicate_ids():
    """A table row pads with its first page; the slice to the range's pages
    leaves the duplicates out, so the result is the Pallas kernel's."""
    row = np.array([5, 2, 5, 5, 5, 5], np.int32)  # 2 owned pages, padded
    k, v = _pools(1)
    for start, end in ((5, 8), (1, 8), (0, 3)):
        got = _port(k, v, row, start, end)
        want = _jax(k, v, row, start, end, "pallas")
        for g, w in zip(got, want):
            _assert_bits_equal(g, w)
    # the plain version itself takes repeated ids in its row: each lane of
    # the range is zeroed however often its page is named
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ops.paged_rollback(kt, vt, torch.tensor([3, 3, 3], dtype=torch.int32),
                       2, 11)
    assert (kt[:, 3] == 0).all() and (vt[:, 3] == 0).all()
    keep = [i for i in range(N) if i != 3]
    _assert_bits_equal(kt[:, keep].numpy(), k[:, keep])


def test_poisoned_dead_lanes_become_plus_zero():
    """NaN and negative values in the dead lanes: the Pallas kernel's
    ``where`` writes +0.0, and so does the port; JAX's jnp reference
    multiplies by a 0/1 mask and leaves -0.0 and NaN (compared by value
    below, where no NaN lies in the range)."""
    k, v = _pools(2)
    k, v = -np.abs(k), -np.abs(v)
    k[:, 2, 1:, 0, :3] = np.nan   # dead positions 5..7 of the row
    v[:, 7, 0] = np.nan           # dead position 8
    v[:, 0, 3] = np.nan           # live position 15: stays NaN
    start, end = 5, 10
    got = _port(k, v, ROW, start, end)
    want = _jax(k, v, ROW, start, end, "pallas")
    for g, w in zip(got, want):
        _assert_bits_equal(g, w)
        for page, off in _dead(ROW, start, end):
            assert not np.signbit(g[:, page, off]).any()
            assert (g[:, page, off] == 0).all()
    assert np.isnan(got[1][:, 0, 3]).all()


def test_jnp_reference_agrees_by_value():
    k, v = _pools(3)
    k, v = -np.abs(k), v
    start, end = 3, 10
    got = _port(k, v, ROW, start, end)
    want = _jax(k, v, ROW, start, end, "jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)  # -0.0 == +0.0 by value
    page, off = _dead(ROW, start, end)[0]
    assert np.signbit(want[0][:, page, off]).all()   # the reference: -0.0
    assert not np.signbit(got[0][:, page, off]).any()  # the port: +0.0


def test_cpu_tensors_count_no_launch():
    before = dispatch.launch_counts()
    k, v = _pools()
    _port(k, v, ROW, 2, 13)
    assert dispatch.launch_counts() == before
    assert dispatch.KERNELS["paged_rollback"] is PAGED_ROLLBACK
    assert PAGED_ROLLBACK.replaces == \
        "src/repro/kernels/paged_attention/paged_attention.py:184"


def test_cuda_wrapper_refuses_cpu_tensors():
    k, v = _pools()
    with pytest.raises(ValueError, match="CUDA"):
        pool_zero_cuda([(torch.from_numpy(k), torch.from_numpy(v))],
                       ops.token_indices(ROW, P, 2, 5), "token")
