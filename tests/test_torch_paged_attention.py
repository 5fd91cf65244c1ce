"""The port's paged-attention and page-reset kernels against the JAX Pallas
kernels (interpret mode, as the JAX package's own tests run them on the
CPU). The same numpy inputs go to both; on CPU tensors the port runs each
kernel's plain version. The CUDA kernels themselves are held to those plain
versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import (
    paged_attention_pallas, paged_reset_pallas)
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.kernels.paged_attention.paged_attention import (
    PAGED_ATTENTION, PAGED_RESET, paged_attention_cuda)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 on both sides; the plain version's materialized softmax and the
# Pallas online softmax sum in different orders (measured max |diff| over
# the five cases: 4.8e-7), so the bound is fp32 rounding with headroom
ATOL = RTOL = 1e-5


def _paged_inputs(B, C, Hq, Hkv, D, N, P, nP, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N, P, Hkv, D)).astype(np.float32)
    tables = np.stack([rng.permutation(N)[:nP] for _ in range(B)]
                      ).astype(np.int32)
    return q, kp, vp, tables


# the five shape cases of tests/test_serving.py
CASES = [
    (3, 4, 4, 2, 16, 12, 8, 3, [5, 0, 17]),    # GQA
    (2, 1, 4, 4, 32, 8, 16, 2, [9, 30]),       # decode shape, MHA
    (1, 8, 8, 2, 16, 6, 8, 4, [13]),           # chunk, GQA group 4
    (3, 4, 4, 2, 16, 12, 8, 3, [-1, 3, 8]),    # row 0 fully masked (inactive)
    (2, 4, 2, 1, 16, 5, 4, 4, [15, 15]),       # slot completely full
]


@pytest.mark.parametrize("B,C,Hq,Hkv,D,N,P,nP,q_start", CASES)
def test_paged_attention_plain_matches_pallas(B, C, Hq, Hkv, D, N, P, nP,
                                              q_start):
    q, kp, vp, tables = _paged_inputs(B, C, Hq, Hkv, D, N, P, nP)
    qs = np.asarray(q_start, np.int32)
    want = np.asarray(paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(qs), interpret=True))
    got = ops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(tables),
                              torch.from_numpy(qs))
    assert got.dtype == torch.float32 and got.shape == (B, C, Hq, D)
    got = got.numpy()
    assert np.isfinite(got).all()  # the inactive row too: finite NEG_INF
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_paged_reset_plain_matches_pallas_bit_equal():
    """Zeroing is exact: bit-equal to the Pallas kernel, duplicate ids are
    idempotent, and pages outside the row keep every bit."""
    L, N, P, H, D = 2, 6, 4, 2, 8
    base = np.arange(L * N * P * H * D, dtype=np.float32).reshape(
        L, N, P, H, D) + 1
    row = np.array([3, 1, 3], np.int32)  # duplicate on purpose
    kj, vj = paged_reset_pallas(jnp.asarray(base), jnp.asarray(base * 2),
                                jnp.asarray(row), interpret=True)
    kt, vt = torch.from_numpy(base.copy()), torch.from_numpy(base * 2)
    ops.paged_reset(kt, vt, torch.from_numpy(row))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    out = kt.numpy()
    assert (out[:, [3, 1]] == 0).all()
    keep = [i for i in range(N) if i not in (1, 3)]
    np.testing.assert_array_equal(out[:, keep], base[:, keep])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, kp, vp, tables = _paged_inputs(2, 1, 4, 2, 16, 8, 4, 2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables)]
    qs = torch.tensor([3, 5], dtype=torch.int32)
    before = (PAGED_ATTENTION.launches, PAGED_RESET.launches)
    np.testing.assert_array_equal(ops.paged_attention(*args, qs).numpy(),
                                  ref.paged_attention_ref(*args, qs).numpy())
    pools = torch.ones(2, 8, 4, 2, 16)
    ops.paged_reset(pools, pools.clone(), torch.tensor([1], dtype=torch.int32))
    assert (PAGED_ATTENTION.launches, PAGED_RESET.launches) == before
    assert {"paged_attention", "paged_reset"} <= set(dispatch.KERNELS)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, kp, vp, tables = _paged_inputs(1, 1, 2, 1, 64, 4, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*(torch.from_numpy(a) for a in (q, kp, vp, tables)),
                             torch.zeros(1, dtype=torch.int32))


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="all be on cuda or all on cpu"):
        dispatch.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
