"""The port's flash-attention forward against the JAX Pallas kernel
(interpret mode). The same numpy inputs go to both; on CPU tensors the port
runs the kernel's plain version. The CUDA kernel is held to that plain
version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import \
    FLASH_ATTENTION


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 on both sides, sums in different orders (materialized softmax vs the
# Pallas online softmax; measured max |diff| over these cases: 5.4e-7)
ATOL = RTOL = 1e-5


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 8, 4, 2, 16),     # GQA group 2
    (2, 16, 4, 1, 32),    # one kv head
    (1, 32, 8, 2, 16),    # group 4
    (2, 24, 4, 4, 16),    # MHA
])
def test_flash_plain_matches_pallas(B, S, Hq, Hkv, D):
    q, k, v = _qkv(B, S, Hq, Hkv, D)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    assert got.dtype == torch.float32 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_on_a_ragged_length(causal):
    """13 tokens is no multiple of the Pallas block, which asserts
    divisibility; the JAX package's own reference covers the shape."""
    q, k, v = _qkv(2, 13, 4, 2, 16, seed=1)
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_count_no_launch():
    q, k, v = _qkv(1, 8, 4, 2, 16)
    n = FLASH_ATTENTION.launches
    ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert FLASH_ATTENTION.launches == n
