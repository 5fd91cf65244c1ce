"""The serving flash forward's tensor-core design, on the CPU: the serving
entries (``flash_attention_fwd_{f32,bf16}``) launch the training forward's
kernels without the log-sum-exp store, so the plain model of those
kernels' arithmetic (``ref.flash_forward_split_model``: ``terms=2`` for
bf16, P as three bf16 terms over 64-key tiles; ``terms=3`` for fp32, every
operand as three bf16 terms over 16-key tiles) is the serving forward's
model too. Its ``out`` is held, at the serving shapes, to the JAX
package's serving kernel (``flash_attention_pallas`` in interpret mode,
with 32-row query and key blocks where they divide the sequence, so that
JAX walks several key blocks at S 128, and one block otherwise: its
blocks must divide the sequence) and to the port's plain version
(``ref.attention_ref``), which the card's kernels answer to. The same
numpy inputs from a seed go to each, rounded to bf16 for ``terms=2``.

Shapes: every serving arch's heads and d_head (qwen2.5-3b 16/2 d128,
zamba2-7b 32/32 d112, stablelm-3b 32/32 d80, phi3-mini-3.8b 32/32 d96,
qwen3-moe 64/4 d128, phi3.5-moe 32/8 d128; causal) and hubert-xlarge's
16/16 d80 without the causal mask; Sq 1, 5, 32, 37 and 128 (fewer rows
than a block of either kernel, ragged key tiles, several tiles).

Gates, those of ``tests/test_torch_flash_tensor_core.py`` and
``tests/test_torch_flash_fp32_tensor_core.py``, none loosened: ``out``
within ``ATOL`` 1e-5 plus ``REL`` 1e-5 of the reference's largest |value|,
plus one bf16 ulp (at the larger magnitude) in bf16.

The card cases (``cuda`` fixture; without a CUDA device they skip; no JAX
needed) launch the serving entry at the same kinds of shapes, Sq 1 to 64:
its ``out`` bit-equal to the lse entry's on the same inputs and across two
launches, one count a call on ``f32`` / ``bf16`` and none on the lse
variants, within the plain version's gate (fp32: 1e-5 + 1e-5 |want|
elementwise; bf16: that plus one ulp) and within the model's gate above.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ref

ATOL = 1e-5
REL = 1e-5
RTOL = 1e-5  # the plain version's elementwise gate on the card
BF16 = torch.bfloat16

# name: Hq, Hkv, D, causal
HEADS = {
    "qwen2.5-3b": (16, 2, 128, True),
    "zamba2-7b": (32, 32, 112, True),
    "stablelm-3b": (32, 32, 80, True),
    "phi3-mini-3.8b": (32, 32, 96, True),
    "qwen3-moe": (64, 4, 128, True),
    "phi3.5-moe": (32, 8, 128, True),
    "hubert-xlarge": (16, 16, 80, False),
}
LENGTHS = (1, 5, 32, 37, 128)
JAX_BLOCK = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pallas():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_pallas
    return jnp, flash_attention_pallas


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def past_gate(got, want) -> float:
    """How far ``got`` lies past ATOL + REL * max|want| (plus one bf16 ulp
    where ``got`` is bf16); <= 0 inside."""
    gate = ATOL + REL * want.float().abs().max()
    if got.dtype == BF16:
        gate = gate + bf16_ulp(torch.maximum(got.float().abs(),
                                             want.float().abs()))
    return float(((got.float() - want.float()).abs() - gate).max())


def _jax_serving(pallas, arrays, causal, dtype):
    """JAX's serving kernel in interpret mode, as a torch tensor of
    ``dtype``'s values."""
    jnp, flash_attention_pallas = pallas
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    q, k, v = (jnp.asarray(a, jdt) for a in arrays)
    S = q.shape[1]
    block = JAX_BLOCK if S % JAX_BLOCK == 0 else S
    out = flash_attention_pallas(q, k, v, causal=causal, block_q=block,
                                 block_k=block, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("arch", list(HEADS))
@pytest.mark.parametrize("terms", [2, 3])
def test_serving_model_matches_pallas_and_plain(pallas, terms, arch, S):
    Hq, Hkv, D, causal = HEADS[arch]
    dtype = BF16 if terms == 2 else torch.float32
    arrays = _inputs(1, S, Hq, Hkv, D, seed=10 * S + D + Hkv)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out, _ = ref.flash_forward_split_model(q, k, v, causal, terms=terms)
    assert out.dtype == dtype and out.shape == (1, S, Hq, D)
    assert past_gate(out, _jax_serving(pallas, arrays, causal, dtype)) <= 0
    assert past_gate(out, ref.attention_ref(q, k, v, causal)) <= 0


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


CARD_SHAPES = [  # B, Sq, Hq, Hkv, D, causal
    (4, 1, 16, 2, 128, True),      # qwen2.5-3b's heads, one token
    (4, 5, 16, 2, 128, True),
    (4, 32, 16, 2, 128, True),     # its direct-mode prefill
    (2, 33, 16, 2, 128, True),     # one row past 32
    (4, 32, 32, 32, 112, True),    # zamba2-7b's shared block
    (2, 1, 32, 32, 112, True),
    (2, 5, 32, 32, 112, True),
    (2, 33, 32, 32, 112, True),
    (4, 32, 32, 32, 80, True),     # stablelm-3b
    (4, 32, 32, 32, 96, True),     # phi3-mini-3.8b
    (2, 5, 32, 32, 96, True),
    (4, 32, 32, 8, 128, True),     # phi3.5-moe
    (4, 32, 64, 4, 128, True),     # qwen3-moe (G 16)
    (4, 32, 64, 8, 128, True),     # qwen2-vl
    (4, 64, 16, 16, 80, False),    # hubert-xlarge, non-causal
    (2, 33, 16, 16, 80, False),
    (2, 5, 8, 1, 16, True),        # smoke head dims
    (1, 37, 4, 2, 32, False),
    (1, 1, 8, 8, 64, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,causal", [
    pytest.param(*shape, id="-".join(map(str, shape)))
    for shape in CARD_SHAPES])
def test_card_serving_forward_is_the_lse_kernel(cuda, dtype, B, Sq, Hq, Hkv,
                                                D, causal):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_fwd_lse_cuda)
    g = torch.Generator(device=cuda).manual_seed(5 * D + Sq)
    q, k, v = (torch.randn(B, Sq, H, D, device=cuda, generator=g).to(dtype)
               for H in (Hq, Hkv, Hkv))
    variant = dispatch.DTYPE_VARIANTS[dtype]
    kern = dispatch.KERNELS["flash_attention"]
    dispatch.reset_launches()
    out = flash_attention_cuda(q, k, v, causal)
    assert kern.variants == {"f32": 0, "bf16": 0, "lse_f32": 0,
                             "lse_bf16": 0, variant: 1}
    again = flash_attention_cuda(q, k, v, causal)
    trained, _ = flash_attention_fwd_lse_cuda(q, k, v, causal)
    want = ref.attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, again) and torch.equal(out, trained)
    err = (out.float() - want.float()).abs()
    gate = ATOL + RTOL * want.float().abs()
    if dtype == BF16:
        gate = gate + bf16_ulp(torch.maximum(out.float().abs(),
                                             want.float().abs()))
    assert bool((err <= gate).all()), float((err - gate).max())
    model, _ = ref.flash_forward_split_model(
        q.cpu(), k.cpu(), v.cpu(), causal, terms=2 if dtype == BF16 else 3)
    assert past_gate(out.cpu(), model) <= 0
    dispatch.reset_launches()
