"""Flash attention's training pair against the JAX package's custom VJP
(``repro/kernels/flash_attention/blocked.py``: ``_fwd`` and ``_bwd_vjp``
of ``flash_attention_xla``), run with a small ``block_k`` so that JAX walks
several key blocks. The same numpy inputs go to both packages.

* The plain versions ``ref.flash_forward_ref`` (out, lse) and
  ``ref.flash_backward_ref`` (dq, dk, dv) against ``_fwd`` and
  ``jax.vjp``: causal and not, G 1, 4 and 8 query heads a KV head, d_head
  16 and 80, fp32 and bf16; a ragged length (one key block, the whole of
  it, since JAX's blocks must divide the sequence).
* ``ops.FlashAttention`` on CPU tensors against torch autograd of the
  training path's plain attention, ``models.attention._sdpa``; no launch
  counted; ``flash_attention`` goes through it only when a gradient is
  needed.

Tolerances, each with the largest value measured on this CPU over these
cases. fp32: the two packages sum in other orders (JAX's blocked scan,
the repeated heads folded last; the materialized scores here, the group
summed inside one einsum), so ``out`` within ``ATOL`` 1e-5 (measured
1.4e-6), ``lse`` within ``ATOL`` (9.5e-7), and each gradient within
``GRAD_REL`` 1e-5 of its largest |value| (measured 1.0e-6). bf16: both
compute in fp32 from the same bf16 inputs and round each result once, so
``out`` and each gradient lie within one bf16 ulp (at the larger
magnitude) past the fp32 gate (measured: 0.995 ulp). The bf16 backward is
held to ``jax.vjp`` from JAX's own residuals: ``delta`` reads the rounded
``out``, and where the two packages' fp32 ``out`` straddle a bf16
rounding boundary (one ulp apart), every gradient moves by more than an
ulp. Against ``_sdpa``'s autograd, fp32: ``GRAD_REL``.

The card cases (``cuda`` fixture; without a CUDA device they skip) hold
the kernels to these plain versions: the lse forward and the backward at
every head dim the kernels are built for, ragged lengths, causal and not,
in bf16 also at S 4096 and at 2 x 2048 with 4 query heads a KV head (both
pairs run on the tensor cores: HMMA in their SASS, none in the fp32
serving forward's),
fp32 within ``ATOL`` plus ``KERNEL_REL`` 1e-5 of each gradient's largest
|value| (fp32 sums in other orders: the kernel's tiles against one einsum;
the absolute floor for a gradient that is 0 up to rounding, as dq of a
one-token sequence, where dp - delta cancels to 4e-7 on an H100 80GB
HBM3 at 700 W) and
bf16 within one ulp past it; two launches bit-equal; one launch a call of
each, counted by variant.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models.attention import _sdpa

ATOL = 1e-5
GRAD_REL = 1e-5
KERNEL_REL = 1e-5
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """JAX's blocked custom VJP (imported here, so the card cases run
    where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import blocked
    return jax, jnp, blocked


def _inputs(B, Sq, Hq, Hkv, D, seed=0):
    """q, k, v, dout as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Sq, Hkv, D), (B, Sq, Hkv, D), (B, Sq, Hq, D))]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _close(got, want, dtype, rel, what, atol=0.0):
    """fp32: within ``atol`` plus ``rel`` of ``want``'s largest |value|;
    bf16: within one bf16 ulp past that."""
    got, want = got.float(), want.float()
    gate = atol + rel * want.abs().max()
    if dtype == BF16:
        gate = gate + bf16_ulp(torch.maximum(got.abs(), want.abs()))
    err = (got - want).abs()
    assert bool((err <= gate).all()), (what, float((err - gate).max()))


def _jax_pair(jx, arrays, causal, block_k, dtype):
    """JAX's (out, lse, (dq, dk, dv)) as torch fp32 tensors."""
    jax, jnp, blocked = jx
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32
    q, k, v, do = (jnp.asarray(a, jd) for a in arrays)
    out, lse = blocked._fwd(q, k, v, causal, block_k)
    _, vjp = jax.vjp(lambda a, b, c: blocked.flash_attention_xla(
        a, b, c, causal, block_k), q, k, v)
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32)))
    return as_t(out), as_t(lse), tuple(as_t(g) for g in vjp(do))


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 80])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_pair_matches_jax_vjp(jx, causal, G, D, dtype):
    B, S, Hkv = 2, 64, 2 if G < 8 else 1
    arrays = _inputs(B, S, G * Hkv, Hkv, D, seed=G + D)
    jout, jlse, jgrads = _jax_pair(jx, arrays, causal, 16, dtype)
    q, k, v, do = _port(arrays, dtype)
    out, lse = ref.flash_forward_ref(q, k, v, causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (B, G * Hkv, S)
    torch.testing.assert_close(lse, jlse, atol=ATOL, rtol=0)
    _close(out, jout, dtype, 0.0, "out", atol=ATOL)
    # the backward from JAX's residuals: in bf16 a one-ulp flip of the
    # rounded out (above) moves delta, and with it every gradient, by more
    # than an ulp; in fp32 the port's own residuals too
    grads = ref.flash_backward_ref(q, k, v, jout.to(dtype), jlse, do, causal)
    for name, g, t, w in zip("qkv", grads, (q, k, v), jgrads):
        assert g.dtype == dtype and g.shape == t.shape
        _close(g, w, dtype, GRAD_REL, "d" + name)
    if dtype == torch.float32:
        own = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
        for name, g, w in zip("qkv", own, jgrads):
            _close(g, w, dtype, GRAD_REL, "d" + name + " (own residuals)")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_pair_matches_jax_on_a_ragged_length(jx, causal):
    """37 tokens: one key block in JAX (its blocks must divide S)."""
    arrays = _inputs(1, 37, 8, 2, 16, seed=3)
    jout, jlse, jgrads = _jax_pair(jx, arrays, causal, 512, torch.float32)
    q, k, v, do = _port(arrays, torch.float32)
    out, lse = ref.flash_forward_ref(q, k, v, causal)
    torch.testing.assert_close(out, jout, atol=ATOL, rtol=0)
    torch.testing.assert_close(lse, jlse, atol=ATOL, rtol=0)
    for g, w in zip(ref.flash_backward_ref(q, k, v, out, lse, do, causal),
                    jgrads):
        _close(g, w, torch.float32, GRAD_REL, "ragged")


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_function_on_cpu_matches_sdpa_autograd(causal, G):
    """``FlashAttention`` on CPU tensors (the plain pair) against torch
    autograd of ``_sdpa``: the same output and gradients, no launch."""
    arrays = _inputs(2, 24, 2 * G, 2, 16, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    twins = [t.detach().clone().requires_grad_() for t in leaves]
    dout = torch.from_numpy(arrays[3])
    before = dispatch.launch_counts()
    out = ops.flash_attention(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, dout)
    assert dispatch.launch_counts() == before
    want_out = _sdpa(*twins, causal)
    want = torch.autograd.grad(want_out, twins, dout)
    torch.testing.assert_close(out, want_out, atol=ATOL, rtol=0)
    for g, w in zip(got, want):
        _close(g, w, torch.float32, GRAD_REL, "vs _sdpa")


def test_function_only_when_a_gradient_is_needed():
    """Serving keeps the plain forward: no Function without a gradient to
    reach, and only the inputs that need one get one."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 4, 2, 16))
    assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    out = ops.flash_attention(q, k, v)
    (dq,) = torch.autograd.grad(out, [q], do)
    assert dq.shape == q.shape and bool(dq.abs().max() > 0)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


CARD_SHAPES = [
    (1, 256, 16, 2, 128, True),    # qwen2.5-3b's heads
    (2, 100, 16, 16, 80, False),   # hubert-xlarge's, ragged
    (1, 1, 4, 2, 16, True),        # one token
    (2, 77, 8, 1, 16, True),       # G 8, ragged
    (1, 129, 8, 4, 32, False),
    (1, 96, 4, 2, 64, True),
    (1, 65, 32, 32, 96, True),     # phi3-mini-3.8b's
    (1, 64, 4, 1, 112, True),      # zamba2-7b's shared block
    (1, 1000, 16, 2, 128, True),   # ragged past many tiles
]
# the bf16 pair on the tensor cores, also at qwen2.5-3b's silo (JAX's
# train_4k length) and at 4 query heads a KV head over 2 sequences (many
# dk/dv partials to fold)
CARD_BF16_SHAPES = [
    (1, 4096, 16, 2, 128, True),
    (2, 2048, 32, 8, 128, True),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,dtype", [
    pytest.param(*shape, dtype, id="-".join(map(str, shape)) + "-" + name)
    for shape in CARD_SHAPES
    for dtype, name in ((torch.float32, "fp32"), (BF16, "bf16"))] + [
    pytest.param(*shape, BF16, id="-".join(map(str, shape)) + "-bf16")
    for shape in CARD_BF16_SHAPES])
def test_card_kernels_match_plain(cuda, B, S, Hq, Hkv, D, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(D + S)
    q, k, v, do = (torch.randn(B, S, H, D, device=cuda, generator=g)
                   .to(dtype) for H in (Hq, Hkv, Hkv, Hq))
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_lse_cuda)
    v_name = "bf16" if dtype == BF16 else "f32"
    dispatch.reset_launches()
    out, lse = flash_attention_fwd_lse_cuda(q, k, v, causal)
    grads = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    counts = dispatch.variant_counts()
    assert counts["flash_attention"][f"lse_{v_name}"] == 1
    assert counts["flash_attention_bwd"][v_name] == 1
    assert dispatch.launch_counts()["flash_attention"] == 1
    want_out, want_lse = ref.flash_forward_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want_out, dtype, KERNEL_REL, "out", atol=ATOL)
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=0)
    # the backward from the kernel's own out and lse, as training runs it
    want = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
    for name, got, w in zip("qkv", grads, want):
        assert got.dtype == dtype
        _close(got, w, dtype, KERNEL_REL, "d" + name, atol=ATOL)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    dispatch.reset_launches()


def test_card_function_launches_both_kernels(cuda):
    """Training through ``flash_attention`` on the card: the lse forward
    and the backward once each, and no serving forward."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 48, H, 64, device=cuda, generator=g)
               .requires_grad_() for H in (8, 2, 2))
    dispatch.reset_launches()
    out = ops.flash_attention(q, k, v)
    out.square().sum().backward()
    counts = dispatch.variant_counts()
    assert counts["flash_attention"] == {"f32": 0, "bf16": 0, "lse_f32": 1,
                                         "lse_bf16": 0}
    assert counts["flash_attention_bwd"] == {"f32": 1, "bf16": 0}
    want = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_out = _sdpa(*want, True)
    ref_out.square().sum().backward()
    for t, w in zip((q, k, v), want):
        _close(t.grad, w.grad, torch.float32, KERNEL_REL, "vs _sdpa")
    dispatch.reset_launches()


def test_card_bf16_pair_on_tensor_cores(cuda):
    """Every flash kernel that multiplies, bf16 and fp32 (every
    instantiation), holds HMMA instructions in the built library's SASS
    (``cuobjdump -sass``): the training pair's, and the forwards that the
    serving entries launch too (the lse forwards, with no lse). The CUDA-core
    serving forward (``flash_attention_fwd_kernel``) is gone."""
    import re
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build
    _build.library()
    res = subprocess.run([str(Path(_build.nvcc()).with_name("cuobjdump")),
                          "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    kernels = ("flash_fwd_lse_tc_kernel", "flash_bwd_dkdv_tc_kernel",
               "flash_bwd_dq_tc_kernel", "flash_fwd_lse_x3_kernel",
               "flash_bwd_dkdv_x3_kernel", "flash_bwd_dq_x3_kernel")
    counts: dict = {}
    name = None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            assert "flash_attention_fwd_kernel" not in fn, fn
            name = next((p for p in kernels if re.search(p, fn)), None)
            if name:
                counts.setdefault(name, []).append(0)
        elif name and re.search(r"\bHMMA\b", line):
            counts[name][-1] += 1
    for p in kernels:
        assert counts.get(p), f"{p} not in the library"
        assert min(counts[p]) > 0, (p, counts[p])
    # the forwards, both entries' kernels, at every head dim they take
    for p in ("flash_fwd_lse_tc_kernel", "flash_fwd_lse_x3_kernel"):
        assert len(counts[p]) == len(dispatch.FLASH_HEAD_DIMS), (p, counts[p])
