"""The fp32 flash training pair's tensor-core design: the plain model of its
arithmetic (``ref.flash_forward_split_model`` and
``ref.flash_backward_split_model`` with ``terms=3``: every fp32 operand as
three bf16 terms, ``split3_bf16``, and each product as the six term
products above 2^-24 of it, smallest first, fp32 sums by 16-row tile, a
warp pair's even and odd tiles apart, the query heads' dk/dv partials
folded in ascending order) held to the JAX package's custom VJP
(``repro/kernels/flash_attention/blocked.py``: ``_fwd`` and ``jax.vjp`` of
``flash_attention_xla``, run with a small ``block_k`` so that JAX walks
several key blocks) and to the port's plain versions
(``ref.flash_forward_ref``, ``ref.flash_backward_ref``), which the card's
kernels answer to. The same numpy inputs, in fp32, go to each.

Gates, the fp32 ones of ``tests/test_torch_flash_backward.py``, none
loosened: ``out`` and each gradient within ``ATOL`` 1e-5 plus ``REL`` 1e-5
of the reference's largest |value|; ``lse`` within ``ATOL`` absolute. The
gradients against ``jax.vjp`` start from JAX's own residuals (its ``out``
and ``lse``), against the plain version from the model's. Largest errors
measured on this CPU over these cases: ``lse`` 1.9e-6 from JAX and from
the plain version, ``out`` and the gradients at most 0.11 of their gate.

``split3_bf16`` itself: ``hi + mid + lo == x`` exactly, each term a bf16
value, over every significand of one binade scaled across the exponents
the kernels feed in, and a property test (hypothesis; skipped where it is
not installed).

The card cases (``cuda`` fixture; without a CUDA device they skip; no JAX
needed) hold the kernels (``flash_fwd_lse_x3_kernel``,
``flash_bwd_{dkdv,dq}_x3_kernel``) to the plain versions and to the model
at the same gates, at every head dim the kernels are built for, G 1 to
16, ragged lengths, causal and not; two launches bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ref

ATOL = 1e-5
REL = 1e-5
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import blocked
    return jax, jnp, blocked


def _inputs(B, Sq, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Sq, Hkv, D), (B, Sq, Hkv, D), (B, Sq, Hq, D))]


def _close(got, want, what):
    """Within ATOL + REL * max|want|."""
    got, want = got.float(), want.float()
    gate = ATOL + REL * want.abs().max()
    err = (got - want).abs()
    assert bool((err <= gate).all()), (what, float((err - gate).max()))


def _jax_pair(jx, arrays, causal, block_k):
    """JAX's fp32 (out, lse, (dq, dk, dv)) as torch tensors."""
    jax, jnp, blocked = jx
    q, k, v, do = (jnp.asarray(a, jnp.float32) for a in arrays)
    out, lse = blocked._fwd(q, k, v, causal, block_k)
    _, vjp = jax.vjp(lambda a, b, c: blocked.flash_attention_xla(
        a, b, c, causal, block_k), q, k, v)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return as_t(out), as_t(lse), tuple(as_t(g) for g in vjp(do))


def _fp32(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the split


def _check_split3(x: torch.Tensor):
    hi, mid, lo = ref.split3_bf16(x)
    for t in (hi, mid, lo):
        assert t.to(BF16).float().equal(t)
    total = hi.double() + mid.double() + lo.double()
    assert total.equal(x.double())


def test_split3_exact_over_a_binade():
    """Every fp32 significand in [1, 2) (2^23 values), and the same scaled
    across the exponents the kernels feed in (p in (0, 1], scores, ds and
    inputs of either sign): hi + mid + lo == x exactly."""
    x = (1.0 + torch.arange(2 ** 23, dtype=torch.float64) * 2.0 ** -23).float()
    _check_split3(x)
    for e in (-100, -30, -9, -1, 7, 60):
        _check_split3(torch.ldexp(x[::97], torch.tensor(e)) * (-1) ** (e & 1))


def test_split3_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=300, deadline=None)
    @hypothesis.given(st.floats(min_value=2.0 ** -110, max_value=2.0 ** 110,
                                width=32),
                      st.booleans())
    def check(v, negative):
        _check_split3(torch.tensor([-v if negative else v],
                                   dtype=torch.float32))

    check()


def test_x3_order_is_smallest_first():
    """The six term products in the kernels' order: the five smaller ones
    by the size of their terms (mid mid and the pairs with lo, then mid
    with hi), hi hi last; the three dropped (mid lo, lo mid, lo lo) are
    each smaller than every kept one."""
    size = lambda ij: ij[0] + ij[1]  # noqa: E731  (8 bits a term)
    kept = [size(t) for t in ref.X3_ORDER]
    assert kept == sorted(kept, reverse=True) and ref.X3_ORDER[-1] == (0, 0)
    dropped = {(1, 2), (2, 1), (2, 2)}
    assert dropped.isdisjoint(ref.X3_ORDER) and len(set(ref.X3_ORDER)) == 6
    assert min(size(t) for t in dropped) > max(kept)


# ---------------------------------------------------------------------------
# the model against JAX and the plain versions


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_x3_model_matches_jax_and_plain(jx, causal, G, D):
    """B 2, S 128 (eight 16-key tiles of the forward, four walked tiles of
    32 in each pass; JAX walks four key blocks of 32)."""
    B, S, Hkv = 2, 128, 2 if G < 8 else 1
    arrays = _inputs(B, S, G * Hkv, Hkv, D, seed=300 + G + D)
    jout, jlse, jgrads = _jax_pair(jx, arrays, causal, 32)
    q, k, v, do = _fp32(arrays)
    out, lse = ref.flash_forward_split_model(q, k, v, causal, terms=3)
    assert out.dtype == torch.float32 and lse.shape == (B, G * Hkv, S)
    torch.testing.assert_close(lse, jlse, atol=ATOL, rtol=0)
    _close(out, jout, "out vs JAX")
    want_out, want_lse = ref.flash_forward_ref(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=0)
    _close(out, want_out, "out vs plain")
    grads = ref.flash_backward_split_model(q, k, v, jout, jlse, do, causal,
                                           terms=3)
    for name, g, t, w in zip("qkv", grads, (q, k, v), jgrads):
        assert g.dtype == torch.float32 and g.shape == t.shape
        _close(g, w, "d" + name + " vs jax.vjp")
    own = ref.flash_backward_split_model(q, k, v, out, lse, do, causal,
                                         terms=3)
    want = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
    for name, g, w in zip("qkv", own, want):
        _close(g, w, "d" + name + " vs plain")


@pytest.mark.parametrize("S", [37, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_x3_model_on_ragged_lengths(jx, causal, S):
    """Ragged tiles: 37 (a partial tile of each pass) and 100 (whole and
    partial ones, an odd number of 16-row tiles); JAX in one key block
    (its blocks divide S)."""
    arrays = _inputs(1, S, 16, 2, 128, seed=S)
    jout, jlse, jgrads = _jax_pair(jx, arrays, causal, S)
    q, k, v, do = _fp32(arrays)
    out, lse = ref.flash_forward_split_model(q, k, v, causal, terms=3)
    torch.testing.assert_close(lse, jlse, atol=ATOL, rtol=0)
    _close(out, jout, "ragged out")
    grads = ref.flash_backward_split_model(q, k, v, jout, jlse, do, causal,
                                           terms=3)
    for name, g, w in zip("qkv", grads, jgrads):
        _close(g, w, "ragged d" + name)


def test_x3_model_folds_heads_in_order():
    """dk and dv of a KV head are its G query heads' fp32 partials folded
    in ascending order: the same gradients, bit for bit, as the model run
    head by head (G = 1 each) and summed 0, 1, ..., G - 1."""
    B, S, G, D = 1, 48, 4, 16
    q, k, v, do = _fp32(_inputs(B, S, G, 1, D, seed=19))
    out, lse = ref.flash_forward_split_model(q, k, v, terms=3)
    _, dk, dv = ref.flash_backward_split_model(q, k, v, out, lse, do, terms=3)
    fk = fv = None
    for g in range(G):
        sl = slice(g, g + 1)
        _, pk, pv = ref.flash_backward_split_model(
            q[:, :, sl], k, v, out[:, :, sl], lse[:, sl], do[:, :, sl],
            terms=3)
        fk, fv = (pk, pv) if fk is None else (fk + pk, fv + pv)
    assert torch.equal(dk, fk) and torch.equal(dv, fv)


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
    (1, 129, 16, 1, 32, False),    # G 16
    (1, 96, 4, 2, 64, True),
    (1, 65, 32, 32, 96, True),     # phi3-mini-3.8b's
    (1, 200, 4, 1, 112, True),     # zamba2-7b's shared block
    (1, 1000, 16, 2, 128, True),   # ragged past many tiles
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    pytest.param(*shape, id="-".join(map(str, shape)))
    for shape in CARD_SHAPES])
def test_card_x3_kernels_match_plain_and_model(cuda, B, S, Hq, Hkv, D,
                                               causal):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_lse_cuda)
    g = torch.Generator(device=cuda).manual_seed(7 * D + S)
    q, k, v, do = (torch.randn(B, S, H, D, device=cuda, generator=g)
                   for H in (Hq, Hkv, Hkv, Hq))
    dispatch.reset_launches()
    out, lse = flash_attention_fwd_lse_cuda(q, k, v, causal)
    grads = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    counts = dispatch.variant_counts()
    assert counts["flash_attention"]["lse_f32"] == 1
    assert counts["flash_attention_bwd"]["f32"] == 1
    out2, lse2 = flash_attention_fwd_lse_cuda(q, k, v, causal)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    want_out, want_lse = ref.flash_forward_ref(q, k, v, causal)
    _close(out, want_out, "out vs plain")
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=0)
    want = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
    for name, got, w in zip("qkv", grads, want):
        _close(got, w, "d" + name + " vs plain")
    # the model on the CPU, from the same inputs and the kernel's out, lse
    qc, kc, vc, oc, lc, dc = (t.cpu() for t in (q, k, v, out, lse, do))
    m_out, m_lse = ref.flash_forward_split_model(qc, kc, vc, causal, terms=3)
    _close(out.cpu(), m_out, "out vs model")
    torch.testing.assert_close(lc, m_lse, atol=ATOL, rtol=0)
    model = ref.flash_backward_split_model(qc, kc, vc, oc, lc, dc, causal,
                                           terms=3)
    for name, got, w in zip("qkv", grads, model):
        _close(got.cpu(), w, "d" + name + " vs model")
    dispatch.reset_launches()
