"""The bf16 flash training pair's tensor-core design, on the CPU: the plain
model of its arithmetic (``ref.flash_forward_split_model`` and
``ref.flash_backward_split_model``: bf16 operands as they are, the
forward's P split into three bf16 terms and the backward's P and dS into
two, fp32 sums by key or query tile, the query heads' dk/dv partials
folded in ascending order) held to the JAX package's
custom VJP (``repro/kernels/flash_attention/blocked.py``: ``_fwd`` and
``jax.vjp`` of ``flash_attention_xla``, run with a small ``block_k`` so that
JAX walks several key blocks) and to the port's plain versions
(``ref.flash_forward_ref``, ``ref.flash_backward_ref``), which the card's
kernels answer to. The same numpy inputs, rounded to bf16, go to each.

Gates, the bf16 ones of ``tests/test_torch_flash_backward.py``, none
loosened: ``out`` and each gradient within ``ATOL`` 1e-5 plus ``REL`` 1e-5
of the reference's largest |value| plus one bf16 ulp (at the larger
magnitude); ``lse`` within ``ATOL`` absolute. The gradients against
``jax.vjp`` start from JAX's own residuals (its rounded ``out`` and its
``lse``), as that file explains; against the plain version, from the
model's. Largest values measured on this CPU over these cases: ``lse``
9.5e-7 from JAX and 4.8e-7 from the plain version; ``out`` and the
gradients at most 0.998 of their gate (a one-ulp flip of the rounding);
on the same bf16 values held in fp32, so unrounded, the model's ``out``
lies within 6.7e-7 of the plain version's largest |value| (P in three
terms) and its gradients within 7.3e-6 (the backward's split leaves
2^-16 of each p and ds).

``split_bf16`` itself: ``|x - hi - lo| <= 2^-16 |x|`` for every fp32 ``x``
in the normal range, a property test (hypothesis; skipped where it is not
installed) and an exhaustive sweep of the significands of one binade.
"""
import numpy as np
import pytest
import torch

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


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _close(got, want, what, rel=REL):
    """Within ATOL + rel * max|want| + one bf16 ulp."""
    got, want = got.float(), want.float()
    ulp = bf16_ulp(torch.maximum(got.abs(), want.abs()))
    gate = ATOL + rel * want.abs().max() + ulp
    err = (got - want).abs()
    assert bool((err <= gate).all()), (what, float((err - gate).max()))


def _jax_pair(jx, arrays, causal, block_k):
    """JAX's bf16 (out, lse, (dq, dk, dv)) as torch fp32 tensors."""
    jax, jnp, blocked = jx
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    out, lse = blocked._fwd(q, k, v, causal, block_k)
    _, vjp = jax.vjp(lambda a, b, c: blocked.flash_attention_xla(
        a, b, c, causal, block_k), q, k, v)
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32)))
    return as_t(out), as_t(lse), tuple(as_t(g) for g in vjp(do))


def _bf16(arrays):
    return [torch.from_numpy(a).to(BF16) for a in arrays]


# ---------------------------------------------------------------------------
# the split


def _split_error(x: torch.Tensor) -> torch.Tensor:
    hi, lo = ref.split_bf16(x)
    return ((x.double() - hi.double() - lo.double()).abs()
            / x.double().abs())


def test_split_within_2_16_over_a_binade():
    """Every fp32 significand in [1, 2) (2^23 values), and the same scaled
    across the exponents the kernels feed in (p in (0, 1], ds of either
    sign): the split reproduces x to 2^-16 relative."""
    x = 1.0 + torch.arange(2 ** 23, dtype=torch.float64) * 2.0 ** -23
    x = x.float()
    assert float(_split_error(x).max()) <= 2.0 ** -16
    for e in (-100, -30, -9, -1, 7, 60):
        y = torch.ldexp(x[::97], torch.tensor(e)) * (-1) ** (e & 1)
        assert float(_split_error(y).max()) <= 2.0 ** -16


def test_split_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=300, deadline=None)
    @hypothesis.given(st.floats(min_value=2.0 ** -110, max_value=2.0 ** 110,
                                width=32),
                      st.booleans())
    def check(v, negative):
        x = torch.tensor([-v if negative else v], dtype=torch.float32)
        hi, lo = ref.split_bf16(x)
        assert hi.to(BF16).float().equal(hi) and lo.to(BF16).float().equal(lo)
        assert float(_split_error(x)) <= 2.0 ** -16

    check()


# ---------------------------------------------------------------------------
# the model against JAX and the plain versions


@pytest.mark.parametrize("D", [16, 80, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_split_model_matches_jax_and_plain(jx, causal, G, D):
    """B 2, S 128 (two forward key tiles, two dq key tiles, four dk/dv
    query tiles; JAX walks four key blocks of 32)."""
    B, S, Hkv = 2, 128, 2 if G < 8 else 1
    arrays = _inputs(B, S, G * Hkv, Hkv, D, seed=100 + G + D)
    jout, jlse, jgrads = _jax_pair(jx, arrays, causal, 32)
    q, k, v, do = _bf16(arrays)
    out, lse = ref.flash_forward_split_model(q, k, v, causal)
    assert out.dtype == BF16 and lse.dtype == torch.float32
    assert lse.shape == (B, G * Hkv, S)
    torch.testing.assert_close(lse, jlse, atol=ATOL, rtol=0)
    _close(out, jout, "out vs JAX", rel=0.0)
    want_out, want_lse = ref.flash_forward_ref(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=0)
    _close(out, want_out, "out vs plain")
    grads = ref.flash_backward_split_model(q, k, v, jout.to(BF16), jlse, do,
                                           causal)
    for name, g, t, w in zip("qkv", grads, (q, k, v), jgrads):
        assert g.dtype == BF16 and g.shape == t.shape
        _close(g, w, "d" + name + " vs jax.vjp")
    own = ref.flash_backward_split_model(q, k, v, out, lse, do, causal)
    want = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
    for name, g, w in zip("qkv", own, want):
        _close(g, w, "d" + name + " vs plain")


@pytest.mark.parametrize("S", [37, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_split_model_on_ragged_lengths(jx, causal, S):
    """Ragged tiles: 37 (one partial tile of each pass) and 100 (a whole
    and a partial one); JAX in one key block (its blocks divide S)."""
    arrays = _inputs(1, S, 8, 2, 32, seed=S)
    jout, jlse, jgrads = _jax_pair(jx, arrays, causal, 512)
    q, k, v, do = _bf16(arrays)
    out, lse = ref.flash_forward_split_model(q, k, v, causal)
    torch.testing.assert_close(lse, jlse, atol=ATOL, rtol=0)
    _close(out, jout, "ragged out", rel=0.0)
    grads = ref.flash_backward_split_model(q, k, v, jout.to(BF16), jlse, do,
                                           causal)
    for name, g, w in zip("qkv", grads, jgrads):
        _close(g, w, "ragged d" + name)


def test_split_model_folds_heads_in_order():
    """dk and dv of a KV head are its G query heads' partials folded in
    ascending order: the same gradients as the model run head by head
    (G = 1 each) and summed 0, 1, ..., G - 1 in fp32."""
    B, S, G, D = 1, 48, 4, 16
    q, k, v, do = _bf16(_inputs(B, S, G, 1, D, seed=9))
    out, lse = ref.flash_forward_split_model(q, k, v)
    _, dk, dv = ref.flash_backward_split_model(q, k, v, out, lse, do)
    parts = []
    for g in range(G):
        sl = slice(g, g + 1)
        parts.append(_head_partials(q[:, :, sl], k, v, out[:, :, sl],
                                    lse[:, sl], do[:, :, sl]))
    fk, fv = parts[0]
    for pk, pv in parts[1:]:
        fk, fv = fk + pk, fv + pv
    assert torch.equal(dk, fk.to(BF16)) and torch.equal(dv, fv.to(BF16))


def _head_partials(q, k, v, out, lse, do):
    """One query head's fp32 dk and dv partials, from the model's own
    arithmetic (its G = 1 case keeps them unrounded through fp32 inputs
    that are bf16 values)."""
    grads = ref.flash_backward_split_model(q.float(), k.float(), v.float(),
                                           out.float(), lse, do.float())
    return grads[1], grads[2]
