"""The port's layer primitives against the JAX package's on the same numpy
inputs: RMSNorm (fp32, eps 1e-6), RoPE on interleaved pairs at non-zero
positions, SwiGLU, the LM losses and training attention (``_sdpa``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 on both sides; transcendental and reduction order differ (measured
# max |diff|: rmsnorm 9.5e-7 on inputs of scale 3, rope 2.4e-7, swiglu
# 1.2e-7)
ATOL = RTOL = 2e-6


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_rmsnorm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x)))
    got = tl.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
def test_apply_rope_interleaved_matches_jax(rng, rope_pct):
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [37, 38, 39, 40, 41, 1000]], np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    1_000_000.0, rope_pct))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        1_000_000.0, rope_pct).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # pairs are (2i, 2i+1), not rotate-half: position 0 is the identity and
    # a non-zero position mixes neighbouring lanes only
    np.testing.assert_array_equal(got[0, 0], x[0, 0])


def test_swiglu_matches_jax(rng):
    d, ff = 64, 128
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                      ("w_down", (ff, d)))}
    want = np.asarray(jl.swiglu_apply({n: jnp.asarray(a) for n, a in w.items()},
                                      jnp.asarray(x)))
    mod = tl.SwiGLU(d, ff, "cpu")
    with torch.no_grad():
        for n, a in w.items():
            getattr(mod, n).copy_(torch.from_numpy(a))
    got = tl.swiglu_apply(mod, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_rope_freqs_match_jax():
    np.testing.assert_allclose(tl.rope_freqs(128, 1e6).numpy(),
                               np.asarray(jl.rope_freqs(128, 1e6)),
                               rtol=1e-6)


@pytest.mark.parametrize("S", [12, 1024])  # one chunk; two chunks of 512
def test_lm_losses_match_jax(rng, S):
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, S))
    want = float(jl.chunked_lm_loss(jnp.asarray(x), jnp.asarray(head),
                                    jnp.asarray(labels)))
    got = float(tl.chunked_lm_loss(torch.from_numpy(x), torch.from_numpy(head),
                                   torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    logits = x @ head
    np.testing.assert_allclose(
        float(tl.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))),
        float(jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=RTOL)


def test_training_attention_matches_jax(rng):
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    for causal in (True, False):
        want = np.asarray(ja._sdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, 0))
        got = ta._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
