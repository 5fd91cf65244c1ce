"""The RWKV-6 WKV scan and the RWKV-6 block: the port's plain versions
against the JAX package on the same numpy inputs.

The scan: the port's masked chunked form (what the CUDA kernel's plain
version is, ``kernels/rwkv6/ref.wkv_chunked_ref``) and its sequential
recurrence against JAX's ``wkv_pallas`` in interpret mode (as the JAX
package's own CPU tests run it) and ``wkv_sequential``, with an incoming
state, at several lengths and a ragged one (the chunked form then runs the
recurrence, as JAX's does). Tolerances are the JAX package's own for its
kernel against the recurrence (``tests/test_kernels.py:66-96``): 2e-5, and
1e-4 under strong decay (w = 0.05).

The block: ``time_mix`` (no state; a multi-token step and a decode step
from a state, the state written in place) and ``channel_mix`` against
JAX's, the weights carried across through numpy, with u and the decay base
drawn at random so that the bonus term and the decay are not trivial. Both
packages compute in fp32 with products in other orders: the outputs
(|y| up to about 2) agree within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.rwkv6 import ref as jref
from repro.kernels.rwkv6.rwkv6 import wkv_pallas
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.rwkv6 import ops, ref
from repro_torch.kernels.rwkv6.rwkv6 import wkv_cuda
from repro_torch.models import rwkv6

WKV_ATOL = 2e-5
STRONG_ATOL = 1e-4
BLOCK_ATOL = BLOCK_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, N, seed=0, w=None):
    """The JAX package's test distribution: r, k, v ~ 0.5 N(0, 1), decay in
    (0.45, 0.95), u ~ 0.3 N(0, 1), an incoming state ~ 0.1 N(0, 1)."""
    g = np.random.default_rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)
    r, k, v = n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5
    if w is None:
        w = (1 / (1 + np.exp(-n(B, S, H, N)))) * 0.5 + 0.45
    else:
        w = np.full((B, S, H, N), w, np.float32)
    return r, k, v, w.astype(np.float32), n(H, N) * 0.3, n(B, H, N, N) * 0.1


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 32, 2, 8, 16), (2, 64, 3, 16, 16), (2, 32, 2, 64, 32),
    (1, 48, 2, 16, 16),
])
def test_plain_versions_match_pallas_and_sequential(B, S, H, N, chunk):
    xs = _inputs(B, S, H, N)
    o_pal, s_pal = wkv_pallas(*map(jnp.asarray, xs), chunk=chunk,
                              interpret=True)
    o_seq, s_seq = jref.wkv_sequential(*map(jnp.asarray, xs))
    o_chk, s_chk = ref.wkv_chunked_ref(*_t(*xs), chunk=chunk)
    o_ps, s_ps = ref.wkv_sequential(*_t(*xs))
    for got, want in ((o_chk, o_pal), (s_chk, s_pal), (o_chk, o_seq),
                      (s_chk, s_seq), (o_ps, o_seq), (s_ps, s_seq)):
        _close(got, want, WKV_ATOL)


@pytest.mark.parametrize("S", [23, 1, 5])
def test_ragged_lengths_run_the_recurrence(S):
    """No chunk divides S: the plain version runs the recurrence, as the
    JAX package's jnp forms do; the card's kernel takes any S itself."""
    xs = _inputs(2, S, 2, 16, seed=S)
    o_seq, s_seq = jref.wkv_sequential(*map(jnp.asarray, xs))
    o_jc, _ = jref.wkv_chunked_jnp(*map(jnp.asarray, xs), chunk=32)
    o, st = ops.wkv_chunked(*_t(*xs), chunk=32)
    _close(o, o_seq, WKV_ATOL)
    _close(st, s_seq, WKV_ATOL)
    _close(o, o_jc, WKV_ATOL)


def test_strong_decay_stays_finite_and_matches():
    """w = 0.05 (log-decay -3.0 a step, -48 over a chunk of 16): every
    ratio in the chunked form stays <= 1, so nothing overflows, with no
    clamp on the decay (the TPU kernel has none)."""
    xs = _inputs(1, 64, 1, 8, seed=7, w=0.05)
    xs = (xs[0] * 2, xs[1] * 2, xs[2] * 2, xs[3], xs[4] * 0,
          xs[5] * 0)
    o_seq, _ = jref.wkv_sequential(*map(jnp.asarray, xs))
    o_pal, _ = wkv_pallas(*map(jnp.asarray, xs), chunk=16, interpret=True)
    o, _ = ref.wkv_chunked_ref(*_t(*xs), chunk=16)
    assert torch.isfinite(o).all()
    _close(o, o_seq, STRONG_ATOL)
    _close(o, o_pal, STRONG_ATOL)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    xs = _t(*_inputs(2, 32, 2, 16, seed=3))
    before = dispatch.launch_counts()
    o, st = ops.wkv_chunked(*xs, chunk=16)
    want_o, want_st = ref.wkv_chunked_ref(*xs, chunk=16)
    assert torch.equal(o, want_o) and torch.equal(st, want_st)
    assert dispatch.launch_counts() == before
    assert dispatch.KERNELS["wkv"].replaces == \
        "src/repro/kernels/rwkv6/rwkv6.py:70"
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv_cuda(*xs)


# --------------------------------------------------------------- the block

ARCH = "rwkv6-7b"


@pytest.fixture(scope="module")
def block():
    """(JAX config, JAX weights, port config, port weights): one
    ``rwkv6_init`` with u and w_base redrawn, carried across."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray,
                        jrwkv6.rwkv6_init(jax.random.PRNGKey(0), jcfg))
    g = np.random.default_rng(1)
    tree["u_bonus"] = (g.standard_normal(tree["u_bonus"].shape) * 0.3
                       ).astype(np.float32)
    tree["w_base"] = (g.standard_normal(tree["w_base"].shape) * 0.5 - 0.6
                      ).astype(np.float32)
    mix = rwkv6.RWKV6Mix(cfg, "cpu")
    with torch.no_grad():
        for name, p in mix.named_parameters():
            p.copy_(torch.tensor(tree[name]))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, mix


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _state(B, H, N, D, seed):
    g = np.random.default_rng(seed)
    return {"S": (g.standard_normal((B, H, N, N)) * 0.1).astype(np.float32),
            "x_prev": g.standard_normal((B, D)).astype(np.float32),
            "x_prev_cm": g.standard_normal((B, D)).astype(np.float32)}


def _bclose(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_time_mix_without_state_matches_jax(block):
    jcfg, jp, cfg, mix = block
    x = _x(2, 8, cfg.d_model, 4)
    want, _ = jrwkv6.time_mix(jp, jnp.asarray(x), jcfg, None)
    with torch.no_grad():
        got = rwkv6.time_mix(mix, torch.as_tensor(x), cfg, None)
    _bclose(got, want)


@pytest.mark.parametrize("S", [6, 1])
def test_time_mix_from_a_state_matches_jax_and_updates_it(block, S):
    """S = 6 runs the scan (the chunked form: min(32, 6) divides 6), S = 1
    the decode recurrence; the state is written in place."""
    jcfg, jp, cfg, mix = block
    B, D, H, N = 2, cfg.d_model, cfg.n_heads, cfg.rwkv_head_size
    x, st = _x(B, S, D, 5), _state(B, H, N, D, 6)
    want, jst = jrwkv6.time_mix(jp, jnp.asarray(x), jcfg,
                                {k: jnp.asarray(st[k]) for k in ("S",
                                                                 "x_prev")})
    tst = {k: torch.as_tensor(st[k]).clone() for k in ("S", "x_prev")}
    with torch.no_grad():
        got = rwkv6.time_mix(mix, torch.as_tensor(x), cfg, tst)
    _bclose(got, want)
    _bclose(tst["S"], jst["S"])
    _bclose(tst["x_prev"], jst["x_prev"])


@pytest.mark.parametrize("stateful", [False, True])
def test_channel_mix_matches_jax(block, stateful):
    jcfg, jp, cfg, mix = block
    x = _x(2, 5, cfg.d_model, 7)
    st = _state(2, cfg.n_heads, cfg.rwkv_head_size, cfg.d_model, 8) \
        if stateful else None
    want, jst = jrwkv6.channel_mix(
        jp, jnp.asarray(x),
        {"x_prev_cm": jnp.asarray(st["x_prev_cm"])} if stateful else None)
    tst = {"x_prev_cm": torch.as_tensor(st["x_prev_cm"]).clone()} \
        if stateful else None
    with torch.no_grad():
        got = rwkv6.channel_mix(mix, torch.as_tensor(x), tst)
    _bclose(got, want)
    if stateful:
        _bclose(tst["x_prev_cm"], jst["x_prev_cm"])
