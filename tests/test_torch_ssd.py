"""The Mamba-2 SSD scan and the Mamba-2 block: the port's plain versions
against the JAX package on the same numpy inputs.

The scan: the port's masked chunked form (the CUDA kernel's plain version,
``kernels/mamba2/ref.ssd_chunked_ref``) and its sequential recurrence
against JAX's ``ssd_pallas`` in interpret mode (as the JAX package's own
CPU tests run it) and ``ssd_sequential``, with an incoming state, at
several lengths and a ragged one (the chunked form then runs the
recurrence, as JAX's does). Tolerance: the JAX package's own for its
kernel against the recurrence, 5e-5 (``tests/test_kernels.py:164-180``).

The block: ``mamba2_apply`` without a state (training), and from a state
with a multi-token step (the scan) and a decode step (plain torch), the
state (``h`` and the causal conv's window) written in place; and
``_causal_conv`` with and without its state, all against JAX's on weights
carried across through numpy. fp32 in both packages, products in other
orders: within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.mamba2 import ref as jref
from repro.kernels.mamba2.mamba2 import ssd_pallas
from repro.models import mamba2 as jmamba2
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2 import ops, ref
from repro_torch.kernels.mamba2.mamba2 import ssd_cuda
from repro_torch.models import mamba2

SSD_ATOL = 5e-5
BLOCK_ATOL = BLOCK_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, nh, P, N, seed=0):
    """The JAX package's test distribution: x ~ 0.5 N(0, 1), dt a softplus
    of N(0, 1), log decay -0.5 |N(0, 1)|, B and C ~ 0.5 N(0, 1), an incoming
    state ~ 0.1 N(0, 1)."""
    g = np.random.default_rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)
    xh = n(B, S, nh, P) * 0.5
    dt = np.log1p(np.exp(n(B, S, nh))).astype(np.float32)
    la = (-np.abs(n(B, S, nh)) * 0.5).astype(np.float32)
    return xh, dt, la, n(B, S, N) * 0.5, n(B, S, N) * 0.5, \
        n(B, nh, P, N) * 0.1


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _close(got, want, atol=SSD_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("B,S,nh,P,N,chunk", [
    (1, 64, 2, 8, 8, 16), (2, 64, 3, 16, 16, 32), (1, 32, 2, 64, 64, 16),
    (2, 48, 2, 16, 64, 16),
])
def test_plain_versions_match_pallas_and_sequential(B, S, nh, P, N, chunk):
    xs = _inputs(B, S, nh, P, N)
    y_pal, h_pal = ssd_pallas(*map(jnp.asarray, xs), chunk=chunk,
                              interpret=True)
    y_seq, h_seq = jref.ssd_sequential(*map(jnp.asarray, xs))
    y_chk, h_chk = ref.ssd_chunked_ref(*_t(*xs), chunk=chunk)
    y_ps, h_ps = ref.ssd_sequential(*_t(*xs))
    for got, want in ((y_chk, y_pal), (h_chk, h_pal), (y_chk, y_seq),
                      (h_chk, h_seq), (y_ps, y_seq), (h_ps, h_seq)):
        _close(got, want)


@pytest.mark.parametrize("S", [23, 1, 3])
def test_ragged_lengths_run_the_recurrence(S):
    """No chunk divides S: the plain version runs the recurrence, as the
    JAX package's jnp form does; the card's kernel takes any S itself."""
    xs = _inputs(2, S, 3, 16, 16, seed=S)
    y_seq, h_seq = jref.ssd_sequential(*map(jnp.asarray, xs))
    y_jc, _ = jref.ssd_chunked_jnp(*map(jnp.asarray, xs), chunk=64)
    y, h = ops.ssd_chunked(*_t(*xs), chunk=64)
    _close(y, y_seq)
    _close(h, h_seq)
    _close(y, y_jc)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    xs = _t(*_inputs(2, 32, 2, 16, 16, seed=3))
    before = dispatch.launch_counts()
    y, h = ops.ssd_chunked(*xs, chunk=16)
    want_y, want_h = ref.ssd_chunked_ref(*xs, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert dispatch.launch_counts() == before
    assert dispatch.KERNELS["ssd"].replaces == \
        "src/repro/kernels/mamba2/mamba2.py:67"
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(*xs)


# --------------------------------------------------------------- the block

ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def block():
    """(JAX config, JAX weights, port config, port weights): one
    ``mamba2_init`` with dt_bias, D and the conv bias redrawn, carried
    across."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray,
                        jmamba2.mamba2_init(jax.random.PRNGKey(0), jcfg))
    g = np.random.default_rng(1)
    for name in ("dt_bias", "D", "conv_b"):
        tree[name] = (g.standard_normal(tree[name].shape) * 0.5
                      ).astype(np.float32)
    mod = mamba2.Mamba2(cfg, "cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.tensor(tree[name]))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, mod


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _state(cfg, B, seed):
    _, nh, P, N, conv_dim = mamba2.dims(cfg)
    g = np.random.default_rng(seed)
    return {"h": (g.standard_normal((B, nh, P, N)) * 0.1).astype(np.float32),
            "conv": g.standard_normal((B, cfg.mamba_conv - 1, conv_dim)
                                      ).astype(np.float32)}


def _bclose(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_mamba2_apply_without_state_matches_jax(block):
    jcfg, jp, cfg, mod = block
    x = _x(2, 8, cfg.d_model, 4)
    want, _ = jmamba2.mamba2_apply(jp, jnp.asarray(x), jcfg, None)
    with torch.no_grad():
        got = mamba2.mamba2_apply(mod, torch.as_tensor(x), cfg, None)
    _bclose(got, want)


@pytest.mark.parametrize("S", [7, 1])
def test_mamba2_apply_from_a_state_matches_jax_and_updates_it(block, S):
    """S = 7 runs the scan (a ragged length: the recurrence on the CPU),
    S = 1 the decode recurrence; h and the conv window are written in
    place and equal JAX's new state."""
    jcfg, jp, cfg, mod = block
    x, st = _x(2, S, cfg.d_model, 5), _state(cfg, 2, 6)
    want, jst = jmamba2.mamba2_apply(jp, jnp.asarray(x), jcfg,
                                     jax.tree.map(jnp.asarray, st))
    tst = {k: torch.tensor(v) for k, v in st.items()}
    with torch.no_grad():
        got = mamba2.mamba2_apply(mod, torch.as_tensor(x), cfg, tst)
    _bclose(got, want)
    _bclose(tst["h"], jst["h"])
    _bclose(tst["conv"], jst["conv"])


@pytest.mark.parametrize("stateful", [False, True])
def test_causal_conv_and_its_state_match_jax(block, stateful):
    jcfg, jp, cfg, mod = block
    conv_dim = mamba2.dims(cfg)[4]
    x = _x(2, 5, conv_dim, 7)
    st = _state(cfg, 2, 8)["conv"] if stateful else None
    want, jnew = jmamba2._causal_conv(jnp.asarray(x), jp["conv_w"],
                                      jp["conv_b"],
                                      None if st is None else jnp.asarray(st))
    got, new = mamba2._causal_conv(torch.as_tensor(x), mod.conv_w,
                                   mod.conv_b,
                                   None if st is None else torch.tensor(st))
    _bclose(got, want)
    _bclose(new, jnew)
