"""The scans' backward: ``kernels/rwkv6/ops.WKV`` and
``kernels/mamba2/ops.SSD`` on CPU tensors (their plain backward,
``ref.wkv_backward_ref`` / ``ref.ssd_backward_ref``, the reverse scans the
CUDA kernels ``wkv_bwd`` / ``ssd_bwd`` compute) against torch autograd of
the plain chunked forward, and against ``jax.vjp`` of the JAX package's
scans, on the same numpy inputs and output cotangents.

JAX's CPU default for the WKV scan is its factored form, which clamps the
log-decay at -3.5 (``repro/kernels/rwkv6/ref.py:27-46``): under strong
decay its ``dw`` is zero where the clamp binds. The port, its CUDA kernels
and JAX's Pallas kernel have no clamp, so the WKV backward is held to
JAX's unclamped forms, ``wkv_chunked(impl="masked")`` and
``impl="sequential"``, never to the factored one. SSD is held to JAX's
``ssd_chunked(impl="jnp")`` and ``impl="sequential"``.

Cases: S 1, S 37 (ragged: every form runs the recurrence), S 80 at chunk
16 (five chunks of the chunked forms), strong decay (w = 0.02 for WKV, la
near -16 for SSD), a nonzero incoming state and final-state cotangent,
and B 2 with 3 heads, so that ``du`` (over b and t) and ``dBc`` / ``dCc``
(over the heads) sum across what the kernels run as separate blocks.

Tolerance: each gradient within ``ATOL_REL`` (2e-5; 1e-4 under strong
decay, the forward kernels' bounds) of the largest |value| of that
gradient in the reference (at least 1), fp32 sums in other orders
(measured below 3e-6 relative). ``gradcheck`` holds both Functions to
finite differences in float64 at a tiny shape.

The CUDA kernels' own order of sums, ``ref.wkv_backward_split_ref`` and
``ref.ssd_backward_split_ref`` (a thread's columns or rows in order, a
warp's lanes by an xor tree, the warps in order), is held to the plain
reverse scans and to ``jax.vjp`` of JAX's unclamped forms at every width
the kernels are built for (N 16, 32, 64; (P, N) (16, 16), (64, 64)), with
the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2 import ops as jssd
from repro.kernels.rwkv6 import ops as jwkv
from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2 import ref as ssd_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref

ATOL_REL = 2e-5
STRONG_ATOL_REL = 1e-4
WKV_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
SSD_NAMES = ("dxh", "ddt", "dla", "dBc", "dCc", "dh0")
# (name, B, S, heads, chunk, strong decay)
CASES = [("S1", 2, 1, 3, 32, False), ("ragged", 2, 37, 3, 32, False),
         ("five_chunks", 2, 80, 3, 16, False),
         ("strong_decay", 2, 40, 3, 8, True)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(g, scale, *s):
    return (g.standard_normal(s) * scale).astype(np.float32)


def wkv_inputs(B, S, H, N, strong, seed=0):
    """r, k, v ~ 0.5 N(0, 1); decay in (0.45, 0.95), or near 0.02 under
    strong decay; u ~ 0.3 N(0, 1); state0 ~ 0.1 N(0, 1); cotangents do ~
    N(0, 1), dstate ~ 0.1 N(0, 1)."""
    g = np.random.default_rng(seed)
    r, k, v = (_normal(g, 0.5, B, S, H, N) for _ in range(3))
    z = _normal(g, 1.0, B, S, H, N)
    w = (0.02 + 0.01 / (1 + np.exp(-z)) if strong
         else 0.5 / (1 + np.exp(-z)) + 0.45).astype(np.float32)
    return (r, k, v, w, _normal(g, 0.3, H, N), _normal(g, 0.1, B, H, N, N),
            _normal(g, 1.0, B, S, H, N), _normal(g, 0.1, B, H, N, N))


def ssd_inputs(B, S, nh, P, N, strong, seed=0):
    """x ~ 0.5 N(0, 1); dt = softplus(N(0, 1)); la = -0.5 |N(0, 1)|, or
    near -16 under strong decay (a_t about 1e-7, zamba2's A_log reaches log
    16); B, C ~ 0.5 N(0, 1); h0 ~ 0.1 N(0, 1); dy ~ N(0, 1), dh ~ 0.1
    N(0, 1)."""
    g = np.random.default_rng(seed)
    x = _normal(g, 0.5, B, S, nh, P)
    dt = np.log1p(np.exp(_normal(g, 1.0, B, S, nh))).astype(np.float32)
    la = (-16.0 + _normal(g, 0.5, B, S, nh)) if strong \
        else -np.abs(_normal(g, 0.5, B, S, nh))
    return (x, dt, la.astype(np.float32), _normal(g, 0.5, B, S, N),
            _normal(g, 0.5, B, S, N), _normal(g, 0.1, B, nh, P, N),
            _normal(g, 1.0, B, S, nh, P), _normal(g, 0.1, B, nh, P, N))


def _close(got, want, names, tol_rel, what):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        tol = tol_rel * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= tol, f"{what} {name}: max |diff| {err} > {tol}"


def _port_grads(fn, inputs, cot, chunk):
    """The Function's gradients of (out . cot_out + state . cot_state)."""
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out, st = fn(*ts, chunk)
    torch.autograd.backward((out, st), tuple(torch.tensor(c) for c in cot))
    return [t.grad.numpy() for t in ts]


def _autograd_grads(fwd, inputs, cot, chunk):
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out, st = fwd(*ts, chunk=chunk)
    return [g.numpy() for g in torch.autograd.grad(
        (out, st), ts, tuple(torch.tensor(c) for c in cot))]


def _jax_grads(fn, inputs, cot, **kw):
    _, vjp = jax.vjp(lambda *a: fn(*a, **kw), *map(jnp.asarray, inputs))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cot)))]


@pytest.mark.parametrize("name,B,S,H,chunk,strong", CASES)
def test_wkv_backward_matches_autograd_and_jax(name, B, S, H, chunk, strong):
    *inp, do, dst = wkv_inputs(B, S, H, 16, strong)
    tol = STRONG_ATOL_REL if strong else ATOL_REL
    before = dispatch.launch_counts()
    got = _port_grads(wkv_ops.WKV.apply, inp, (do, dst), chunk)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    _close(got, _autograd_grads(wkv_ref.wkv_chunked_ref, inp, (do, dst),
                                chunk), WKV_NAMES, tol, f"{name} autograd")
    for impl in ("masked", "sequential"):
        _close(got, _jax_grads(jwkv.wkv_chunked, inp, (do, dst), chunk=chunk,
                               impl=impl), WKV_NAMES, tol, f"{name} {impl}")


@pytest.mark.parametrize("name,B,S,nh,chunk,strong", CASES)
def test_ssd_backward_matches_autograd_and_jax(name, B, S, nh, chunk, strong):
    *inp, dy, dh = ssd_inputs(B, S, nh, 16, 16, strong)
    tol = STRONG_ATOL_REL if strong else ATOL_REL
    before = dispatch.launch_counts()
    got = _port_grads(ssd_ops.SSD.apply, inp, (dy, dh), chunk)
    assert dispatch.launch_counts() == before
    _close(got, _autograd_grads(ssd_ref.ssd_chunked_ref, inp, (dy, dh),
                                chunk), SSD_NAMES, tol, f"{name} autograd")
    for impl in ("jnp", "sequential"):
        _close(got, _jax_grads(jssd.ssd_chunked, inp, (dy, dh), chunk=chunk,
                               impl=impl), SSD_NAMES, tol, f"{name} {impl}")


def test_gradcheck_both_functions_in_float64():
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    B, S, H, N = 2, 5, 2, 3
    w = torch.rand(B, S, H, N, generator=g, dtype=torch.float64) * 0.5 + 0.45
    wkv_args = [n(B, S, H, N), n(B, S, H, N), n(B, S, H, N), w, n(H, N),
                n(B, H, N, N)]
    assert torch.autograd.gradcheck(
        lambda *a: wkv_ops.WKV.apply(*a, 2),
        [a.requires_grad_() for a in wkv_args])
    nh, P, Ns = 2, 3, 4
    ssd_args = [n(B, S, nh, P),
                torch.nn.functional.softplus(n(B, S, nh)),
                -torch.rand(B, S, nh, generator=g, dtype=torch.float64),
                n(B, S, Ns), n(B, S, Ns), n(B, nh, P, Ns)]
    assert torch.autograd.gradcheck(
        lambda *a: ssd_ops.SSD.apply(*a, 2),
        [a.requires_grad_() for a in ssd_args])


def test_only_inputs_that_need_it_get_a_gradient():
    """Training starts the scan from a zero state that needs no gradient:
    the Function returns None for it, and for anything else left out."""
    *inp, do, _ = wkv_inputs(1, 6, 2, 16, False)
    ts = [torch.tensor(a) for a in inp]
    for i in (0, 3):
        ts[i].requires_grad_()
    o, _ = wkv_ops.wkv_chunked(*ts)
    o.backward(torch.tensor(do))
    assert [t.grad is not None for t in ts] == \
        [True, False, False, True, False, False]


def test_serving_keeps_the_direct_call():
    """Without grad mode (serving runs under inference_mode) the scans do
    not build a graph: the outputs need no gradient even from leaves that
    do, so serving's launch counts stay as they were."""
    *inp, _, _ = wkv_inputs(1, 6, 2, 16, False)
    ts = [torch.tensor(a, requires_grad=True) for a in inp]
    with torch.no_grad():
        o, st = wkv_ops.wkv_chunked(*ts)
    assert not o.requires_grad and not st.requires_grad
    *inp, _, _ = ssd_inputs(1, 6, 2, 16, 16, False)
    ts = [torch.tensor(a, requires_grad=True) for a in inp]
    with torch.inference_mode():
        y, h = ssd_ops.ssd_chunked(*ts)
    assert not y.requires_grad and not h.requires_grad


# the split references at every width the kernels are built for: S 1, a
# ragged length, past two of the kernels' 16-token passes, strong decay
SPLIT_CASES = [("S1", 2, 1, 2, 32, False), ("ragged", 2, 37, 2, 32, False),
               ("three_passes", 1, 48, 2, 16, False),
               ("strong_decay", 1, 40, 2, 8, True)]


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("name,B,S,H,chunk,strong", SPLIT_CASES)
def test_wkv_split_ref_matches_plain_and_jax(name, B, S, H, chunk, strong, N):
    *inp, do, dst = wkv_inputs(B, S, H, N, strong, seed=N)
    tol = STRONG_ATOL_REL if strong else ATOL_REL
    ts = [torch.tensor(a) for a in (*inp, do, dst)]
    got = [g.numpy() for g in wkv_ref.wkv_backward_split_ref(*ts)]
    _close(got, [g.numpy() for g in wkv_ref.wkv_backward_ref(*ts)],
           WKV_NAMES, tol, f"{name} N {N} plain")
    _close(got, _jax_grads(jwkv.wkv_chunked, inp, (do, dst), chunk=chunk,
                           impl="masked"), WKV_NAMES, tol, f"{name} N {N} jax")


@pytest.mark.parametrize("P,N", [(16, 16), (64, 64)])
@pytest.mark.parametrize("name,B,S,nh,chunk,strong", SPLIT_CASES)
def test_ssd_split_ref_matches_plain_and_jax(name, B, S, nh, chunk, strong,
                                             P, N):
    *inp, dy, dh = ssd_inputs(B, S, nh, P, N, strong, seed=P)
    tol = STRONG_ATOL_REL if strong else ATOL_REL
    ts = [torch.tensor(a) for a in (*inp, dy, dh)]
    got = [g.numpy() for g in ssd_ref.ssd_backward_split_ref(*ts)]
    _close(got, [g.numpy() for g in ssd_ref.ssd_backward_ref(*ts)],
           SSD_NAMES, tol, f"{name} ({P}, {N}) plain")
    _close(got, _jax_grads(jssd.ssd_chunked, inp, (dy, dh), chunk=chunk,
                           impl="jnp"), SSD_NAMES, tol, f"{name} ({P}, {N}) jax")


def test_split_refs_take_none_as_zero_and_refuse_other_widths():
    """No incoming-state cotangent is a zero one, bit for bit; a width the
    kernels' lane layout cannot hold is refused."""
    *inp, do, _ = wkv_inputs(1, 5, 2, 16, False)
    ts = [torch.tensor(a) for a in (*inp, do)]
    for a, b in zip(wkv_ref.wkv_backward_split_ref(*ts),
                    wkv_ref.wkv_backward_split_ref(
                        *ts, torch.zeros(1, 2, 16, 16))):
        assert torch.equal(a, b)
    *inp, dy, _ = ssd_inputs(1, 5, 2, 16, 16, False)
    ts = [torch.tensor(a) for a in (*inp, dy)]
    for a, b in zip(ssd_ref.ssd_backward_split_ref(*ts),
                    ssd_ref.ssd_backward_split_ref(
                        *ts, torch.zeros(1, 2, 16, 16))):
        assert torch.equal(a, b)
    *inp, do, _ = wkv_inputs(1, 3, 1, 8, False)
    with pytest.raises(ValueError):
        wkv_ref.wkv_backward_split_ref(*map(torch.tensor, (*inp, do)))
    *inp, dy, _ = ssd_inputs(1, 3, 1, 16, 8, False)
    with pytest.raises(ValueError):
        ssd_ref.ssd_backward_split_ref(*map(torch.tensor, (*inp, dy)))
