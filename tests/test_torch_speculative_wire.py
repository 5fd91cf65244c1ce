"""The port's speculative wire rounds (``CollaborativeSession.run(
speculative=True)``: each handler's key-tagged cache of its xi streams,
``DataHandler.prefetch_round``, ``DPPipeline.noise_stream`` and
``clip_mask`` with external streams) on the CPU, where the two new kernels
run their plain versions, on the fixture of ``tests/test_wire.py``:
MNIST-MLP3 at its published width (P = 235,520), 4 silos of synthetic
MNIST (128 examples), sigma 0.05, C 1, lr 0.5, lambda 0.7 (so both the xi
and the xi_{t-1} streams are read), JAX's initial weights carried over.

* Against JAX: ``noise_stream``'s threefry bits equal and its normals
  within ``STREAM_ATOL`` (libm's ``log`` and XLA's fusion are not
  bit-portable; ``tests/test_torch_wire.py``); a handler's contribution
  from external streams within ``ATOL_PER_B * B`` of JAX's
  ``_masked_contrib``; a 4-round speculative session against JAX's
  (losses ``LOSS_RTOL``, params ``PARAM_ATOL``, epsilon equal, the cache's
  hits per handler equal, the bytes on the wire equal but for the FULL
  message's layout descriptor, JSON in the port, a pickled treedef in
  JAX); the wire tier's ``enabled=False`` mirror (both packages add the
  noise and the masks anyway and charge epsilon) through a speculative and
  a tolerant round.
* Inside the port, bit for bit: external streams against the streams
  drawn inside ``clip_mask``, and speculative sessions against the serial
  ``step`` loop, with a membership change and with a broken delta chain
  (``tests/test_wire.py:288-381``).

The card's side (``noise_stream`` and the external-stream ``clip_mask``
against their plain versions and against ``clip_mask``'s in-kernel draw,
speculative == serial on the card) is checked by ``chip_smoke.py`` phase
16 and ``tests/test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CollaborativeSession as JSession
from repro.configs.base import PrivacyConfig as JPrivacyConfig
from repro.configs.paper_models import MNIST_MLP3 as JMLP3
from repro.core import flatbuf as jflatbuf
from repro.core.barrier import step_keys as jstep_keys
from repro.core.dp_pipeline import DPPipeline as JPipeline
from repro.core.noise_correction import NoiseState as JNoiseState
from repro.core.tee import wire as jwire
from repro.core.tee.components import DataHandler as JHandler
from repro.data.synthetic import synthetic_mnist as jmnist
from repro.models.small import build_small_model as jbuild
from repro_torch.api import CollaborativeSession
from repro_torch.configs.base import PrivacyConfig
from repro_torch.configs.paper_models import MNIST_MLP3
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.core.dp_pipeline import DPPipeline
from repro_torch.core.noise_correction import NoiseState
from repro_torch.core.tee import wire
from repro_torch.core.tee.components import DataHandler
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_fused import ops as fused_ops
from repro_torch.kernels.dp_fused import ref as fused_ref
from repro_torch.kernels.zsmask import threefry as ttf
from repro_torch.models.convert import small_params_from_jax
from repro_torch.models.small import build_small_model, value_and_grad

P_MLP3 = 235520  # 235,146 weights, leaves padded to 128, total to 1024
# XLA's jitted stream vs torch's normals: a few ulps of the largest
# normals' binade [4, 8) (tests/test_torch_wire.py)
STREAM_ATOL = 4 * 2.0 ** -23 * 4
# the mask term b * (r_i - r_nxt): a few fp32 ulps of b * 10 per unit of b
ATOL_PER_B = 4 * 2.0 ** -23 * 10
SIGMA, C, LR, LAM = 0.05, 1.0, 0.5, 0.7
# sessions against JAX over 4 rounds (tests/test_torch_wire.py): losses,
# and params (4 * 0.5 * 8 * 2**-23 * 10 * B = 7.6e-7, rounded up)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    return jax.tree.map(np.asarray, jbuild(JMLP3).init(jax.random.PRNGKey(1)))


def _update_fn(p, update, lr):
    return {k: v - lr * torch.as_tensor(update[k], device=v.device)
            for k, v in p.items()}


def port_session(jax_init, n=4, enabled=True):
    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y}
             for s in synthetic_mnist(n_train=128, n_test=16)[0].split(n)]
    params = small_params_from_jax(jax_init, "cpu")
    sess = CollaborativeSession.from_silos(
        silos, PrivacyConfig(enabled=enabled, sigma=SIGMA, clip_bound=C,
                             noise_lambda=LAM),
        params_template=params, device="cpu")
    return sess, params, value_and_grad(sm.loss), _update_fn


def jax_session(jax_init, n=4, enabled=True):
    sm = jbuild(JMLP3)
    params = jax.tree.map(jnp.asarray, jax_init)
    sess = JSession.from_silos(
        [{"x": jnp.asarray(s.x), "y": jnp.asarray(s.y)}
         for s in jmnist(n_train=128, n_test=16)[0].split(n)],
        JPrivacyConfig(enabled=enabled, sigma=SIGMA, clip_bound=C,
                       noise_lambda=LAM),
        params_template=params)

    def grad_fn(p, data):
        return jax.value_and_grad(sm.loss)(p, data)

    def update_fn(p, update, lr):
        return jax.tree.map(lambda a, u: a - lr * u.astype(a.dtype), p,
                            update)

    return sess, params, grad_fn, update_fn


def _port_packed(params) -> np.ndarray:
    return wire.pack_np(flatbuf.layout_of(params), params)


def _jax_packed(params) -> np.ndarray:
    return jwire.pack_np(jflatbuf.layout_of(params), params)


def _bits(params) -> np.ndarray:
    return _port_packed(params).view(np.uint32)


def _serial(sess, params, grad_fn, update_fn, rounds):
    losses = []
    for _ in range(rounds):
        params, loss = sess.step(sess._next_round, params, grad_fn,
                                 update_fn, LR)
        losses.append(loss)
    return params, losses


# ---------------------------------------------------------------------------
# the streams and one handler's contribution


# MNIST-MLP3's length and ragged ones: the edges of the stream kernels'
# groups of 4 elements (csrc/stream_grid.cuh) and a length under the wire
# shape
@pytest.mark.parametrize("n", [P_MLP3, 1, 7, 255, 235_187])
@pytest.mark.parametrize("key,silo", [((0, 7), 0),
                                      ((3704974950, 1863054868), 3)])
def test_noise_stream_matches_jax_and_the_in_kernel_draw(key, silo, n):
    """``DPPipeline.noise_stream`` against JAX's (threefry bits equal,
    normals within STREAM_ATOL) and, bit for bit, against the xi stream
    the plain ``clip_mask`` draws (a zero gradient, the xi term alone), for
    a leaf of n parameters (a stream over the layout's padded total); and
    ``ops.noise_stream`` at the ragged length n itself against the first n
    of JAX's (a stream's element p depends on p alone)."""
    jlayout = jflatbuf.layout_of({"w": jnp.zeros(n)})
    jstream = np.asarray(JPipeline(JPrivacyConfig(), jlayout, 4).noise_stream(
        jnp.asarray(key, jnp.uint32), silo))
    layout = flatbuf.layout_of({"w": torch.zeros(n)})
    T = layout.total
    assert T == jlayout.total and T >= n
    stream = DPPipeline(PrivacyConfig(), layout, 4).noise_stream(key, silo,
                                                                 "cpu")
    assert stream.dtype == torch.float32 and stream.shape == (T,)
    drawn = fused_ops.clip_mask(torch.zeros(T), 0.0, key, key, key,
                                silo, 4, 1.0, 0.0, 0.0, use_pairwise=False,
                                use_prev=False, noise_scale=1.0)
    assert torch.equal(stream, drawn)
    ragged = fused_ops.noise_stream(key, silo, torch.empty(n))
    assert torch.equal(ragged, stream[:n])
    assert np.abs(ragged.numpy() - jstream[:n]).max() <= STREAM_ATOL
    import repro.kernels.zsmask.threefry as jtf
    idx = torch.arange(T, dtype=torch.int64)
    b0, b1 = ttf.threefry2x32(key[0], key[1], idx,
                              torch.full((T,), silo, dtype=torch.int64))
    jb0, jb1 = jtf.threefry2x32(key[0], key[1],
                                jnp.arange(T, dtype=jnp.uint32),
                                jnp.full(T, silo, jnp.uint32))
    np.testing.assert_array_equal(b0.numpy(), np.asarray(jb0, np.int64))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(jb1, np.int64))
    assert np.abs(stream.numpy() - jstream).max() <= STREAM_ATOL
    # a window of the stream at its counter offset
    w = min(n, 1000)
    tail = fused_ref.noise_stream_ref(key, silo, w, "cpu", base=n - w)
    assert torch.equal(tail, stream[n - w:n])


@pytest.mark.parametrize("use_pairwise,use_prev", [(True, True),
                                                   (True, False),
                                                   (False, True)])
def test_external_streams_bit_equal_to_in_kernel_draw(use_pairwise,
                                                      use_prev):
    """``clip_mask`` given ``noise_stream``'s xi and xi_{t-1} equals the
    in-kernel draw bit for bit (and with one stream given, the other
    drawn), in place too; streams of the wrong shape, dtype or device, or
    on a construction that draws its own, raise."""
    g = torch.randn(3 * 1024 + 5, generator=torch.Generator().manual_seed(6))
    kr, kx, kp = (11, 12), (21, 22), (31, 32)
    args = (torch.tensor(0.731), kr, kx, kp, 1, 4, torch.tensor(1.2),
            torch.tensor(9.6), torch.tensor(0.7), use_pairwise, use_prev)
    kw = dict(nxt=3, noise_scale=torch.tensor(0.6928),
              prev_noise_scale=torch.tensor(0.6))
    xi = fused_ops.noise_stream(kx, 1, torch.empty_like(g))
    xp = fused_ops.noise_stream(kp, 1, torch.empty_like(g))
    want = fused_ops.clip_mask(g, *args, **kw)
    assert torch.equal(fused_ops.clip_mask(g, *args, xi=xi, xp=xp, **kw), want)
    assert torch.equal(fused_ops.clip_mask(g, *args, xi=xi, **kw), want)
    assert torch.equal(fused_ops.clip_mask(g, *args, xp=xp, **kw), want)
    inplace = g.clone()
    assert fused_ops.clip_mask(inplace, *args, xi=xi, xp=xp, out=inplace,
                               **kw) is inplace
    assert torch.equal(inplace, want)
    launched = dispatch.launch_counts()
    assert launched["noise_stream"] == launched["clip_mask_ext"] == 0
    for bad, match in ((xi[:-1], "expected"), (xi.double(), "dtype"),
                       (xi.view(1, -1), "2-d")):
        with pytest.raises(ValueError, match=match):
            fused_ops.clip_mask(g, *args, xi=bad, **kw)
    with pytest.raises(ValueError, match="dtype"):
        fused_ops.noise_stream(kx, 1, torch.empty(8, dtype=torch.float64))
    layout = flatbuf.layout_of({"w": g})
    none = DPPipeline(PrivacyConfig(mask_mode="none"), layout, 4)
    keys = step_keys(prng.PRNGKey(0), 0)
    with pytest.raises(ValueError, match="packed pairwise"):
        none.silo_contribution(g, 1, torch.tensor(1.0), None, keys,
                               NoiseState((0, 0), False), 1.0, xi=xi)


def test_handler_contribution_with_external_streams_matches_jax(jax_init):
    """Silo 2's contribution with its streams passed in (a speculative
    handler: clip, the mask over a set where silo 1 sits out, the noise
    share and, at lambda 0.7, the correction share on the state's
    prev_key) against JAX's ``_masked_contrib`` on one gradient tree, and
    bit for bit against the port's serial handler."""
    rng = np.random.default_rng(5)
    jgrads = {k: {n: (rng.standard_normal(np.shape(v)) * 0.02).astype(
        np.float32) for n, v in leaf.items()} for k, leaf in jax_init.items()}
    active = np.array([1, 0, 1, 1], bool)
    prev_active = np.array([1, 1, 0, 1], bool)
    priv_kw = dict(enabled=True, sigma=0.3, clip_bound=4.0, noise_lambda=LAM)
    jpipe = JPipeline(JPrivacyConfig(**priv_kw), jflatbuf.layout_of(jgrads), 4)
    jkeys = jstep_keys(jax.random.PRNGKey(0), jnp.asarray(3))
    jstate = JNoiseState(prev_key=jnp.asarray([11, 12], jnp.uint32),
                         has_prev=jnp.ones((), jnp.bool_),
                         prev_active=jnp.asarray(prev_active))
    jout, _ = JHandler("h", None, silo_idx=2)._masked_contrib(
        jpipe, jax.tree.map(jnp.asarray, jgrads), jnp.asarray(active), jkeys,
        jstate, 4.0)
    grads = small_params_from_jax(jgrads, "cpu")
    pipe = DPPipeline(PrivacyConfig(**priv_kw), flatbuf.layout_of(grads), 4)
    state = NoiseState(prev_key=(11, 12), has_prev=True,
                       prev_active=prev_active)
    keys = step_keys(prng.PRNGKey(0), 3)
    spec = DataHandler("h", None, silo_idx=2)
    spec.speculative = True
    out, _ = spec._masked_contrib(pipe, grads, active, keys, state, 4.0)
    assert len(spec._stream_cache) == 1 and spec._spec_hits == 0
    serial, _ = DataHandler("h", None, silo_idx=2)._masked_contrib(
        pipe, grads, active, keys, state, 4.0)
    assert torch.equal(out, serial)
    b = 8.0 * 0.3 * 4.0
    err = np.abs(out.numpy() - np.asarray(jout)).max()
    assert err <= ATOL_PER_B * b, err
    # the cached xi is next round's xi_{t-1}: a hit, the same bits
    nxt = NoiseState(prev_key=keys.key_xi, has_prev=True, prev_active=active)
    keys4 = step_keys(prng.PRNGKey(0), 4)
    again, _ = spec._masked_contrib(pipe, grads, active, keys4, nxt, 4.0)
    assert spec._spec_hits == 1
    assert torch.equal(again, DataHandler("h", None, silo_idx=2)
                       ._masked_contrib(pipe, grads, active, keys4, nxt,
                                        4.0)[0])


def test_stream_cache_keeps_two_and_prefetch_only_when_speculative():
    h = DataHandler("h", None, silo_idx=1)
    layout = flatbuf.layout_of({"w": torch.zeros(2048)})
    h._spec_pipe = DPPipeline(PrivacyConfig(), layout, 4)
    keys = [step_keys(prng.PRNGKey(0), t) for t in range(3)]
    h.prefetch_round(keys[0])
    assert not h._stream_cache  # serial mode: no prefetch
    h.speculative = True
    for k in keys:
        h.prefetch_round(k)
    assert len(h._stream_cache) == 2  # the oldest went
    cached = h._stream_cache[np.asarray(keys[2].key_xi, np.uint32).tobytes()]
    assert torch.equal(cached, h._spec_pipe.noise_stream(keys[2].key_xi, 1,
                                                         "cpu"))


# ---------------------------------------------------------------------------
# whole sessions


def test_speculative_session_matches_jax(jax_init):
    """4 speculative rounds against JAX's speculative session: losses,
    params, epsilon, the cache's hits per handler, the bytes on the wire
    (speculative == serial inside the port: the next two tests)."""
    js, jp, jg, ju = jax_session(jax_init)
    jp, jl = js.run(jp, jg, ju, lr=LR, n_rounds=4, speculative=True)
    ps, pp, pg, pu = port_session(jax_init)
    pp, pl = ps.run(pp, pg, pu, lr=LR, n_rounds=4, speculative=True)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_port_packed(pp), _jax_packed(jp), rtol=0,
                               atol=PARAM_ATOL)
    assert ps.epsilon() == js.epsilon()
    hits = [h._spec_hits for h in ps.handlers]
    assert hits == [h._spec_hits for h in js.handlers] and all(hits)
    assert not any(h.speculative for h in ps.handlers)  # the flag restored
    dp = len(wire._layout_descriptor(ps._bcast_layout))
    dj = len(jwire._layout_descriptor(js._bcast_layout))
    for k in ("rounds", "update_bytes", "resync_bytes"):
        assert ps.wire_stats[k] == js.wire_stats[k], k
    assert ps.wire_stats["broadcast_bytes"] - dp == \
        js.wire_stats["broadcast_bytes"] - dj


def test_speculative_membership_change_matches_serial(jax_init):
    """A drop and a rejoin between speculative runs: the other handlers'
    caches stay valid (a stream depends on its key and silo only), the
    rejoined handler misses and draws anew, and its broken delta chain
    takes the full resync; the end state is the serial schedule's."""
    sched = [("run", 1), ("drop", 1), ("run", 2), ("rejoin", 1), ("run", 2)]

    def drive(speculative):
        sess, p, grad_fn, update_fn = port_session(jax_init)
        losses = []
        for op, arg in sched:
            if op == "drop":
                assert sess.drop_silo(arg)
            elif op == "rejoin":
                sess.rejoin_silo(arg)
            elif speculative:
                p, ls = sess.run(p, grad_fn, update_fn, lr=LR, n_rounds=arg,
                                 speculative=True)
                losses += ls
            else:
                p, ls = _serial(sess, p, grad_fn, update_fn, arg)
                losses += ls
        return sess, p, losses

    sa, pa, la = drive(False)
    sb, pb, lb = drive(True)
    np.testing.assert_array_equal(_bits(pa), _bits(pb))
    assert la == lb and sa.wire_stats == sb.wire_stats
    assert sa.wire_stats["resync_bytes"] > 0  # the chain really broke
    assert sa.accountant.contributions == sb.accountant.contributions \
        == [4, 3, 3, 4, 4]
    assert all(h._spec_hits > 0 for h in sb.handlers)


def test_speculative_broken_delta_chain_matches_serial(jax_init):
    """A handler that missed an epoch raises StaleParamsError and is
    resynced inside the round, under the speculative scheduler as under
    serial rounds, with bit-equal results."""
    def drive(speculative):
        sess, p, grad_fn, update_fn = port_session(jax_init)
        losses = []
        for phase in range(2):
            if phase == 1:
                sess.handlers[2]._params_epoch -= 1  # a missed broadcast
            if speculative:
                p, ls = sess.run(p, grad_fn, update_fn, lr=LR, n_rounds=2,
                                 speculative=True)
            else:
                p, ls = _serial(sess, p, grad_fn, update_fn, 2)
            losses += ls
        return sess, p, losses

    sa, pa, la = drive(False)
    sb, pb, lb = drive(True)
    assert sa.wire_stats["resync_bytes"] > 0
    np.testing.assert_array_equal(_bits(pa), _bits(pb))
    assert la == lb and sa.wire_stats == sb.wire_stats


def test_wire_tier_ignores_enabled_false_like_jax(jax_init):
    """``PrivacyConfig(enabled=False)`` on the wire tier: JAX's handler
    never reads the flag, so it still clips, masks and adds the noise, and
    the ledger charges epsilon. The port mirrors it through a speculative
    and a fault-tolerant round: the same rounds as JAX's serial loop, and
    bit for bit the port's enabled session."""
    js, jp, jg, ju = jax_session(jax_init, enabled=False)
    jl = []
    for t in range(2):
        jp, loss = js.step(t, jp, jg, ju, LR)
        jl.append(loss)

    def port(enabled):
        sess, p, grad_fn, update_fn = port_session(jax_init, enabled=enabled)
        p, l0 = sess.run(p, grad_fn, update_fn, LR, 1, speculative=True)
        p, l1 = sess.run(p, grad_fn, update_fn, LR, 1, quorum=4)
        return sess, p, l0 + l1

    ps, pp, pl = port(False)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_port_packed(pp), _jax_packed(jp), rtol=0,
                               atol=PARAM_ATOL)
    assert ps.epsilon() == js.epsilon() > 0
    es, ep, el = port(True)
    np.testing.assert_array_equal(_bits(pp), _bits(ep))
    assert pl == el and ps.epsilon() == es.epsilon()
