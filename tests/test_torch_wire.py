"""The port's wire tier (``repro_torch.core.tee.wire`` / ``components`` and
``api.CollaborativeSession``) against the JAX package on the CPU, on the
fixture of ``tests/test_wire.py``: MNIST-MLP3 at its published width
(P = 235,520), 4 silos of synthetic MNIST, 128 examples, sigma 0.05, C 1.

* The codec round-trips and its delta broadcast's epoch and pin checks.
* The noise streams: the port's serial handler draws xi and xi_prev
  inside ``clip_mask`` (its plain version here), where JAX's handler draws
  them with ``DPPipeline.noise_stream`` and passes them in (the port's
  speculative rounds do too: ``tests/test_torch_speculative_wire.py``). The threefry bits are
  equal; the normals agree within ``STREAM_ATOL`` (libm's ``log`` and XLA's
  fusion are not bit-portable; ``tests/test_torch_threefry.py``).
* A handler's contribution against JAX's ``_masked_contrib`` on the same
  gradient tree, within ``ATOL_PER_B * B`` (``tests/test_torch_clip_mask.py``:
  the mask term carries the normals' ulps times B).
* Whole sessions, 3 serial rounds (and with a drop and a rejoin, and with
  a budget that runs out): losses within ``LOSS_RTOL``, params within
  ``PARAM_ATOL``, epsilon and participation equal, and the bytes on the wire
  equal except the full messages' structure descriptors (JAX pickles its
  treedef, the port writes JSON: a difference of format, by design).
* Inside the port: pipelined == serial bit for bit, the pickle codec ==
  the packed codec bit for bit, the sharded fold == the serial fold, wire
  == fused within 2e-4 (``tests/test_dp_pipeline.py:103``), a tampered
  update detected and attributed, and no aliasing of the handler's pinned
  params.

The card's side (one ``clip_mask`` launch per active silo per round, card
against CPU rounds, pipelined == serial on the card) is checked by
``chip_smoke.py`` phase 16 and ``tests/test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CollaborativeSession as JSession
from repro.configs.base import PrivacyConfig as JPrivacyConfig
from repro.configs.paper_models import MNIST_MLP3 as JMLP3
from repro.core.barrier import step_keys as jstep_keys
from repro.core.dp_pipeline import DPPipeline as JPipeline
from repro.core import flatbuf as jflatbuf
from repro.core.noise_correction import NoiseState as JNoiseState
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
from repro_torch.core.tee.components import DataHandler, _ShardedAccumulator
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_fused import ref as fused_ref
from repro_torch.kernels.zsmask import threefry as ttf
from repro_torch.models.convert import small_params_from_jax
from repro_torch.models.small import build_small_model, value_and_grad

P_MLP3 = 235520  # 235,146 weights, leaves padded to 128, total to 1024
# the normals, XLA's jitted stream vs torch: libm's log and XLA's fused
# polynomial round differently, a few ulps of the largest normals' binade
# [4, 8) (measured max 9.5e-7 over 235,520 draws)
STREAM_ATOL = 4 * 2.0 ** -23 * 4
# the mask term b * (r_i - r_nxt): a few fp32 ulps of b * 10 per unit of b
ATOL_PER_B = 4 * 2.0 ** -23 * 10
SIGMA, C = 0.05, 1.0
B_MASK = 8.0 * SIGMA * C  # mask_scale * sigma * C
# losses: MLP3's forward in fp32, XLA vs torch, on params within PARAM_ATOL
LOSS_RTOL = 1e-5
# params after R rounds at lr 0.5: each round moves them by lr times the
# mean update, whose error is the masks' fp32 residue (contributions reach
# 10 B; 8 ulps of 10 B a sum) plus the normals' ulps times B, the
# gradients' own fp32 difference being far below; over 4 rounds
# 4 * 0.5 * 8 * 2**-23 * 10 * B = 7.6e-7, rounded up (measured 1.4e-7;
# losses 1.2e-7 relative)
PARAM_ATOL = 1e-6
LR = 0.5


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


def _silos(n=4):
    return [{"x": s.x, "y": s.y}
            for s in synthetic_mnist(n_train=128, n_test=16)[0].split(n)]


def _update_fn(p, update, lr):
    return {k: v - lr * torch.as_tensor(update[k], device=v.device)
            for k, v in p.items()}


def port_session(jax_init, n=4, budgets=None, noise_lambda=0.0,
                 mask_mode="pairwise", **kw):
    sm = build_small_model(MNIST_MLP3)
    params = small_params_from_jax(jax_init, "cpu")
    sess = CollaborativeSession.from_silos(
        _silos(n), PrivacyConfig(enabled=True, sigma=SIGMA, clip_bound=C,
                                 mask_mode=mask_mode,
                                 noise_lambda=noise_lambda),
        params_template=params, silo_budgets=budgets, device="cpu", **kw)
    return sess, params, value_and_grad(sm.loss), _update_fn


def jax_session(jax_init, n=4, budgets=None, noise_lambda=0.0):
    sm = jbuild(JMLP3)
    params = jax.tree.map(jnp.asarray, jax_init)
    sess = JSession.from_silos(
        [{"x": jnp.asarray(s.x), "y": jnp.asarray(s.y)}
         for s in jmnist(n_train=128, n_test=16)[0].split(n)],
        JPrivacyConfig(enabled=True, sigma=SIGMA, clip_bound=C,
                       noise_lambda=noise_lambda),
        params_template=params, silo_budgets=budgets)

    def grad_fn(p, data):
        return jax.value_and_grad(sm.loss)(p, data)

    def update_fn(p, update, lr):
        return jax.tree.map(lambda a, u: a - lr * u.astype(a.dtype), p,
                            update)

    return sess, params, grad_fn, update_fn


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _port_packed(params) -> np.ndarray:
    return wire.pack_np(flatbuf.layout_of(params), params)


def _jax_packed(params) -> np.ndarray:
    import repro.core.tee.wire as jwire
    return jwire.pack_np(jflatbuf.layout_of(params), params)


# ---------------------------------------------------------------------------
# the codec


def test_packed_roundtrip_bit_exact_and_pickle_fallback():
    rng = np.random.default_rng(0)
    tree = {"w": torch.tensor(rng.standard_normal((2, 617)), dtype=torch.float32),
            "b": np.zeros(5, np.float32), "s": torch.tensor(2.5),
            "stack": [torch.full((3, 4), float(i)) for i in range(3)]}
    blob = wire.encode_tree(tree)
    assert wire.decode(blob).kind == wire.KIND_FULL
    back = wire.decode_tree(blob)
    layout = flatbuf.layout_of(tree)
    assert flatbuf.layout_of(back) == layout and layout.total % 1024 == 0
    np.testing.assert_array_equal(_bits(wire.pack_np(layout, back)),
                                  _bits(wire.pack_np(layout, tree)))
    assert len(back["stack"]) == 3 and back["stack"][2].shape == (3, 4)
    # a tree with an int leaf (or codec='pickle') takes the pickle fallback
    mixed = {"i": np.arange(7, dtype=np.int32),
             "nested": {"f": torch.ones(3)}, "loss": torch.tensor(1.5)}
    for blob in (wire.encode_tree(mixed), wire.encode_tree(tree,
                                                           codec="pickle")):
        assert wire.decode(blob).kind == wire.KIND_PICKLE
    back = wire.decode_tree(wire.encode_tree(mixed))
    np.testing.assert_array_equal(back["i"], np.arange(7))
    assert back["i"].dtype == np.int32 and float(back["loss"]) == 1.5
    np.testing.assert_array_equal(back["nested"]["f"], np.ones(3))


def test_header_tamper_truncation_and_mismatch_rejected():
    tree = {"w": torch.ones(300)}
    layout = flatbuf.layout_of(tree)
    blob = wire.encode_tree(tree)
    with pytest.raises(wire.WireFormatError, match="truncated"):
        wire.decode(blob[:10])
    with pytest.raises(wire.WireFormatError, match="magic"):
        wire.decode(b"XXXX" + blob[4:])
    with pytest.raises(wire.WireFormatError, match="length mismatch"):
        wire.decode(blob + b"\x00")
    fp = bytearray(blob)
    fp[20] ^= 1  # inside the layout fingerprint
    with pytest.raises(wire.WireFormatError, match="does not match"):
        wire.decode_tree(bytes(fp))
    upd = wire.encode_update(layout, wire.pack_np(layout, tree), 1.0, 2.0)
    buf, loss, norm = wire.decode_update(wire.decode(upd), layout)
    assert (loss, norm) == (1.0, 2.0) and buf.shape == (layout.total,)
    other = flatbuf.layout_of({"w": torch.ones(301), "v": torch.ones(1)})
    with pytest.raises(wire.WireFormatError, match="fingerprint mismatch"):
        wire.decode_update(wire.decode(upd), other)
    with pytest.raises(wire.WireFormatError, match="kind-3"):
        wire.decode_tree(upd)


def test_delta_chain_epoch_and_pin_checks():
    """A handler applies XOR deltas bit-exactly in epoch order, refuses a
    delta before a full sync or after a missed epoch (StaleParamsError,
    the resync signal) and a broadcast of another layout than the one it
    pinned."""
    tree = {"a.w": torch.randn(40, 7), "a.b": torch.zeros(7)}
    layout = flatbuf.layout_of(tree)
    b0 = wire.pack_np(layout, tree)
    b1 = b0 + np.float32(0.25)
    b2 = b1 * np.float32(-3.0)
    h = DataHandler("h", None, silo_idx=0)
    with pytest.raises(wire.StaleParamsError, match="never synced"):
        h._sync_params(wire.encode_delta(layout, b0, b1, epoch=1))
    h._sync_params(wire.encode_full(layout, b0, epoch=1))
    out = h._sync_params(wire.encode_delta(layout, b0, b1, epoch=2))
    np.testing.assert_array_equal(_bits(h._cached_buf), _bits(b1))
    np.testing.assert_array_equal(out["a.b"], b1[:7])  # views of the cache
    with pytest.raises(wire.StaleParamsError, match="missed rounds"):
        h._sync_params(wire.encode_delta(layout, b1, b2, epoch=4))
    assert h._params_epoch == 2
    np.testing.assert_array_equal(_bits(h._cached_buf), _bits(b1))
    other = flatbuf.layout_of({"w": torch.ones(2048)})
    with pytest.raises(wire.WireFormatError, match="attested session layout"):
        h._sync_params(wire.encode_full(other, np.zeros(other.total,
                                                        np.float32)))


# ---------------------------------------------------------------------------
# the noise streams and one handler's contribution, against JAX


@pytest.mark.parametrize("key,silo", [((0, 7), 0), ((3704974950, 1863054868),
                                                    3)])
def test_in_kernel_streams_equal_jax_noise_stream(key, silo):
    """JAX's wire handler draws xi with ``DPPipeline.noise_stream(key,
    silo)``; the port's ``clip_mask`` draws it in the kernel. On a zero
    gradient with only the xi term at scale 1 the plain version returns the
    stream itself, whose threefry bits are JAX's."""
    layout = jflatbuf.layout_of({"w": jnp.zeros(P_MLP3)})
    jstream = np.asarray(JPipeline(JPrivacyConfig(), layout, 4).noise_stream(
        jnp.asarray(key, jnp.uint32), silo))
    idx = torch.arange(P_MLP3, dtype=torch.int64)
    stream = fused_ref.clip_mask_ref(
        torch.zeros(P_MLP3), 0.0, key, key, key, silo, 4, 1.0, 0.0, 0.0,
        use_pairwise=False, use_prev=False, noise_scale=1.0).numpy()
    np.testing.assert_array_equal(
        stream, ttf.normal_stream(key[0], key[1], idx, silo).numpy())
    import repro.kernels.zsmask.threefry as jtf
    jb0, jb1 = jtf.threefry2x32(key[0], key[1], jnp.arange(P_MLP3,
                                                           dtype=jnp.uint32),
                                jnp.full(P_MLP3, silo, jnp.uint32))
    b0, b1 = ttf.threefry2x32(key[0], key[1], idx,
                              torch.full((P_MLP3,), silo, dtype=torch.int64))
    np.testing.assert_array_equal(b0.numpy(), np.asarray(jb0, np.int64))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(jb1, np.int64))
    assert np.abs(stream - jstream).max() <= STREAM_ATOL


@pytest.mark.parametrize("lam,active", [(0.0, [1, 1, 1, 1]),
                                        (0.7, [1, 0, 1, 1])])
def test_handler_contribution_matches_jax_masked_contrib(jax_init, lam,
                                                         active):
    """Silo 2's contribution (clip, the zero-sum mask over the active ring,
    its noise share and, at lambda 0.7, its correction share on the
    state's prev_key over a set where silo 1 sat out) from one gradient
    tree fed to both handlers."""
    rng = np.random.default_rng(5)
    jgrads = {k: {n: (rng.standard_normal(np.shape(v)) * 0.02).astype(
        np.float32) for n, v in leaf.items()} for k, leaf in jax_init.items()}
    active = np.array(active, bool)
    prev_active = np.array([1, 1, 0, 1], bool)
    priv_kw = dict(enabled=True, sigma=0.3, clip_bound=4.0, noise_lambda=lam)
    jpipe = JPipeline(JPrivacyConfig(**priv_kw),
                      jflatbuf.layout_of(jgrads), 4)
    jkeys = jstep_keys(jax.random.PRNGKey(0), jnp.asarray(3))
    jstate = JNoiseState(prev_key=jnp.asarray([11, 12], jnp.uint32),
                         has_prev=jnp.ones((), jnp.bool_),
                         prev_active=jnp.asarray(prev_active))
    jout, jnorm = JHandler("h", None, silo_idx=2)._masked_contrib(
        jpipe, jax.tree.map(jnp.asarray, jgrads), jnp.asarray(active), jkeys,
        jstate, 4.0)
    grads = small_params_from_jax(jgrads, "cpu")
    pipe = DPPipeline(PrivacyConfig(**priv_kw), flatbuf.layout_of(grads), 4)
    assert pipe.layout.total == P_MLP3
    state = NoiseState(prev_key=(11, 12), has_prev=True,
                       prev_active=prev_active)
    out, norm = DataHandler("h", None, silo_idx=2)._masked_contrib(
        pipe, grads, active, step_keys(prng.PRNGKey(0), 3), state, 4.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    b = 8.0 * 0.3 * 4.0
    err = np.abs(out.numpy() - np.asarray(jout)).max()
    assert err <= ATOL_PER_B * b, err


# ---------------------------------------------------------------------------
# whole sessions against JAX


def _desc_lens(p_sess, j_sess) -> tuple:
    """The port's and JAX's full-message descriptor lengths."""
    import repro.core.tee.wire as jwire
    return (len(wire._layout_descriptor(p_sess._bcast_layout)),
            len(jwire._layout_descriptor(j_sess._bcast_layout)))


def _run_both(jax_init, schedule, budgets=None):
    """Drive a port and a JAX session through the same rounds; each entry of
    ``schedule`` is a list of ("drop" | "rejoin", silo) before the round."""
    ps, pp, pg, pu = port_session(jax_init, budgets=budgets)
    js, jp, jg, ju = jax_session(jax_init, budgets=budgets)
    for t, events in enumerate(schedule):
        for what, silo in events:
            for s in (ps, js):
                assert getattr(s, f"{what}_silo")(silo, step=t)
        pp, pl = ps.step(t, pp, pg, pu, lr=LR)
        jp, jl = js.step(t, jp, jg, ju, lr=LR)
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_port_packed(pp), _jax_packed(jp), rtol=0,
                               atol=PARAM_ATOL)
    assert ps.epsilon() == js.epsilon()
    assert ps.epsilon(1) == js.epsilon(1)
    assert ps.accountant.history == js.accountant.history
    # bytes on the wire: equal but for the full messages' descriptors
    dp, dj = _desc_lens(ps, js)
    n_full = 1 + (ps.wire_stats["resync_bytes"] > 0)
    for k in ("rounds", "update_bytes"):
        assert ps.wire_stats[k] == js.wire_stats[k], k
    assert ps.wire_stats["broadcast_bytes"] - dp == \
        js.wire_stats["broadcast_bytes"] - dj
    assert ps.wire_stats["resync_bytes"] - dp * (n_full - 1) == \
        js.wire_stats["resync_bytes"] - dj * (n_full - 1)
    return ps, js, pp


def test_session_matches_jax_three_serial_rounds(jax_init):
    dispatch.reset_launches()
    ps, js, _ = _run_both(jax_init, [[], [], []])
    assert ps.accountant.contributions == [4, 4, 4]
    assert dispatch.launch_counts()["clip_mask"] == 0  # CPU: plain versions
    assert ps.privacy_report()["silos"][0]["avg_round_trip_ms"] > 0
    # straggler escalation drops the silo the telemetry timed slowest
    rt = ps.telemetry.snapshot()
    slowest = ps.drop_slowest()
    assert slowest == max(rt, key=rt.get)
    assert not ps.membership.active_at(3)[slowest]


def test_session_matches_jax_with_drop_and_full_resync(jax_init):
    ps, js, _ = _run_both(jax_init, [[], [("drop", 1)], [], [("rejoin", 1)]])
    assert ps.accountant.contributions == [4, 3, 3, 4]
    assert ps.wire_stats["resync_bytes"] > 0  # silo 1's delta chain broke
    assert ps.handlers[1]._params_epoch == 4


def test_session_matches_jax_when_a_budget_runs_out(jax_init):
    """Silo 1's budget is spent by round 0: from round 1 the admin excludes
    it, and its handler refuses to compute inside the TEE boundary."""
    ps, js, pp = _run_both(jax_init, [[], [], []], budgets={1: 0.001})
    assert ps.accountant.contributions == [4, 3, 3]
    assert 1 in ps.membership.excluded
    assert not ps.rejoin_silo(1)  # no rejoin without the override
    plan = ps._admin_plane(3)
    with pytest.raises(PermissionError, match="budget is exhausted"):
        ps.handlers[1].compute_update(b"", value_and_grad(
            build_small_model(MNIST_MLP3).loss), ps.privacy, plan["keys"], 4,
            C)
    report = ps.privacy_report()
    assert report["silos"][1]["exhausted"]
    assert [e["silo"] for e in report["exclusions"]] == [1]


# ---------------------------------------------------------------------------
# the port's own contracts


def _serial(sess, params, grad_fn, update_fn, rounds):
    losses = []
    for t in range(rounds):
        params, loss = sess.step(t, params, grad_fn, update_fn, lr=LR)
        losses.append(loss)
    return params, losses


@pytest.mark.parametrize("noise_lambda", [0.0, 0.7])
def test_pipelined_run_matches_serial_bit_exact(jax_init, noise_lambda):
    """``run(pipelined=True)`` (ingest on the updater's thread, the admin
    plane overlapped with the close) against ``run(pipelined=False)``, the
    loop of ``step``: params, losses and bytes on the wire equal."""
    sa, params, grad_fn, update_fn = port_session(jax_init,
                                                  noise_lambda=noise_lambda)
    pa, la = sa.run(params, grad_fn, update_fn, lr=LR, n_rounds=3,
                    pipelined=False)
    sb, params, _, _ = port_session(jax_init, noise_lambda=noise_lambda)
    pb, lb = sb.run(params, grad_fn, update_fn, lr=LR, n_rounds=3,
                    pipelined=True)
    np.testing.assert_array_equal(_bits(_port_packed(pa)),
                                  _bits(_port_packed(pb)))
    assert la == lb and sa.wire_stats == sb.wire_stats
    assert sb.wire_stats["rounds"] == 3 and sb.accountant.steps == 3


def test_pickle_codec_and_sharded_fold_bit_equal_to_packed(jax_init):
    """The pickle codec (full blobs per handler, the per-block channel) and
    the sharded accumulator (4 threads) give the packed serial session's
    params bit for bit: packing is a permutation with zero padding, and
    each element is summed in silo order either way."""
    sa, params, grad_fn, update_fn = port_session(jax_init)
    pa, la = _serial(sa, params, grad_fn, update_fn, 2)
    for kw in ({"codec": "pickle"}, {"shard_workers": 4}):
        sb, params, _, _ = port_session(jax_init, **kw)
        pb, lb = _serial(sb, params, grad_fn, update_fn, 2)
        np.testing.assert_array_equal(_bits(_port_packed(pa)),
                                      _bits(_port_packed(pb)))
        assert la == lb
    assert sb.updater.shard_workers == 4
    assert lb[-1] < lb[0]


def test_sharded_accumulator_bit_equal_to_serial_fold():
    rng = np.random.default_rng(3)
    bufs = [rng.standard_normal(10007).astype(np.float32) for _ in range(6)]
    serial = bufs[0]
    for b in bufs[1:]:
        serial = serial + b
    acc = _ShardedAccumulator(bufs[0], 4)
    for b in bufs[1:]:
        acc.add(b)
    np.testing.assert_array_equal(_bits(acc.result()), _bits(serial))


def test_wire_aggregate_matches_fused_tier(jax_init):
    """One round of the wire tier (4 handlers' contributions summed by the
    updater) against the fused tier's ``run_central`` (``clip_accumulate``
    and ``noise_batch``' plain versions) on the same per-silo gradients:
    the masks cancel within fp32, the noise streams are the same."""
    from repro_torch.distributed.steps import StageTimer

    sess, params, grad_fn, _ = port_session(jax_init)
    seen = {}

    def capture(p, update, lr):
        seen["mean"] = wire.pack_np(flatbuf.layout_of(update), update)
        return p

    sess.step(0, params, grad_fn, capture, lr=LR)
    layout = flatbuf.layout_of(params)
    stacked = torch.stack([flatbuf.pack(layout, grad_fn(params, h.data)[1])
                           for h in sess.handlers])
    pipe = DPPipeline(sess.privacy, layout, 4)
    keys = step_keys(prng.PRNGKey(0), 0)
    state = sess.admin.state_for_step()._replace(has_prev=False)
    noisy, _, _ = pipe.run_central(stacked, pipe.norms(stacked), keys, state,
                                   C, keys.key_clip, None, StageTimer("cpu"))
    fused = flatbuf.zero_padding(layout, noisy).numpy() / np.float32(4)
    assert np.abs(seen["mean"] - fused).max() < 2e-4


def test_tampered_update_detected_and_attributed(jax_init):
    sess, params, grad_fn, update_fn = port_session(jax_init)
    assert sess.batch_mac  # on by default for the packed codec
    params, _ = sess.step(0, params, grad_fn, update_fn, lr=LR)
    plan = sess._admin_plane(1)
    updates = sess._collect_updates(params, plan, grad_fn)
    victim = sess.handlers[2].name
    blob = updates[victim]
    updates[victim] = blob[:-1] + bytes([blob[-1] ^ 1])
    batch = sess._batch_tag(1, updates)
    with pytest.raises(wire.WireFormatError,
                       match=f"{victim}.*Merkle batch tag"):
        sess.updater.aggregate(updates, params, update_fn, lr=LR, batch=batch)
    # the pipelined runner's deferred tag attributes it at close
    rs = sess.updater.begin_round(params, expected=list(updates),
                                  batch_mode=True)
    for h in sess.handlers:  # fresh receive counters for a second delivery
        sess.updater.channels[h.name]._recv_ctr -= 1
    for name, b in updates.items():
        sess.updater.ingest(rs, name, b)
    with pytest.raises(wire.WireFormatError, match=f"failed for {victim}"):
        sess.updater.close_round(rs, batch)
    with pytest.raises(wire.WireFormatError, match="without a batch tag"):
        sess.updater.close_round(rs, None)


def test_grad_fn_writing_into_params_cannot_corrupt_the_delta_base(jax_init):
    """The handler copies its params onto its device: model-owner code that
    writes into them leaves the pinned buffer alone, so the next delta still
    brings the handler bit-equal to the driver's params."""
    sess, params, grad_fn, update_fn = port_session(jax_init)

    def vandal(p, data):
        out = grad_fn(p, data)
        with torch.no_grad():
            for t in p.values():
                t.add_(1.0)
        return out

    for t in range(2):
        params, _ = sess.step(t, params, vandal, update_fn, lr=LR)
    sess.step(2, params, grad_fn, update_fn, lr=0.0)
    expect = _bits(_port_packed(params))
    for h in sess.handlers:
        np.testing.assert_array_equal(_bits(h._cached_buf), expect)


def test_no_quiet_cpu_and_unported_features_raise(jax_init, monkeypatch):
    """No quiet fall back to the CPU. Admin masks run a round: the admin
    draws the closing row once, and the handlers' update matches a
    session whose handlers draw it themselves."""
    adm, params, grad_fn, update_fn = port_session(jax_init,
                                                   mask_mode="admin")
    own, _, _, _ = port_session(jax_init, mask_mode="admin")
    own.admin.closing_mask_row = lambda *a, **kw: None  # handlers draw it
    pa, la = adm.step(0, params, grad_fn, update_fn, lr=LR)
    pb, lb = own.step(0, params, grad_fn, update_fn, lr=LR)
    assert la == lb and np.isfinite(la)
    np.testing.assert_array_equal(_bits(_port_packed(pa)),
                                  _bits(_port_packed(pb)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CollaborativeSession.from_silos(_silos(), PrivacyConfig(sigma=SIGMA))
