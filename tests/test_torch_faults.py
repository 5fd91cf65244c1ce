"""The port's fault-tolerant wire rounds (``repro_torch.core.tee.faults`` and
``CollaborativeSession.run(round_timeout_s=|quorum=|chaos=|journal=)``,
``resume``, ``rejoin_silo_async``) on the CPU, on the fixture of
``tests/test_faults.py``: MNIST-MLP3 at its published width, synthetic
MNIST (128 examples), sigma 0.05, C 1, lr 0.5, JAX's initial weights
carried over (``models/convert.small_params_from_jax``).

* Against JAX: the fault plans event for event from the same seeds, the
  backoff's delays, the telemetry's penalty; a port chaos run's realized
  participation sets replayed through JAX's serial ``step`` loop (params
  within ``chaos_param_atol`` but on the few hidden units where a ReLU
  flips, losses within ``LOSS_RTOL``, the ledger's contributions equal).
  The journals' params blobs do not cross the packages (the FULL message's
  layout is JSON in the port, a pickled treedef in JAX): a divergence by
  design, pinned here.
* Inside the port, bit for bit: a chaos run against the fault-free elastic
  run that schedules its realized sets; a hang past the deadline (the
  round closed without the silo, its late result discarded, no rejoin
  while its worker runs) against the same oracle; a journal resumed after
  a driver restart against a run that never stopped; a fault-free
  tolerant run against the serial ``step`` loop.
* Behaviour as in JAX: corruption attributed and never retried, a dead
  ingest thread stopping a pipelined run, the received cap, an async
  rejoin under a transient KDS denial and a budget-excluded silo refused.

The deadline of the chaos run comes from a measured warm round: the plain
versions on the CPU take a handler 0.1-0.2 s, so JAX's 0.15 s would fell
unfaulted silos. The oracle replays the realized sets, so a slow silo
changes the sets and never the verdict.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CollaborativeSession as JSession
from repro.configs.base import PrivacyConfig as JPrivacyConfig
from repro.configs.paper_models import MNIST_MLP3 as JMLP3
from repro.core.tee import faults as jfaults
from repro.core.tee import wire as jwire
from repro.data.synthetic import synthetic_mnist as jmnist
from repro.models.small import build_small_model as jbuild
from repro.runtime.straggler import SiloTelemetry as JTelemetry
from repro_torch.api import CollaborativeSession
from repro_torch.configs.base import PrivacyConfig
from repro_torch.configs.paper_models import MNIST_MLP3
from repro_torch.core import flatbuf
from repro_torch.core.tee import wire
from repro_torch.core.tee.faults import (CORRUPT, HANG, KDS_DENY, Backoff,
                                         FaultEvent, FaultInjector,
                                         FaultPlan, RoundJournal)
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.models.convert import small_params_from_jax
from repro_torch.models.small import build_small_model, value_and_grad
from repro_torch.runtime.straggler import SiloTelemetry

SIGMA, C, LR = 0.05, 1.0, 0.5
B_MASK = 8.0 * SIGMA * C  # mask_scale * sigma * C
# losses: MLP3's forward in fp32, XLA vs torch (tests/test_torch_wire.py)
LOSS_RTOL = 1e-5
# the chaos run (tests/test_faults.py:123): 6 silos, quorum 4, 12 rounds
N_CHAOS, ROUNDS_CHAOS, QUORUM_CHAOS, SEED_CHAOS = 6, 12, 4, 7


def chaos_param_atol(rounds: int) -> float:
    """Port vs JAX params after ``rounds`` rounds at lr 0.5: each round's
    mean update carries the masks' fp32 residue (contributions reach 10 B;
    8 ulps of 10 B a sum) moved by lr (``tests/test_torch_wire.py``)."""
    return rounds * LR * 8 * 2.0 ** -23 * 10 * B_MASK


# ...except where a ReLU flips: in the chaos run's round 5 (silo 1 back,
# silo 3 out) an example's pre-activation at a hidden unit lies within fp32
# rounding of 0, XLA and torch sum its 784 products in other orders, and
# that unit's fan-in, bias and fan-out move by up to 5.5e-5 (measured: 22
# elements past chaos_param_atol, all on the fan-in of layer-1 unit 24, up
# to 5.46e-5). Every element past chaos_param_atol must lie on the fan-in,
# bias or fan-out of at most FLIP_UNITS hidden units (one measured, one of
# margin), each within FLIP_ATOL (under 2x the measured).
FLIP_UNITS, FLIP_ATOL = 2, 1e-4


def _units_of(leaf: str, idx: tuple) -> set:
    """The hidden units (layer, unit) of MLP3 whose fan-in, bias or fan-out
    hold element ``idx`` of ``leaf`` (none for the output bias)."""
    if leaf == "l0.w":
        return {(0, idx[1])}
    if leaf == "l0.b":
        return {(0, idx[0])}
    if leaf == "l1.w":
        return {(0, idx[0]), (1, idx[1])}
    if leaf == "l1.b":
        return {(1, idx[0])}
    if leaf == "l2.w":
        return {(1, idx[0])}
    return set()


def _flip_cover(err: dict, atol: float, max_units: int):
    """The fewest hidden units (at most ``max_units``) that hold every
    element of ``err`` (leaf -> |port - JAX|) past ``atol``, or None."""
    import itertools
    past = [_units_of(k, tuple(int(i) for i in ix))
            for k, e in err.items() for ix in np.argwhere(e > atol)]
    cands = sorted(set().union(*past)) if past else []
    for n in range(max_units + 1):
        for units in itertools.combinations(cands, n):
            if all(u & set(units) for u in past):
                return units
    return None


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


def port_session(jax_init, n=4, **kw):
    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y}
             for s in synthetic_mnist(n_train=128, n_test=16)[0].split(n)]
    params = small_params_from_jax(jax_init, "cpu")
    sess = CollaborativeSession.from_silos(
        silos, PrivacyConfig(enabled=True, sigma=SIGMA, clip_bound=C),
        params_template=params, device="cpu", **kw)
    return sess, params, value_and_grad(sm.loss), _update_fn


def jax_session(jax_init, n=4):
    sm = jbuild(JMLP3)
    params = jax.tree.map(jnp.asarray, jax_init)
    sess = JSession.from_silos(
        [{"x": jnp.asarray(s.x), "y": jnp.asarray(s.y)}
         for s in jmnist(n_train=128, n_test=16)[0].split(n)],
        JPrivacyConfig(enabled=True, sigma=SIGMA, clip_bound=C),
        params_template=params)

    def grad_fn(p, data):
        return jax.value_and_grad(sm.loss)(p, data)

    def update_fn(p, update, lr):
        return jax.tree.map(lambda a, u: a - lr * u.astype(a.dtype), p,
                            update)

    return sess, params, grad_fn, update_fn


def _bits(params) -> np.ndarray:
    return wire.pack_np(flatbuf.layout_of(params), params).view(np.uint32)


def _replay(sess, params, grad_fn, update_fn, journal):
    """Schedule each journaled round's realized set as an ordinary elastic
    membership change and run the serial ``step`` loop (either package's
    session): the fault-free run a quorum-closed run must match."""
    losses = []
    for rec in journal.rounds:
        t, want = rec["round"], np.asarray(rec["active"], bool)
        cur = sess.membership.active_at(t)
        for silo in range(sess.n_silos):
            if cur[silo] and not want[silo]:
                assert sess.drop_silo(silo, step=t)
            elif not cur[silo] and want[silo]:
                sess.rejoin_silo(silo, step=t)
        params, loss = sess.step(t, params, grad_fn, update_fn, LR)
        losses.append(loss)
    return params, losses


# ---------------------------------------------------------------------------
# the plan, the backoff, the journal and the telemetry against JAX


@pytest.mark.parametrize("seed,n,rounds,quorum", [
    (3, 8, 40, 5), (7, 6, 12, 4), (11, 6, 16, 4), (1, 4, 6, None)])
def test_fault_plan_matches_jax(seed, n, rounds, quorum):
    plan = FaultPlan.from_seed(seed, n, rounds, quorum=quorum, hang_s=1.7)
    ref = jfaults.FaultPlan.from_seed(seed, n, rounds, quorum=quorum,
                                      hang_s=1.7)
    assert [tuple(vars(e).values()) for e in plan.events] == \
        [tuple(vars(e).values()) for e in ref.events]
    assert plan.counts() == ref.counts() and plan.counts()
    cap = n - max(1, quorum if quorum is not None else (n + 1) // 2)
    for t in range(rounds):
        assert len({e.silo for e in plan.events
                    if e.round_id == t and e.silo is not None}) <= cap


def test_flip_cover_holds_only_a_few_units():
    """The ReLU-flip allowance of the JAX chaos check: errors on one unit's
    fan-in, bias and fan-out are covered; a fault on a whole bias vector,
    on three units' fan-ins or on the output bias is not."""
    shapes = {"l0.b": (256,), "l0.w": (784, 256), "l1.b": (128,),
              "l1.w": (256, 128), "l2.b": (10,), "l2.w": (128, 10)}
    zero = {k: np.zeros(v, np.float32) for k, v in shapes.items()}

    def cover(**marks):
        err = {k: v.copy() for k, v in zero.items()}
        for k, ix in marks.items():
            err[k][ix] = 1.0
        return _flip_cover(err, 0.5, FLIP_UNITS)

    assert cover() == ()
    assert cover(**{"l0.w": (np.s_[:5], 7), "l0.b": 7,
                    "l1.w": (7, np.s_[:])}) == ((0, 7),)
    assert cover(**{"l1.w": (np.s_[:22], 24)}) == ((1, 24),)
    assert cover(**{"l1.w": (3, 9), "l2.w": (40, 2)}) is not None
    assert cover(**{"l0.b": np.s_[:]}) is None
    assert cover(**{"l1.w": (np.s_[:3], np.s_[4:7])}) is None
    assert cover(**{"l2.b": 0}) is None


def test_backoff_injector_and_journal(tmp_path):
    """The backoff's jittered delays equal JAX's; an injector's event fires
    once; a journal round-trips through disk (written by ``os.replace``)."""
    for seed in (0, 5, 1009 * 3 + 2):
        a, b = Backoff(seed=seed), jfaults.Backoff(seed=seed)
        assert [a.delay() for _ in range(5)] == [b.delay() for _ in range(5)]
    bo = Backoff(base_s=0.0, max_s=0.0, max_attempts=2, seed=0)
    assert bo.sleep() and bo.sleep() and not bo.sleep()
    inj = FaultInjector(FaultPlan(seed=0, n_silos=2, n_rounds=1,
                                  events=[FaultEvent(0, CORRUPT, 1, 2.0)]))
    blob = bytes(range(64))
    jinj = jfaults.FaultInjector(jfaults.FaultPlan(
        seed=0, n_silos=2, n_rounds=1,
        events=[jfaults.FaultEvent(0, CORRUPT, 1, 2.0)]))
    assert inj.transit_fault(0, 1, blob) == jinj.transit_fault(0, 1, blob) \
        != blob
    assert inj.transit_fault(0, 1, blob) == blob and inj.fired == {CORRUPT: 1}
    p = str(tmp_path / "journal.bin")
    j = RoundJournal(path=p)
    j.commit(0, [True, False, True], b"params-v0", downed={1: 0})
    j.commit(1, np.array([True, True, True]), b"params-v1")
    loaded = RoundJournal.load(p)
    assert loaded.rounds == j.rounds and loaded.rounds_done == 2
    assert loaded.params_blob == b"params-v1" and loaded.downed == {1: 0}
    assert not (tmp_path / "journal.bin.tmp").exists()


def test_telemetry_penalize_and_ema_match_jax():
    port, ref = SiloTelemetry(3), JTelemetry(3)
    for t in (port, ref):
        t.observe_all([0.1, 0.2, 0.05])
        t.observe(1, 0.4)
        t.penalize(2, 1.0)    # a hung silo: 3 x the deadline, blended
        t.penalize(1, 0.01)   # its EMA is larger: kept
    assert port.snapshot() == ref.snapshot()
    assert port.ema(2) == ref.ema(2) and port.ema(0) == 0.1
    assert port.ema(5) is None
    assert port.slowest([0, 1, 2]) == 2


def test_journal_params_blobs_do_not_cross_the_packages(jax_init):
    """A journal's params blob is its package's ``wire.encode_tree``: the
    FULL message's layout descriptor is JSON in the port and a pickled
    treedef in JAX, so neither decodes the other's (a journal does not
    resume a session of the other package)."""
    port_blob = wire.encode_tree(small_params_from_jax(jax_init, "cpu"))
    jax_blob = jwire.encode_tree(jax.tree.map(jnp.asarray, jax_init))
    assert wire.decode(port_blob).kind == wire.KIND_FULL
    assert port_blob[:4] == jax_blob[:4]  # one envelope
    with pytest.raises(Exception):
        wire.decode_tree(jax_blob)
    with pytest.raises(Exception):
        jwire.decode_tree(port_blob)


# ---------------------------------------------------------------------------
# the chaos run: against the elastic oracle (bit for bit) and JAX


@pytest.fixture(scope="module")
def chaos_run(jax_init, one_thread):
    """A seeded chaos run (crashes, corruption, KDS denials, an updater
    crash; tests/test_faults.py:123's plan) with the deadline from a warm
    round of a scratch session and the plan's hangs scaled past it."""
    warm, params, grad_fn, update_fn = port_session(jax_init, n=N_CHAOS)
    warm.step(0, params, grad_fn, update_fn, LR)
    deadline = max(0.15, 10 * max(warm.telemetry.snapshot().values()))
    sess, params, grad_fn, update_fn = port_session(jax_init, n=N_CHAOS)
    inj = FaultInjector(FaultPlan.from_seed(
        SEED_CHAOS, N_CHAOS, ROUNDS_CHAOS, quorum=QUORUM_CHAOS,
        hang_s=2 * deadline))
    journal = RoundJournal()
    t0 = time.perf_counter()
    params, losses = sess.run(params, grad_fn, update_fn, LR, ROUNDS_CHAOS,
                              round_timeout_s=deadline, quorum=QUORUM_CHAOS,
                              chaos=inj, journal=journal)
    return {"sess": sess, "params": params, "losses": losses, "inj": inj,
            "journal": journal, "deadline": deadline,
            "s": time.perf_counter() - t0}


def test_chaos_run_bit_identical_to_elastic_oracle(jax_init, chaos_run):
    """Every round closes, the plan fired, integrity failures are
    attributed, and the params are bit-equal (losses and the ledger's
    contributions equal) to a fault-free elastic run of the realized
    sets."""
    sess, journal = chaos_run["sess"], chaos_run["journal"]
    assert journal.rounds_done == ROUNDS_CHAOS
    assert chaos_run["inj"].fired
    fails = sess.fault_stats["integrity_failures"]
    assert fails and all(f["silo"].startswith("handler-") for f in fails)
    assert sess.fault_stats["updater_recoveries"] >= 1
    oracle, params, grad_fn, update_fn = port_session(jax_init, n=N_CHAOS)
    params, losses = _replay(oracle, params, grad_fn, update_fn, journal)
    np.testing.assert_array_equal(_bits(chaos_run["params"]), _bits(params))
    assert chaos_run["losses"] == losses
    assert sess.accountant.contributions == oracle.accountant.contributions
    assert sess.epsilon() == oracle.epsilon()


def test_chaos_journal_through_jax_step_loop(jax_init, chaos_run):
    """The port chaos run's realized sets, replayed as scheduled elastic
    rounds through JAX's serial ``step`` loop from the same weights."""
    journal = chaos_run["journal"]
    js, jp, jg, ju = jax_session(jax_init, n=N_CHAOS)
    jp, jl = _replay(js, jp, jg, ju, journal)
    err = {}
    for k, v in chaos_run["params"].items():
        layer, leaf = k.split(".")
        err[k] = np.abs(v.numpy() - np.asarray(jp[layer][leaf]))
    assert max(e.max() for e in err.values()) <= FLIP_ATOL
    units = _flip_cover(err, chaos_param_atol(ROUNDS_CHAOS), FLIP_UNITS)
    assert units is not None, {k: int((e > chaos_param_atol(ROUNDS_CHAOS))
                                      .sum()) for k, e in err.items()}
    np.testing.assert_allclose(chaos_run["losses"], jl, rtol=LOSS_RTOL)
    assert chaos_run["sess"].accountant.contributions == \
        js.accountant.contributions
    assert chaos_run["sess"].epsilon() == js.epsilon()


def test_hang_past_deadline_closes_without_the_silo(jax_init):
    """A silo that hangs past the deadline (round 1 of 4, 4 silos, quorum
    3; the deadline from a warm round, the hang twice it): the round closes
    at the quorum without it, counts a deadline hit and penalizes it in the
    telemetry; its worker finishes after the round committed and its result
    is discarded; it is not rejoined while that worker runs; and the run is
    bit-equal to the elastic oracle of its realized sets."""
    n, rounds, quorum, hung = 4, 4, 3, 2
    warm, params, grad_fn, update_fn = port_session(jax_init, n=n)
    warm.step(0, params, grad_fn, update_fn, LR)
    deadline = max(0.15, 10 * max(warm.telemetry.snapshot().values()))
    inj = FaultInjector(FaultPlan(seed=0, n_silos=n, n_rounds=rounds,
                                  events=[FaultEvent(1, HANG, hung,
                                                     2 * deadline)]))
    sess, params, grad_fn, update_fn = port_session(jax_init, n=n)
    spans, rejoins, commits, penalties, held = [], [], {}, [], []
    compute_one, rejoin_downed = sess._compute_one, sess._rejoin_downed
    rejoin_async, penalize = sess.rejoin_silo_async, sess.telemetry.penalize

    def timed_compute(h, *a):
        t0 = time.perf_counter()
        try:
            return compute_one(h, *a)
        finally:
            spans.append((h.silo_idx, t0, time.perf_counter()))

    def spied_rejoin_downed(t, rejoin_after):
        fut = sess._inflight.get(hung)
        rejoin_downed(t, rejoin_after)
        if fut is not None and not fut.done():  # running through the check
            held.append((t, hung in sess._downed))

    def timed_rejoin(silo):
        rejoins.append((silo, time.perf_counter()))
        return rejoin_async(silo)

    sess._compute_one, sess._rejoin_downed = timed_compute, \
        spied_rejoin_downed
    sess.rejoin_silo_async = timed_rejoin
    sess.telemetry.penalize = lambda silo, d: (penalties.append((silo, d)),
                                               penalize(silo, d))
    journal = RoundJournal()
    commit = journal.commit
    journal.commit = lambda t, *a, **kw: (commits.__setitem__(
        t, time.perf_counter()), commit(t, *a, **kw))
    params, losses = sess.run(params, grad_fn, update_fn, LR, rounds,
                              round_timeout_s=deadline, quorum=quorum,
                              chaos=inj, journal=journal, rejoin_after=1)
    assert inj.fired == {HANG: 1} and journal.rounds_done == rounds
    assert not journal.rounds[1]["active"][hung]
    assert sess.accountant.contributions[1] == n - 1
    assert sess.fault_stats["deadline_hits"] >= 1
    assert (hung, deadline) in penalties
    # the hung worker was still computing when round 1 committed
    assert any(s == hung and t0 < commits[1] < t1 for s, t0, t1 in spans)
    # round 2 found it running and left the silo down; no rejoin of a
    # silo overlapped its own compute
    assert held and all(down for _, down in held)
    assert not any(s == r and t0 < tr < t1
                   for r, tr in rejoins for s, t0, t1 in spans)
    oracle, oparams, grad_fn, update_fn = port_session(jax_init, n=n)
    oparams, olosses = _replay(oracle, oparams, grad_fn, update_fn, journal)
    np.testing.assert_array_equal(_bits(params), _bits(oparams))
    assert losses == olosses
    assert sess.accountant.contributions == oracle.accountant.contributions


# ---------------------------------------------------------------------------
# inside the port: resume and the fault-free tolerant run, bit for bit


def test_journal_resume_after_driver_restart_bit_identical(jax_init,
                                                           tmp_path):
    """Stop the driver after 2 of 4 chaos rounds (no deadline: a crash in
    round 1, a corrupted blob in round 3, KDS denials at the rejoins, no
    hangs), rebuild a fresh session from the journal on disk and go on: the
    params are bit-equal to a driver that never stopped, round for round
    the same sets."""
    n, rounds, cut = 4, 4, 2
    plan = FaultPlan.from_seed(7, n, rounds, quorum=2, hang_rate=0.0)
    ref, params, grad_fn, update_fn = port_session(jax_init, n=n)
    ref_journal = RoundJournal()
    ref_params, ref_losses = ref.run(params, grad_fn, update_fn, LR, rounds,
                                     quorum=2, chaos=FaultInjector(plan),
                                     journal=ref_journal)
    path = str(tmp_path / "rounds.journal")
    sess, params, grad_fn, update_fn = port_session(jax_init, n=n)
    inj = FaultInjector(plan)  # the world's fault schedule, not the driver's
    _, losses = sess.run(params, grad_fn, update_fn, LR, cut, quorum=2,
                         chaos=inj, journal=RoundJournal(path=path))
    del sess  # the driver stops here
    sess2, _, grad_fn, update_fn = port_session(jax_init, n=n)
    journal = RoundJournal.load(path)
    params2 = sess2.resume(journal)
    assert sess2._next_round == cut
    assert params2["l0.w"].device == torch.device("cpu")
    params2, losses2 = sess2.run(params2, grad_fn, update_fn, LR,
                                 rounds - cut, quorum=2, chaos=inj,
                                 journal=journal)
    assert inj.fired and journal.rounds == ref_journal.rounds
    np.testing.assert_array_equal(_bits(params2), _bits(ref_params))
    assert losses + losses2 == ref_losses
    assert sess2.accountant.contributions == ref.accountant.contributions
    assert sess2.epsilon() == ref.epsilon()


def test_fault_free_tolerant_run_matches_serial_loop(jax_init):
    """The tolerant collect (every handler at once on a worker thread, the
    round closed at a quorum and a deadline) with nothing failing gives
    the serial ``step`` loop's params, losses and bytes on the wire."""
    sa, params, grad_fn, update_fn = port_session(jax_init)
    pa, la = sa.run(params, grad_fn, update_fn, LR, 3, pipelined=False)
    sb, params, _, _ = port_session(jax_init)
    journal = RoundJournal()
    pb, lb = sb.run(params, grad_fn, update_fn, LR, 3, round_timeout_s=60.0,
                    quorum=4, journal=journal)
    np.testing.assert_array_equal(_bits(pa), _bits(pb))
    assert la == lb and sa.wire_stats == sb.wire_stats
    assert sb.fault_stats["rounds_replayed"] == 0
    assert sb.membership.min_active == 1  # the run's quorum floor restored
    assert [r["active"] for r in journal.rounds] == [[True] * 4] * 3
    np.testing.assert_array_equal(
        _bits(wire.decode_tree(journal.params_blob)), _bits(pb))


# ---------------------------------------------------------------------------
# behaviour as in JAX


def test_corruption_fails_closed_attributed_never_retried(jax_init):
    plan = FaultPlan(seed=0, n_silos=4, n_rounds=2,
                     events=[FaultEvent(0, CORRUPT, 2, 3.0)])
    sess, params, grad_fn, update_fn = port_session(jax_init)
    journal = RoundJournal()
    sess.run(params, grad_fn, update_fn, LR, 2, quorum=2,
             chaos=FaultInjector(plan), journal=journal, rejoin_after=None)
    fails = sess.fault_stats["integrity_failures"]
    assert len(fails) == 1 and fails[0]["silo"] == "handler-2"
    assert fails[0]["round"] == 0 and "Merkle" in fails[0]["error"]
    assert sess.fault_stats["transient_retries"] == 0  # never retried
    assert journal.rounds[0]["active"] == [True, True, False, True]
    assert sess.accountant.contributions[0] == 3  # the offender not counted
    assert 2 in sess._downed


def test_pipelined_ingest_failure_kills_run_promptly(jax_init):
    sess, params, grad_fn, update_fn = port_session(jax_init)
    calls = {"grad": 0}

    def counting_grad(p, data):
        calls["grad"] += 1
        return grad_fn(p, data)

    def boom(rs, name, blob):
        raise ValueError("injected ingest failure")

    sess.updater.ingest = boom
    with pytest.raises((RuntimeError, ValueError)) as ei:
        sess.run(params, counting_grad, update_fn, LR, 3, pipelined=True)
    root = ei.value.__cause__ or ei.value
    assert "injected ingest failure" in str(root)
    assert calls["grad"] <= 4  # round 0 at most


def test_received_cap_truncates_audit_trail_with_counter(jax_init):
    sess, params, grad_fn, update_fn = port_session(jax_init,
                                                    received_cap=3)
    assert sess.updater.received_cap == 3
    sess.step(0, params, grad_fn, update_fn, LR)
    assert len(sess.updater.received_updates) == 3
    assert sess.updater.truncated_entries == 1
    dflt, *_ = port_session(jax_init, batch_mac=False)
    assert dflt.updater.received_cap == 256 and not dflt.batch_mac


def test_rejoin_async_retries_transient_kds_denial(jax_init):
    sess, params, grad_fn, update_fn = port_session(jax_init)
    params, _ = sess.step(0, params, grad_fn, update_fn, LR)
    assert sess.drop_silo(1, step=1)
    params, _ = sess.step(1, params, grad_fn, update_fn, LR)
    inj = FaultInjector(FaultPlan(seed=0, n_silos=4, n_rounds=1,
                                  events=[FaultEvent(0, KDS_DENY, None,
                                                     1.0)]))
    inj.arm_kds(0)
    sess.service.kds.fault_hook = inj.kds_fault
    try:
        before = sum(e["action"] == "rejoin" for e in sess.membership.events)
        resync = sess.wire_stats["resync_bytes"]
        assert sess.rejoin_silo_async(1)  # denied once, then released
    finally:
        sess.service.kds.fault_hook = None
    assert sess.fault_stats["kds_retries"] == 1
    assert inj.fired["kds_denied"] == 1
    assert sum(e["action"] == "rejoin"
               for e in sess.membership.events) - before == 1
    assert sess.wire_stats["resync_bytes"] > resync  # warm resync, now
    assert sess.handlers[1]._params_epoch == sess._bcast_epoch
    params, _ = sess.step(2, params, grad_fn, update_fn, LR)
    assert sess.accountant.contributions[-1] == 4
    # the warm resync chained: round 2's delta needed no second resync
    assert sess.handlers[1]._params_epoch == sess._bcast_epoch


def test_budget_excluded_silo_still_fails_closed_on_rejoin(jax_init):
    sess, params, grad_fn, update_fn = port_session(jax_init)
    sess.step(0, params, grad_fn, update_fn, LR)
    sess.membership.exclude(1, step=1, reason="budget")
    resync = sess.wire_stats["resync_bytes"]
    log = len(sess.service.kds.audit_log)
    assert not sess.rejoin_silo_async(1)
    assert sess.wire_stats["resync_bytes"] == resync
    assert len(sess.service.kds.audit_log) == log  # no KDS traffic
    assert not bool(sess.membership.active_at(2)[1])
    assert sess.membership.events[-1]["action"] == "rejoin_refused"
