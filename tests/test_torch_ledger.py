"""The port's privacy accounting and host-side policies against the JAX
package on the same inputs: every closed-form bound on a grid of arguments
(``==``: the same float operations in the same order), the per-silo ledger
over one seeded sequence of participation masks in the analytic and RDP
modes with budgets (epsilons, verdicts, exclusions, events, spend report
and state dict equal), state dicts crossing both ways (the legacy
``PrivacyAccountant`` one too), the data pipeline's index sequences and
resume, ``plan_mesh`` and ``resume_plan``, ``StragglerPolicy`` and
``SiloMembership`` event for event. Pure Python and numpy on both sides:
no tolerance anywhere."""
import copy
import json
import math

import numpy as np
import pytest

from repro.core import accountant as jacc
from repro.core.privacy import PrivacyAccountant as JaxAccountant
from repro.core.privacy import PrivacyLedger as JaxLedger
from repro.data import pipeline as jpipe
from repro.data.synthetic import ArrayDataset as JaxArrayDataset
from repro.runtime import elastic as jel
from repro.runtime import straggler as jstr
from repro_torch.core import accountant as tacc
from repro_torch.core.privacy import PrivacyAccountant, PrivacyLedger
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import ArrayDataset
from repro_torch.runtime import elastic as tel
from repro_torch.runtime import straggler as tstr

EPS = [0.0, 0.3, 1.0, 4.0, 12.0]
SIGMAS = [0.3, 0.7, 1.5, 4.0]
DELTAS = [1e-5, 1e-3]
STEPS = [1, 3, 50]
LAMS = [0.0, 0.3, 0.7]
QS = [0.0, 0.01, 0.1, 1.0]

GRIDS = {
    "_phi": [(x,) for x in (-3.0, -0.5, 0.0, 0.2, 2.5)],
    "gaussian_delta": [(e, s, d) for e in EPS for s in SIGMAS
                       for d in (0.5, 1.0, 3.0)],
    "gaussian_eps": [(d, s) for d in DELTAS for s in SIGMAS],
    "composed_delta": [(e, s, t) for e in EPS for s in SIGMAS for t in STEPS],
    "composed_eps": [(d, s, t) for d in DELTAS for s in SIGMAS
                     for t in STEPS],
    "corrected_delta": [(e, s, t, lam) for e in EPS[1:] for s in SIGMAS
                        for t in STEPS for lam in LAMS],
    "calibrate_sigma": [(e, d, t) for e in (0.5, 2.0, 8.0) for d in DELTAS
                        for t in (1, 10)],
    "sequence_sensitivity": [(n, lam) for n in (1, 2, 5, 40) for lam in LAMS],
    "sequence_eps": [(d, s, n, lam) for d in DELTAS for s in (0.7, 2.0)
                     for n in (1, 4, 16) for lam in LAMS],
    "_log_comb": [(n, k) for n in (2, 10, 63) for k in range(0, n + 1, 3)],
    "rdp_gaussian": [(a, s) for a in (1.5, 2, 32) for s in SIGMAS],
    "rdp_subsampled_gaussian": [(a, s, q) for a in (2, 5, 31, 255)
                                for s in (0.7, 1.5, 4.0) for q in QS],
    "rdp_to_eps": [(r, a, d) for r in (0.01, 0.5, 7.0)
                   for a in (1.0, 1.5, 2, 64) for d in DELTAS],
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_bounds_equal_jax(name):
    """Every function of ``core/privacy/bounds.py`` (through the
    ``core/accountant.py`` shims, which re-export them) gives JAX's float
    on each grid point, bit for bit."""
    port, ref = getattr(tacc, name), getattr(jacc, name)
    for args in GRIDS[name]:
        got, want = port(*args), ref(*args)
        assert got == want or (math.isnan(got) and math.isnan(want)), \
            (name, args, got, want)
    assert tacc.DEFAULT_ORDERS == jacc.DEFAULT_ORDERS


def test_calibrate_sigma_refusal_equal_jax():
    for lib in (tacc, jacc):
        with pytest.raises(ValueError, match="calibrate"):
            lib.calibrate_sigma(1e-9, 1e-300, 10 ** 8)
    for lib in (tacc, jacc):
        with pytest.raises(ValueError, match="lambda"):
            lib.corrected_delta(1.0, 1.0, 1, 1.0)


def _masks(seed: int, steps: int, n: int) -> list:
    """One seeded participation sequence: mostly full, some partial, one
    empty step (the ledger records it; no silo is charged)."""
    rng = np.random.default_rng(seed)
    out = [rng.random(n) < 0.75 for _ in range(steps)]
    out[3] = np.zeros(n, bool)
    return out


LEDGER_CASES = {
    "analytic": dict(sigma=0.9, delta=1e-5, n_silos=5, lam=0.3,
                     epsilon_budget=9.0, budgets={1: 4.0, 4: 6.5}),
    "rdp": dict(sigma=1.2, delta=1e-5, n_silos=5, lam=0.3, q=0.2,
                mode="rdp", epsilon_budget=2.5, budgets={2: 1.5}),
}


def _drive(ledger_cls, case: str, steps: int = 24) -> tuple:
    """The ledger after the mask sequence, and what was read each step."""
    led = ledger_cls(**copy.deepcopy(LEDGER_CASES[case]))
    trace = []
    for t, mask in enumerate(_masks(7, steps, led.n_silos)):
        led.record(mask if t % 5 else mask.tolist())
        trace.append((led.epsilon(), led.epsilon_per_silo(),
                      led.allowed_mask().tolist(), led.take_exclusions(),
                      led.exhausted(), led.spent(1)))
        if t == 15:
            led.budgets[1] = 100.0  # an operator raise re-admits silo 1
    return led, trace


def _json(d) -> str:
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_ledger_equals_jax(case):
    """One seeded participation sequence with budgets (and a budget raise)
    through both ledgers: each step's global and per-silo epsilon,
    verdicts and exclusions, and at the end the events, the participation
    matrix, the spend report and the state dict (as JSON) are equal."""
    led, trace = _drive(PrivacyLedger, case)
    jled, jtrace = _drive(JaxLedger, case)
    assert trace == jtrace
    assert any(t[3] for t in trace)  # budgets fired
    assert led.events == jled.events and led.contributions == \
        jled.contributions
    np.testing.assert_array_equal(led.participation(), jled.participation())
    assert [led.silo_steps(i) for i in range(5)] == \
        [jled.silo_steps(i) for i in range(5)]
    assert _json(led.spend_report({0: 0.25, 3: 0.5})) == \
        _json(jled.spend_report({0: 0.25, 3: 0.5}))
    assert _json(led.config_dict()) == _json(jled.config_dict())
    assert _json(led.state_dict()) == _json(jled.state_dict())
    led.step(2)  # the legacy count-only path
    jled.step(2)
    assert _json(led.state_dict()) == _json(jled.state_dict())


def test_from_privacy_config_equal_jax():
    from repro.configs.base import PrivacyConfig as JaxPrivacy
    from repro_torch.configs.base import PrivacyConfig

    kw = dict(sigma=0.6, noise_lambda=0.5, delta=1e-6)
    for mode, q in (("analytic", 1.0), ("rdp", 0.05)):
        a = PrivacyLedger.from_privacy_config(
            PrivacyConfig(**kw), 3, epsilon_budget=2.0, budgets={0: 1.0},
            q=q, mode=mode)
        b = JaxLedger.from_privacy_config(
            JaxPrivacy(**kw), 3, epsilon_budget=2.0, budgets={0: 1.0},
            q=q, mode=mode)
        for _ in range(3):
            a.record([True, False, True])
            b.record([True, False, True])
        assert _json(a.state_dict()) == _json(b.state_dict())
        assert a.epsilon_per_silo() == b.epsilon_per_silo()


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_state_dict_crosses_both_ways(case):
    """The port restores JAX's state dict and JAX the port's (through
    JSON, as a checkpoint's manifest carries it); both go on recording the
    same masks to the same ledger."""
    led, _ = _drive(PrivacyLedger, case, steps=12)
    jled, _ = _drive(JaxLedger, case, steps=12)
    from_jax = PrivacyLedger.from_state_dict(
        json.loads(_json(jled.state_dict())), n_silos=5)
    from_port = JaxLedger.from_state_dict(
        json.loads(_json(led.state_dict())), n_silos=5)
    for mask in _masks(8, 6, 5):
        for x in (led, jled, from_jax, from_port):
            x.record(mask)
    want = _json(jled.state_dict())
    for x in (led, from_jax, from_port):
        assert _json(x.state_dict()) == want
    assert from_jax.take_exclusions() == from_port.take_exclusions()


@pytest.mark.parametrize("mode", ["analytic", "rdp"])
def test_legacy_accountant_restores_the_same(mode):
    """A scalar ``PrivacyAccountant``'s dict maps to an all-silos-identical
    ledger in both packages; the accountants themselves agree too."""
    kw = dict(sigma=2.0, delta=1e-5, lam=0.5, q=0.1, mode=mode)
    acc, jac = PrivacyAccountant(**kw), JaxAccountant(**kw)
    for a in (acc, jac):
        a.step(30, contributions=4)
        a.step(2)
    assert acc.epsilon() == jac.epsilon() and acc.spent() == jac.spent()
    assert _json(acc.state_dict()) == _json(jac.state_dict())
    back = PrivacyAccountant.from_state_dict(
        json.loads(_json(jac.state_dict())))
    assert _json(back.state_dict()) == _json(jac.state_dict())
    led = PrivacyLedger.from_state_dict(acc.state_dict(), n_silos=5)
    jled = JaxLedger.from_state_dict(jac.state_dict(), n_silos=5)
    assert led.epsilon() == acc.epsilon()
    assert all(led.epsilon(i) == acc.epsilon() for i in range(5))
    for x in (led, jled):
        x.record(np.array([True] + [False] * 4))
    assert led.silo_steps(0) == 33 and led.silo_steps(1) == 32
    assert _json(led.state_dict()) == _json(jled.state_dict())
    assert led.events == jled.events


def test_changed_silo_count_raises_in_both():
    led, _ = _drive(PrivacyLedger, "analytic", steps=4)
    d = json.loads(_json(led.state_dict()))
    for cls in (PrivacyLedger, JaxLedger):
        with pytest.raises(ValueError, match="silo-count change"):
            cls.from_state_dict(d, n_silos=4)
        assert cls.from_state_dict(d).n_silos == 5  # unchecked without one


# ---------------------------------------------------------------------------
# the data pipeline (tests/test_runtime.py:94-114)


def _data(cls, n=100):
    return cls(np.arange(n, dtype=np.float32)[:, None],
               np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("n,batch", [(100, 10), (37, 8), (5, 8)])
def test_silo_iterator_equals_jax_and_resumes(n, batch):
    """The same index sequences as JAX's (wrap-around and a batch larger
    than the shard included), and a restored iterator reproduces them."""
    it = tpipe.SiloIterator(_data(ArrayDataset, n), batch=batch, seed=3)
    jit_ = jpipe.SiloIterator(_data(JaxArrayDataset, n), batch=batch, seed=3)
    seq = [it.next()["y"].tolist() for _ in range(12)]
    assert seq == [jit_.next()["y"].tolist() for _ in range(12)]
    assert it.state_dict() == jit_.state_dict()
    it2 = tpipe.SiloIterator(_data(ArrayDataset, n), batch=batch, seed=3)
    for _ in range(5):
        it2.next()
    it3 = tpipe.SiloIterator(_data(ArrayDataset, n), batch=batch, seed=0)
    it3.load_state_dict(it2.state_dict())
    assert [it3.next()["y"].tolist() for _ in range(7)] == seq[5:]


def test_federated_batcher_equals_jax_and_resumes():
    silos = _data(ArrayDataset, 64).split(4)
    jsilos = _data(JaxArrayDataset, 64).split(4)
    fb = tpipe.FederatedBatcher(silos, per_silo_batch=3, seed=2)
    jfb = jpipe.FederatedBatcher(jsilos, per_silo_batch=3, seed=2)
    for _ in range(9):
        b, jb = fb.next(), jfb.next()
        assert b["x"].shape == (12, 1)
        for k in ("x", "y"):
            np.testing.assert_array_equal(b[k], jb[k])
    assert fb.state_dict() == jfb.state_dict()
    fb2 = tpipe.FederatedBatcher(silos, per_silo_batch=3, seed=2)
    fb2.load_state_dict(json.loads(json.dumps(jfb.state_dict())))
    np.testing.assert_array_equal(fb2.next()["y"], jfb.next()["y"])


# ---------------------------------------------------------------------------
# device elasticity (tests/test_server_elastic.py:77-110)


def test_plan_mesh_equals_jax():
    seen_degraded = seen_none = 0
    for pods in (1, 2, 4):
        for mp in (1, 4, 8, 16):
            for n in (0, 1, 3, 7, 12, 16, 31, 64, 240, 250, 480, 512, 1000):
                p, q = tel.plan_mesh(n, mp, pods), jel.plan_mesh(n, mp, pods)
                if q is None:
                    assert p is None
                    seen_none += 1
                    continue
                assert (p.mesh.shape, p.mesh.axes, p.dropped_devices,
                        p.note) == (q.mesh.shape, q.mesh.axes,
                                    q.dropped_devices, q.note)
                seen_degraded += "degraded" in p.note
    assert seen_degraded and seen_none
    assert tel.plan_mesh(240, model_parallel=16).mesh.shape == (15, 16)
    assert tel.plan_mesh(480, model_parallel=16, pods=2).mesh.shape == \
        (2, 15, 16)


def test_resume_plan_round_trip(tmp_path):
    """A checkpoint written under one plan restores under another, the
    accountant riding along in ``extra``; ``shardings`` is ignored."""
    import torch

    from repro_torch.checkpoint import checkpointer

    tree = {"w": torch.arange(8.0)}
    acc = PrivacyAccountant(sigma=2.0, delta=1e-5)
    acc.step(10)
    checkpointer.save(tmp_path, 10, tree,
                      extra={"accountant": acc.state_dict()})
    plan = tel.plan_mesh(240, model_parallel=16)
    restored, extra, step = tel.resume_plan(str(tmp_path), tree, plan,
                                            shardings={"w": "ignored"})
    assert step == 10 and torch.equal(restored["w"], tree["w"])
    acc2 = PrivacyAccountant.from_state_dict(extra["accountant"])
    assert acc2.steps == 10 and acc2.epsilon() == acc.epsilon()


# ---------------------------------------------------------------------------
# the straggler policy and silo membership, event for event


def _observe(policy_cls, deadline, seq, calib=()):
    events = []
    p = policy_cls(deadline, ema_factor=2.0, on_escalate=events.append)
    flags = []
    for i, (t, upd) in enumerate(seq):
        if i in calib:
            p.calibrate(calib[i])
        flags.append(p.observe(t, update_baseline=upd))
    return flags, p.events, events, p._ema, p.calibrated


@pytest.mark.parametrize("deadline", [None, 1.0])
def test_straggler_policy_equals_jax(deadline):
    rng = np.random.default_rng(4)
    times = rng.choice([0.2, 0.5, 0.9, 3.0, 9.0], 60, p=[.3, .3, .2, .1, .1])
    times[20:24] = times[45:48] = 50.0  # stalls long enough to escalate
    seq = [(float(t), bool(u)) for t, u in zip(times, rng.random(60) < 0.7)]
    calib = {0: 0.4, 17: 0.6, 40: 2.0}
    got = _observe(tstr.StragglerPolicy, deadline, seq, calib)
    want = _observe(jstr.StragglerPolicy, deadline, seq, calib)
    assert got == want
    assert any(e.get("action") == "reschedule" for e in got[1])


def test_membership_and_drop_one_equal_jax():
    def drive(mod, straggler):
        tel_ = straggler.SiloTelemetry(5)
        m = mod.SiloMembership(5, min_active=2, cooldown_steps=3)
        picks = []
        for step, obs in enumerate([[0.1, 0.9, 0.1, 0.2, 0.1],
                                    [0.1, 0.1, 2.0, 0.2, 0.1],
                                    [0.1, 0.1, 0.1, 0.1, 0.1]] * 3):
            tel_.observe_all(obs)
            if step in (0, 1, 4, 5, 6):
                picks.append(m.drop_one(step, telemetry=tel_))
            if step == 2:
                m.exclude(4, step=step)
                picks.append(m.rejoin(4, step=step))
            if step == 7:
                picks.append(m.rejoin(4, step=step, override=True))
            picks.append(m.active_at(step).tolist())
        tel_.penalize(3, 0.5)
        return picks, m.events, m.excluded, tel_.snapshot()

    assert drive(tel, tstr) == drive(jel, jstr)
