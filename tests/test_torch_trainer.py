"""The port's Trainer (``repro_torch/runtime/trainer.py``) against the JAX
package's at the qwen2.5-3b smoke config with the quickstart's privacy
settings (4 silos, sigma 0.3, dynamic clipping, lambda 0.7) and AdamW lr
1e-3, the JAX weights carried across, a ``FederatedBatcher`` over
synthetic token rows as ``batch_state``, 6 steps and ``checkpoint_every=3``:

* the port against JAX: losses, clip bounds and contributions within the
  training slice's RTOL (``tests/test_torch_training.py``), epsilon equal,
  parameters within PARAM_ATOL;
* the port resumed from its own step-3 checkpoint equals the port
  uninterrupted bit for bit, and so does a run preempted by SIGTERM;
* the port resumed from JAX's step-3 checkpoint directory matches JAX's
  own resumed run;
* per-silo budgets (``tests/test_privacy_ledger.py:157-272``): exclusion
  the next step, the stop when every budget is spent, budgets carried only
  by a checkpoint, the barrier tier's perleaf policy refused with budgets
  at build and at restore;
* elastic: an escalation drops the slowest silo with JAX's membership
  events, and the participation sets of a run match JAX's;
* the unported-path cases of ``Session.train`` and the CLI train to a
  finite loss (those tests live in ``test_torch_training.py`` and
  ``test_torch_launch_train.py``).

JAX's Trainer pays a jit compile per run, so its runs are shared through
module-scoped fixtures."""
import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro.core.privacy import PrivacyAccountant as JaxAccountant
from repro.data.pipeline import FederatedBatcher as JaxBatcher
from repro.data.synthetic import ArrayDataset as JaxArrayDataset
from repro.distributed import steps as jsteps
from repro.runtime.trainer import Trainer as JaxTrainer
from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.api import Session
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                      PrivacyConfig)
from repro_torch.core import prng
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.synthetic import ArrayDataset, synthetic_tokens
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.runtime.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2.5-3b"
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4)
LR = 1e-3
RTOL = 1e-5        # tests/test_torch_training.py: loss, bound, norms
PARAM_ATOL = 1e-5  # tests/test_torch_training.py: parameters
STEPS, EVERY, SEQ, PER_SILO = 6, 3, 16, 4
TOKENS = synthetic_tokens(32, SEQ, get_smoke_config(ARCH).vocab_size, seed=5)


@pytest.fixture(scope="module")
def weights():
    model = transformer.init(torch.Generator().manual_seed(0),
                             get_smoke_config(ARCH), "cpu")
    return params_to_numpy(model)


def _port(weights, total, ckpt=None, priv=None, mesh=None, sigterm_at=None,
          **tk):
    """The port's Trainer over a fresh session and state from ``weights``;
    ``sigterm_at`` sends SIGTERM from inside that next_batch call."""
    sess = Session.from_config(
        ARCH, device="cpu", mesh=mesh,
        privacy=PrivacyConfig(**{**QUICKSTART, **(priv or {})}),
        optimizer=OptimizerConfig(name="adamw", lr=LR))
    fb = FederatedBatcher(ArrayDataset(TOKENS[:, :-1], TOKENS[:, 1:])
                          .split(4), per_silo_batch=PER_SILO)
    calls = [0]

    def next_batch():
        if calls[0] == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        calls[0] += 1
        b = fb.next()
        return {"tokens": torch.as_tensor(b["x"], dtype=torch.long),
                "labels": torch.as_tensor(b["y"], dtype=torch.long)}

    tr = Trainer(sess.model, sess.run_cfg, TrainerConfig(
        total_steps=total, checkpoint_every=EVERY, log_every=0,
        checkpoint_dir=None if ckpt is None else str(ckpt), **tk),
        next_batch, batch_state=fb)
    state = sess.init_state(params=params_from_jax(weights, sess.cfg, "cpu"))
    old = tr.install_preemption_handler()
    try:
        state, step = tr.fit(state, prng.PRNGKey(1))
    finally:
        signal.signal(signal.SIGTERM, old)
    return tr, state, step


def _jax(weights, total, ckpt=None, **tk):
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**QUICKSTART),
                                optimizer=JaxOptimizer(name="adamw", lr=LR))
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, weights))
    state = jsteps.init_train_state(jmodel, js.run_cfg, jax.random.PRNGKey(0))
    fb = JaxBatcher(JaxArrayDataset(TOKENS[:, :-1], TOKENS[:, 1:]).split(4),
                    per_silo_batch=PER_SILO)

    def next_batch():
        b = fb.next()
        return {"tokens": jnp.asarray(b["x"]), "labels": jnp.asarray(b["y"])}

    tr = JaxTrainer(js.model, js.run_cfg, JaxTrainerConfig(
        total_steps=total, checkpoint_every=EVERY, log_every=0,
        checkpoint_dir=None if ckpt is None else str(ckpt), **tk),
        next_batch, batch_state=fb)
    state, step = tr.fit(state, jax.random.PRNGKey(1))
    tr._flush_metrics()
    return tr, state, step


def _only_step(src, dst, step: int):
    """A copy of checkpoint directory ``src`` holding only ``step``."""
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / name)
    return dst


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """JAX: 6 steps checkpointing at 3 and 6, and its own resume from step
    3. The port: 6 steps, 3 steps then a resume to 6 (fresh Trainer), and
    the resume from JAX's step-3 checkpoint."""
    root = tmp_path_factory.mktemp("trainer")
    jax_full = _jax(weights, STEPS, root / "jax")
    jax_resumed = _jax(weights, STEPS, _only_step(root / "jax",
                                                  root / "jax3", EVERY))
    port_full = _port(weights, STEPS)
    _port(weights, EVERY, root / "port")
    port_resumed = _port(weights, STEPS, root / "port")
    from_jax = _port(weights, STEPS, _only_step(root / "jax",
                                                root / "jax3p", EVERY))
    return dict(jax_full=jax_full, jax_resumed=jax_resumed,
                port_full=port_full, port_resumed=port_resumed,
                from_jax=from_jax, root=root)


def _hold_to_jax(port, ref, first: int = 0):
    (tr, state, step), (jtr, jstate, jstep) = port, ref
    assert step == jstep == STEPS
    tm, jm = tr.metrics_log, jtr.metrics_log
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == \
        list(range(STEPS))
    for a, b in zip(tm[first:], jm[first:]):
        for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL)
        assert a["epsilon"] == b["epsilon"]
        assert a["epsilon_per_silo"] == b["epsilon_per_silo"]
    want = np.asarray(jflat.pack(jflat.layout_of(jstate.params),
                                 jstate.params))
    got = state.opt_state["master"].numpy()
    assert np.abs(got - want).max() <= PARAM_ATOL
    assert state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jstate.noise_state.prev_key))
    assert json.dumps(tr.accountant.state_dict(), sort_keys=True) == \
        json.dumps(jtr.accountant.state_dict(), sort_keys=True)


def test_trainer_matches_jax(runs):
    _hold_to_jax(runs["port_full"], runs["jax_full"])
    tr = runs["port_full"][0]
    assert len(tr.stage_log) == STEPS and tr.checkpoint_log == []


def _bit_equal(a, b):
    (ta, sa, _), (tb, sb, _) = a, b
    for k in ("master", "m", "v"):
        assert torch.equal(sa.opt_state[k], sb.opt_state[k]), k
    assert sa.opt_state["count"] == sb.opt_state["count"] == STEPS
    assert torch.equal(sa.clip_bound, sb.clip_bound)
    assert sa.noise_state.prev_key == sb.noise_state.prev_key
    assert sa.noise_state.has_prev == sb.noise_state.has_prev
    np.testing.assert_array_equal(sa.noise_state.prev_active,
                                  sb.noise_state.prev_active)
    assert [m["loss"] for m in ta.metrics_log] == \
        [m["loss"] for m in tb.metrics_log]
    assert json.dumps(ta.accountant.state_dict()) == \
        json.dumps(tb.accountant.state_dict())


def test_resumed_equals_uninterrupted_bit_for_bit(runs):
    tr = runs["port_resumed"][0]
    assert tr.restored_step == EVERY
    # as JAX's loop: a save at step 6 by the cadence, and one at the end
    assert [(e["op"], e["step"]) for e in tr.checkpoint_log] == \
        [("restore", 3), ("save", 6), ("save", 6)]
    _bit_equal(runs["port_resumed"], runs["port_full"])
    # the restored run kept its buffers: the parameters view master
    state = runs["port_resumed"][1]
    base = state.opt_state["master"].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base
               for p in state.params.parameters())


def test_port_resumes_from_jax_checkpoint(runs):
    """From JAX's step-3 checkpoint: the metrics history comes from it, and
    steps 3-5 match JAX's own resumed run."""
    assert runs["from_jax"][0].restored_step == EVERY
    assert runs["jax_resumed"][0].metrics_log[:EVERY] == \
        runs["from_jax"][0].metrics_log[:EVERY]
    _hold_to_jax(runs["from_jax"], runs["jax_resumed"], first=EVERY)


def test_sigterm_preemption_resumes_bit_for_bit(runs, weights):
    """SIGTERM inside step 4's next_batch: that step completes, the loop
    saves at step 5 and returns; a fresh Trainer resumes there and ends
    bit-equal to the uninterrupted run."""
    d = runs["root"] / "preempt"
    tr, _, step = _port(weights, STEPS, d, sigterm_at=4)
    assert step == 5 and checkpointer.latest_step(d) == 5
    assert tr.checkpoint_log[-1]["op"] == "save"
    resumed = _port(weights, STEPS, d)
    assert resumed[0].restored_step == 5
    _bit_equal(resumed, runs["port_full"])


# ---------------------------------------------------------------------------
# per-silo budgets (tests/test_privacy_ledger.py:157-272, on the dense
# smoke config: the Trainer cannot take a SmallModel yet)


def _budget_run(weights, total, ckpt=None, **tk):
    priv = dict(sigma=0.5, dynamic_clip=False, noise_lambda=0.0)
    return _port(weights, total, ckpt, priv=priv, **tk)


def test_trainer_excludes_exhausted_silo_next_step(weights):
    tr, _, step = _budget_run(weights, 3, silo_budgets={1: 0.001})
    assert step == 3
    assert [m["n_contributions"] for m in tr.metrics_log] == [4.0, 3.0, 3.0]
    assert tr.membership is not None and tr.membership.excluded == (1,)
    assert tr.accountant.silo_steps(1) == 1
    assert tr.accountant.epsilon(1) < tr.accountant.epsilon(0)
    per_silo = tr.metrics_log[-1]["epsilon_per_silo"]
    assert per_silo[1] < per_silo[0]
    assert [e["action"] for e in tr.membership.events] == ["exclude"]


def test_trainer_stops_when_all_budgets_spent(weights):
    tr, _, step = _budget_run(weights, 100, silo_epsilon_budget=0.001)
    assert step == 1
    assert all(tr.accountant.silo_exhausted(i) for i in range(4))
    assert tr.spend_report()["silos"][0]["exhausted"]


def test_budgets_survive_a_restart(weights, tmp_path):
    """Exclusion survives the restart; a resume without budget flags keeps
    enforcing the checkpointed budgets."""
    tr, _, _ = _budget_run(weights, 4, tmp_path / "a",
                           silo_budgets={2: 0.001})
    tr2, _, step2 = _budget_run(weights, 6, tmp_path / "a",
                                silo_budgets={2: 0.001})
    led, led2 = tr.accountant, tr2.accountant
    assert step2 == 6 and led2.steps == 6
    assert led2.history[:4] == led.history
    assert led2.silo_steps(2) == 1 and led2.epsilon(2) == led.epsilon(2)
    assert tr2.membership.excluded == (2,)

    tr, _, step = _budget_run(weights, 2, tmp_path / "b",
                              silo_budgets={1: 20.0})
    assert step == 2 and not tr.accountant.silo_exhausted(1)
    tr2, _, step2 = _budget_run(weights, 5, tmp_path / "b")  # no flags
    assert step2 == 5 and tr2.accountant.budget_for(1) == 20.0
    assert tr2.accountant.silo_exhausted(1)
    assert tr2.membership is not None and tr2.membership.excluded == (1,)
    assert tr2.metrics_log[-1]["n_contributions"] == 3.0


def test_legacy_accountant_state_restores_into_ledger(weights, tmp_path):
    """A checkpoint whose ``accountant`` extra is a scalar
    ``PrivacyAccountant`` dict (JAX's own, written by JAX's checkpointer)
    restores into an all-silos-identical ledger that goes on composing."""
    from repro.checkpoint import checkpointer as jck

    legacy = JaxAccountant(sigma=0.5, delta=1e-5)
    legacy.step(2, contributions=4)
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**QUICKSTART),
                                optimizer=JaxOptimizer(name="adamw", lr=LR))
    jck.save(tmp_path, 2, js.init_state(),
             extra={"accountant": legacy.state_dict()})
    tr, _, step = _budget_run(weights, 4, tmp_path)
    led = tr.accountant
    assert step == 4 and led.steps == 4
    assert led.contributions[:2] == [4, 4]
    for i in range(4):
        assert led.silo_steps(i) == 4 and led.epsilon(i) == led.epsilon()
    assert PrivacyAccountant.from_state_dict(legacy.state_dict()).epsilon() \
        == legacy.epsilon()


def test_barrier_perleaf_with_budgets_refused(weights, tmp_path):
    """Budgets shrink the set, which the barrier tier's perleaf mask family
    cannot honour: refused at build, and at restore when only the
    checkpoint carries them, with JAX's ValueError."""
    barrier = dict(priv=dict(sync_path="barrier"),
                   mesh=MeshConfig((4,), ("data",)))
    with dispatch.force_impl("perleaf", kernel="dp_noise_tree"):
        with pytest.raises(ValueError, match="perleaf"):
            _port(weights, 1, silo_epsilon_budget=1.0, **barrier)
    _port(weights, 1, tmp_path, silo_budgets={0: 50.0}, **barrier)
    with dispatch.force_impl("perleaf", kernel="dp_noise_tree"):
        with pytest.raises(ValueError, match="checkpoint carries per-silo "
                                             "budgets"):
            _port(weights, 2, tmp_path, **barrier)


# ---------------------------------------------------------------------------
# elastic membership


SLOW = [0.1, 0.1, 0.7, 0.1]


def _escalate(tr):
    tr.telemetry.observe_all(SLOW)  # the hook's first feed
    for _ in range(tr.straggler.escalate_after):
        tr.straggler.observe(1e9)


def test_escalation_drops_slowest_silo_as_jax():
    """A latency hook names silo 2; driven to escalate as JAX's
    ``test_trainer_escalation_drops_slowest_silo`` drives it, both
    Trainers drop silo 2 with the same events."""
    kw = dict(step_deadline_s=30.0, elastic=True, elastic_cooldown=2)
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**QUICKSTART))
    jtr = JaxTrainer(js.model, js.run_cfg,
                     JaxTrainerConfig(total_steps=2, log_every=0, **kw),
                     lambda: {}, silo_latency_hook=lambda step: SLOW)
    sess = Session.from_config(ARCH, device="cpu",
                               privacy=PrivacyConfig(**QUICKSTART))
    tr = Trainer(sess.model, sess.run_cfg,
                 TrainerConfig(total_steps=2, log_every=0, **kw),
                 lambda: {}, silo_latency_hook=lambda step: SLOW)
    for t in (tr, jtr):
        _escalate(t)
    assert tr.membership.events == jtr.membership.events
    assert tr.straggler.events == jtr.straggler.events
    np.testing.assert_array_equal(tr.membership.active_at(0),
                                  jtr.membership.active_at(0))
    assert tr.membership.events[0]["silo"] == 2


def test_elastic_run_participation_matches_jax(weights):
    """A barrier run with the escalation primed: silo 2 out for steps 0-1
    and back at 2, as the JAX membership layer decides it; the deadline
    sees every step's time and flags none."""
    from repro.runtime.elastic import SiloMembership as JaxMembership
    from repro.runtime.straggler import SiloTelemetry as JaxTelemetry

    kw = dict(step_deadline_s=600.0, elastic=True, elastic_cooldown=2)
    sess = Session.from_config(ARCH, device="cpu", mesh=MeshConfig(
        (4,), ("data",)), privacy=PrivacyConfig(**{**QUICKSTART,
                                                   "sync_path": "barrier"}))
    fb = FederatedBatcher(ArrayDataset(TOKENS[:, :-1], TOKENS[:, 1:])
                          .split(4), per_silo_batch=1)

    def next_batch():
        b = fb.next()
        return {"tokens": torch.as_tensor(b["x"], dtype=torch.long),
                "labels": torch.as_tensor(b["y"], dtype=torch.long)}

    tr = Trainer(sess.model, sess.run_cfg,
                 TrainerConfig(total_steps=4, log_every=0, **kw), next_batch,
                 silo_latency_hook=lambda step: SLOW)
    _escalate(tr)
    state, step = tr.fit(sess.init_state(), prng.PRNGKey(1))
    jm, jt = JaxMembership(4, cooldown_steps=2), JaxTelemetry(4)
    jt.observe_all(SLOW)
    jm.drop_one(0, telemetry=jt)
    want = [jm.active_at(t).sum() for t in range(4)]
    assert step == 4
    assert [m["n_contributions"] for m in tr.metrics_log] == want == \
        [3, 3, 4, 4]
    assert tr.membership.events == jm.events
    assert len(tr.straggler.events) == 3 + 1  # the primed flags only
    assert tr.accountant.silo_steps(2) == 2
