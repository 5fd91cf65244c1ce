"""Host-side training loop with fault tolerance. Port of
``repro/runtime/trainer.py``: checkpoint/restart, the privacy ledger's
persistence and per-silo budgets, elastic silo membership with straggler
escalation, the straggler deadline and SIGTERM preemption.

The inner step is the port's train step (``distributed/steps.py``); this
loop owns what the step does not: the ledger (its state must survive
restarts: the guarantee composes over every step ever taken), the data
iterator's state, the checkpoint cadence and the wall-clock policies.

The port's loop is synchronous: each step reads its metrics and its
:class:`~repro_torch.distributed.steps.StageTimer` on the host, which waits
for the card, so ``step_time_s`` is the true step time. JAX keeps its
metrics on the device between flushes; here a flush only moves the host
entries into ``metrics_log``. Under ``step_deadline_s`` the policy observes
every step's time; without it the adaptive policy is re-anchored at each
flush with the window's mean step time (JAX's amortized wall time) and
observes every step's time between flushes without moving its baseline,
as JAX observes its dispatch times. Either way its inputs are true step
times.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import RunConfig
from repro_torch.core.privacy import PrivacyLedger
from repro_torch.distributed import steps as steps_mod
from repro_torch.runtime.elastic import SiloMembership
from repro_torch.runtime.straggler import SiloTelemetry, StragglerPolicy


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    # halt when the global epsilon(delta) reaches this (the paper's "no
    # further training is allowed by DP")
    epsilon_budget: Optional[float] = None
    # per-silo budgets: a uniform per-silo epsilon, overridden per silo by
    # ``silo_budgets``; a silo whose own spend reaches its budget leaves the
    # participation set (no rejoin without an operator override), and
    # training stops once no silo may contribute
    silo_epsilon_budget: Optional[float] = None
    silo_budgets: Optional[dict] = None  # silo index -> epsilon override
    # straggler deadline: every step's time against it (None: adaptive)
    step_deadline_s: Optional[float] = None
    metrics_flush_every: int = 50
    # elastic membership: straggler escalations drop a silo for
    # ``elastic_cooldown`` steps
    elastic: bool = False
    elastic_cooldown: int = 10
    elastic_min_active: int = 1


@dataclass
class Trainer:
    model: object
    run_cfg: RunConfig
    tcfg: TrainerConfig
    next_batch: Callable[[], dict]
    batch_state: Optional[object] = None  # has state_dict / load_state_dict
    # who contributes each step; ``silo_schedule`` (step -> bool sequence)
    # overrides ``membership`` when given
    membership: Optional[SiloMembership] = None
    silo_schedule: Optional[Callable[[int], Sequence[bool]]] = None
    # simulated per-silo latencies (step -> (n_silos,) seconds) feeding
    # SiloTelemetry, so an escalation drops the slow silo
    silo_latency_hook: Optional[Callable[[int], Sequence[float]]] = None
    metrics_log: list = field(default_factory=list)
    # per step, the stage times in ms (fused tier: silo_grads, pack, norms,
    # aggregate, noise, optimizer; barrier tier: silo_grads, norms, pack,
    # contributions, reduce, optimizer): CUDA events on the card, the host
    # clock on the CPU
    stage_log: list = field(default_factory=list)
    # each save and restore: op, step, seconds and the checkpointer's split
    # (bytes; d2h_s, write_s, hash_s; read_s, hash_s, h2d_s)
    checkpoint_log: list = field(default_factory=list)
    restored_step: Optional[int] = None  # the step a fit resumed at
    _preempted: bool = False
    _pending: list = field(default_factory=list)  # entries not yet flushed
    _step: int = 0  # the current step (escalation reads it)

    def __post_init__(self):
        priv = self.run_cfg.privacy
        self.n_silos = steps_mod.effective_n_silos(self.run_cfg)
        self.accountant = PrivacyLedger.from_privacy_config(
            priv, self.n_silos,
            epsilon_budget=self.tcfg.silo_epsilon_budget,
            budgets=self.tcfg.silo_budgets) if priv.enabled else None
        self.straggler = StragglerPolicy(self.tcfg.step_deadline_s)
        self.telemetry = SiloTelemetry(self.n_silos)
        if self.tcfg.elastic and self.membership is None:
            self.membership = SiloMembership(
                self.n_silos, min_active=self.tcfg.elastic_min_active,
                cooldown_steps=self.tcfg.elastic_cooldown)
        if self.membership is None and self.accountant is not None \
                and self.accountant.has_budgets():
            # per-silo budgets need a membership layer for their exclusions
            self.membership = SiloMembership(self.n_silos)
        if self.tcfg.elastic and self.straggler.on_escalate is None \
                and self.silo_schedule is None:
            # escalation drops the slowest silo by telemetry for the
            # cooldown; a silo_schedule pins the set, so no shadow drop
            self.straggler.on_escalate = lambda decision: \
                self.membership.drop_one(self._step,
                                         telemetry=self.telemetry)
        # budgets shrink the set too: refused up front by the barrier
        # tier's perleaf policy, whose mask family builds the full ring
        partial_sets = self.tcfg.elastic or self.silo_schedule is not None \
            or (self.accountant is not None and self.accountant.has_budgets())
        self.train_step = steps_mod.build_train_step(
            self.model, self.run_cfg, elastic=partial_sets)

    def _active_for(self, step: int):
        """This step's participation set, or None when no source of partial
        participation is armed (every consumer reads None as every silo)."""
        budgets = self.accountant is not None and self.accountant.has_budgets()
        if self.silo_schedule is not None:
            active = np.asarray(self.silo_schedule(step), bool)
        elif self.membership is not None:
            active = self.membership.active_at(step)
        elif budgets:
            active = np.ones(self.n_silos, bool)
        else:
            return None
        if budgets:
            # budget verdicts override every source of the set
            active = active & self.accountant.allowed_mask()
        return active

    def _enforce_budgets(self, step: int) -> None:
        """The ledger's fresh exclusions become membership drops (no
        cooldown, no rejoin without an operator override)."""
        if self.accountant is None:
            return
        for silo in self.accountant.take_exclusions():
            if self.membership is not None:
                self.membership.exclude(silo, step=step, reason="budget")

    def spend_report(self) -> Optional[dict]:
        """The ledger's spend report (None without privacy), with per-silo
        round-trip EMAs when telemetry has observations."""
        if not self.accountant:
            return None
        return self.accountant.spend_report(
            round_trip_s=self.telemetry.snapshot())

    # -- preemption ----------------------------------------------------------
    def install_preemption_handler(self):
        """On SIGTERM the loop saves at its next step boundary and returns.
        Returns the handler it replaced."""
        def handler(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, handler)

    # -- metrics -------------------------------------------------------------
    def _flush_metrics(self):
        """Move the pending entries into ``metrics_log``; without a deadline,
        re-anchor the adaptive policy at the window's mean step time."""
        if not self._pending:
            return
        n = len(self._pending)
        window_s = sum(e["step_time_s"] for e in self._pending)
        self.metrics_log.extend(self._pending)
        self._pending.clear()
        if self.tcfg.step_deadline_s is None:
            self.straggler.calibrate(window_s / n)

    # -- checkpointing ---------------------------------------------------------
    def _save(self, state, step: int):
        self._flush_metrics()
        if not self.tcfg.checkpoint_dir:
            return
        extra = {
            "accountant": self.accountant.state_dict() if self.accountant
            else None,
            "batch_state": (self.batch_state.state_dict()
                            if self.batch_state is not None else None),
            # the loss and epsilon history survive a restart
            "metrics_log": list(self.metrics_log),
        }
        t = {"op": "save", "step": step}
        t0 = time.perf_counter()
        checkpointer.save(self.tcfg.checkpoint_dir, step, state, extra,
                          timings=t)
        t["s"] = time.perf_counter() - t0
        self.checkpoint_log.append(t)
        checkpointer.garbage_collect(self.tcfg.checkpoint_dir,
                                     self.tcfg.keep_checkpoints)

    def try_restore(self, state):
        """Resume from the latest complete checkpoint if there is one:
        ``(state, step)``, the state's buffers filled in place."""
        if not self.tcfg.checkpoint_dir:
            return state, state.step
        if checkpointer.latest_step(self.tcfg.checkpoint_dir) is None:
            return state, state.step
        t = {"op": "restore"}
        t0 = time.perf_counter()
        try:
            state, extra, step = checkpointer.restore(
                self.tcfg.checkpoint_dir, state, timings=t)
        except KeyError:
            # a checkpoint from before elastic membership has no
            # noise_state.prev_active: restore the two-field noise state and
            # take the history before it as all-active
            legacy = state._replace(
                noise_state=state.noise_state._replace(prev_active=None))
            t = {"op": "restore"}
            restored, extra, step = checkpointer.restore(
                self.tcfg.checkpoint_dir, legacy, timings=t)
            state = restored._replace(noise_state=restored.noise_state
                                      ._replace(prev_active=np.ones(
                                          self.n_silos, bool)))
        t.update(step=step, s=time.perf_counter() - t0)
        self.checkpoint_log.append(t)
        self.restored_step = step
        if self.accountant and extra.get("accountant"):
            # a ledger's state dict or a legacy PrivacyAccountant's; the
            # budgets configured now win, else the checkpoint's enforce
            restored_ledger = PrivacyLedger.from_state_dict(
                extra["accountant"], n_silos=self.n_silos)
            if self.tcfg.silo_epsilon_budget is not None:
                restored_ledger.epsilon_budget = self.tcfg.silo_epsilon_budget
            if self.tcfg.silo_budgets:
                restored_ledger.budgets = dict(self.tcfg.silo_budgets)
            self.accountant = restored_ledger
            if self.membership is None and restored_ledger.has_budgets():
                self.membership = SiloMembership(self.n_silos)
            priv = self.run_cfg.privacy
            if restored_ledger.has_budgets() and priv.enabled \
                    and priv.sync_path == "barrier":
                # the build-time refusal could not see checkpoint budgets: a
                # perleaf barrier step would aggregate the full ring while
                # the ledger stops charging the excluded silos
                from repro_torch.core import dp_pipeline
                if dp_pipeline.resolve_policy("packed").mode == "perleaf":
                    raise ValueError(
                        "checkpoint carries per-silo budgets but the barrier "
                        "tier resolved the perleaf mask family, which only "
                        "builds the full static ring; lift the "
                        "dp_noise_tree=perleaf override to enforce budgets")
            if self.membership is not None:
                # re-apply the standing exclusions (the pending queue is not
                # persisted: what matters is who is exhausted now)
                for silo in self.accountant.exhausted():
                    self.membership.exclude(silo, step=step, reason="budget")
        if self.batch_state is not None and extra.get("batch_state"):
            self.batch_state.load_state_dict(extra["batch_state"])
        if extra.get("metrics_log"):
            self.metrics_log = list(extra["metrics_log"])
        return state, step

    # -- main loop -----------------------------------------------------------
    def fit(self, state, root_key: tuple) -> tuple:
        state, step = self.try_restore(state)
        while step < self.tcfg.total_steps:
            if self._preempted:
                self._save(state, step)
                return state, step
            if (self.tcfg.epsilon_budget is not None and self.accountant
                    and self.accountant.epsilon() >= self.tcfg.epsilon_budget):
                break  # privacy budget exhausted: DP forbids further training
            active = self._active_for(step)
            if active is not None and not active.any():
                break  # nobody may contribute
            batch = self.next_batch()
            self._step = step
            if self.silo_latency_hook is not None:
                self.telemetry.observe_all(self.silo_latency_hook(step))
            timer = steps_mod.StageTimer(state.clip_bound.device)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch, root_key, active,
                                             timer=timer)
            entry = {"step": step,
                     **{k: float(v) for k, v in metrics.items()}}
            dt = time.perf_counter() - t0  # the .item()s waited for the card
            entry["step_time_s"] = dt
            self.stage_log.append(timer.ms())
            if self.tcfg.step_deadline_s is not None:
                self.straggler.observe(dt)
            elif self.straggler.calibrated:
                # flags only: the baseline moves at flushes
                self.straggler.observe(dt, update_baseline=False)
            if self.accountant:
                self.accountant.record(active)
                entry["epsilon"] = self.accountant.epsilon()
                entry["epsilon_per_silo"] = self.accountant.epsilon_per_silo()
                self._enforce_budgets(step + 1)
            self._pending.append(entry)
            step += 1
            if len(self._pending) >= max(self.tcfg.metrics_flush_every, 1):
                self._flush_metrics()
            if step % self.tcfg.checkpoint_every == 0:
                self._save(state, step)
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                self._flush_metrics()
                eps = entry.get("epsilon")
                print(f"step {step:6d} loss {entry['loss']:.4f} "
                      f"C {entry['clip_bound']:.3f}"
                      + (f" eps {eps:.3f}" if eps is not None else ""),
                      flush=True)
        self._save(state, step)
        return state, step
