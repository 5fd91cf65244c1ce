"""Host-side training loop. Port of the part of ``repro/runtime/trainer.py``
the fused and barrier tiers run: the per-step participation set (a
``silo_schedule`` or every silo), the privacy ledger charged with each
step's bitmask, the global ``epsilon_budget`` stop, and the metrics log.

Not ported yet, each raising ``NotImplementedError`` (``ROADMAP.md``
queue 1, item 10): checkpoint/resume, elastic membership with straggler
escalation, per-silo budgets, and the straggler deadline.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.configs.base import RunConfig
from repro_torch.core.privacy import PrivacyLedger
from repro_torch.distributed import steps as steps_mod


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    # halt when the global epsilon(delta) reaches this (the paper's "no
    # further training is allowed by DP")
    epsilon_budget: Optional[float] = None
    silo_epsilon_budget: Optional[float] = None
    silo_budgets: Optional[dict] = None
    step_deadline_s: Optional[float] = None
    elastic: bool = False


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item 10: ledger wiring and persistence)")


@dataclass
class Trainer:
    model: object
    run_cfg: RunConfig
    tcfg: TrainerConfig
    next_batch: Callable[[], dict]
    silo_schedule: Optional[Callable[[int], Sequence[bool]]] = None
    metrics_log: list = field(default_factory=list)
    # per step, the stage times in ms (fused tier: silo_grads, pack, norms,
    # aggregate, noise, optimizer; barrier tier: silo_grads, norms, pack,
    # contributions, reduce, optimizer): CUDA events on the card, the host
    # clock on the CPU
    stage_log: list = field(default_factory=list)

    def __post_init__(self):
        # partial participation sets (a schedule, elastic membership,
        # budgets): refused up front by the barrier tier's perleaf policy
        partial_sets = (self.tcfg.elastic or self.silo_schedule is not None
                        or self.tcfg.silo_epsilon_budget is not None
                        or bool(self.tcfg.silo_budgets))
        self.train_step = steps_mod.build_train_step(
            self.model, self.run_cfg, elastic=partial_sets)
        if self.tcfg.checkpoint_dir:
            _not_ported("checkpointing (checkpoint_dir)")
        if self.tcfg.elastic:
            _not_ported("elastic membership")
        if self.tcfg.silo_epsilon_budget is not None or self.tcfg.silo_budgets:
            _not_ported("per-silo budget enforcement")
        if self.tcfg.step_deadline_s is not None:
            _not_ported("the straggler deadline (step_deadline_s)")
        priv = self.run_cfg.privacy
        self.n_silos = steps_mod.effective_n_silos(self.run_cfg)
        self.accountant = PrivacyLedger.from_privacy_config(
            priv, self.n_silos) if priv.enabled else None

    def _active_for(self, step: int):
        """This step's participation set; None = statically all-active."""
        if self.silo_schedule is None:
            return None
        return np.asarray(self.silo_schedule(step), bool)

    def spend_report(self) -> Optional[dict]:
        """The ledger's spend report (None without privacy)."""
        return self.accountant.spend_report() if self.accountant else None

    def fit(self, state, root_key: tuple) -> tuple:
        step = state.step
        while step < self.tcfg.total_steps:
            if (self.tcfg.epsilon_budget is not None and self.accountant
                    and self.accountant.epsilon() >= self.tcfg.epsilon_budget):
                break  # privacy budget exhausted: DP forbids further training
            active = self._active_for(step)
            if active is not None and not active.any():
                break  # nobody may contribute
            batch = self.next_batch()
            timer = steps_mod.StageTimer(state.clip_bound.device)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch, root_key, active,
                                             timer=timer)
            entry = {"step": step,
                     **{k: float(v) for k, v in metrics.items()}}
            entry["step_time_s"] = time.perf_counter() - t0  # .item() synced
            self.stage_log.append(timer.ms())
            if self.accountant:
                self.accountant.record(active)
                entry["epsilon"] = self.accountant.epsilon()
                entry["epsilon_per_silo"] = self.accountant.epsilon_per_silo()
            self.metrics_log.append(entry)
            step += 1
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                eps = entry.get("epsilon")
                print(f"step {step:6d} loss {entry['loss']:.4f} "
                      f"C {entry['clip_bound']:.3f}"
                      + (f" eps {eps:.3f}" if eps is not None else ""),
                      flush=True)
        return state, step
