"""Elastic scaling: the two decision layers a cluster controller calls.
Port of ``repro/runtime/elastic.py``.

**Device elasticity**: :func:`plan_mesh` picks the largest valid
``(data, model)`` mesh for the healthy device count, keeping the model
axis (shrinking the data axis changes throughput, not the program), and
:func:`resume_plan` restores the last checkpoint for it; the ledger rides
in the checkpoint, so the privacy budget is continuous across re-scales.
The port runs on one card, so the plan is a decision, not a re-shard.

**Silo elasticity**: :class:`SiloMembership` says which data owners
contribute each step. The DP engine keeps the zero-sum mask and the noise
correction invariants over any active subset, so dropping a straggling or
failed silo is a per-step decision, and rejoining flips its bit back on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import MeshConfig


@dataclass
class ElasticPlan:
    mesh: MeshConfig
    dropped_devices: int
    note: str


def _divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def plan_mesh(n_healthy: int, model_parallel: int = 16,
              pods: int = 1) -> Optional[ElasticPlan]:
    """Largest mesh (pods?, data, model) that fits the healthy device count,
    keeping the model axis fixed (TP re-sharding would change per-op shapes;
    data-axis changes are shape-transparent to the step function)."""
    per_pod = n_healthy // max(pods, 1)
    if per_pod < model_parallel:
        # degrade: drop to the largest model axis that still fits
        for mp in _divisors_desc(model_parallel):
            if mp <= per_pod:
                data = per_pod // mp
                if data >= 1:
                    mesh = (MeshConfig((pods, data, mp),
                                       ("pod", "data", "model"))
                            if pods > 1 else MeshConfig((data, mp),
                                                        ("data", "model")))
                    used = pods * data * mp
                    return ElasticPlan(mesh, n_healthy - used,
                                       f"TP degraded {model_parallel}->{mp}")
        return None
    data = per_pod // model_parallel
    mesh = (MeshConfig((pods, data, model_parallel), ("pod", "data", "model"))
            if pods > 1 else MeshConfig((data, model_parallel),
                                        ("data", "model")))
    used = pods * data * model_parallel
    return ElasticPlan(mesh, n_healthy - used,
                       f"data axis {data} (was sized for failures)")


def resume_plan(ckpt_dir: str, state_template, plan: ElasticPlan,
                shardings=None):
    """Restore the latest checkpoint for the new mesh: ``(state, extra,
    step)``. The port's state lies on one card, so ``shardings`` is
    accepted for the JAX signature and ignored, and ``plan`` only names
    the mesh the caller builds its run for."""
    from repro_torch.checkpoint import checkpointer
    del plan
    return checkpointer.restore(ckpt_dir, state_template,
                                shardings=shardings)


# ---------------------------------------------------------------------------
# Silo membership (elastic participation sets)


@dataclass
class SiloMembership:
    """``drop(silo, step)`` removes a silo from ``step`` on, for
    ``cooldown`` steps (``cooldown_steps`` when it names none; then it
    rejoins by itself) or until :meth:`rejoin`.
    ``min_active`` is the quorum: a drop that would leave fewer contributors
    is refused and recorded in ``events``."""

    n_silos: int
    min_active: int = 1
    cooldown_steps: int = 0  # the cooldown of a drop() that names none
    # silo -> step at which it rejoins (None = until rejoin() is called)
    _out: dict = field(default_factory=dict)
    # budget-excluded silos: never auto-rejoin, rejoin() needs an override
    _excluded: set = field(default_factory=set)
    events: list = field(default_factory=list)

    def active_at(self, step: int) -> np.ndarray:
        """(n_silos,) bool participation set for ``step`` (auto-rejoins
        expired cooldowns)."""
        for silo in [s for s, until in self._out.items()
                     if until is not None and step >= until]:
            self.rejoin(silo, step=step)
        mask = np.ones(self.n_silos, bool)
        for silo in self._out:
            mask[silo] = False
        return mask

    def drop(self, silo: int, step: int = 0,
             cooldown: Optional[int] = None) -> bool:
        """Remove ``silo`` from the active set. False (and a recorded
        refusal) when the quorum would be broken."""
        if silo in self._out:
            return True
        if len(self._out) + 1 > self.n_silos - self.min_active:
            self.events.append({"action": "drop_refused", "silo": silo,
                                "step": step, "reason": "min_active quorum"})
            return False
        cd = self.cooldown_steps if cooldown is None else cooldown
        self._out[silo] = step + cd if cd else None
        self.events.append({"action": "drop", "silo": silo, "step": step,
                            "rejoin_at": self._out[silo]})
        return True

    def drop_one(self, step: int = 0, cooldown: Optional[int] = None,
                 telemetry=None) -> Optional[int]:
        """Drop the slowest active silo by ``telemetry``
        (``runtime.straggler.SiloTelemetry``); without observations the
        highest-index active silo."""
        candidates = [s for s in range(self.n_silos) if s not in self._out]
        if not candidates:
            return None
        silo = telemetry.slowest(candidates) if telemetry is not None else None
        if silo is None:
            silo = candidates[-1]
        return silo if self.drop(silo, step, cooldown) else None

    def exclude(self, silo: int, step: int = 0, reason: str = "budget") -> bool:
        """Budget-driven drop: no cooldown, no rejoin without an operator
        override, and the quorum is ignored (DP forbids the silo outright)."""
        if silo in self._excluded:
            return True
        self._excluded.add(silo)
        self._out[silo] = None
        self.events.append({"action": "exclude", "silo": silo, "step": step,
                            "reason": reason})
        return True

    @property
    def excluded(self) -> tuple:
        return tuple(sorted(self._excluded))

    def rejoin(self, silo: int, step: int = 0, override: bool = False) -> bool:
        """Return a silo to the active set; a budget-excluded silo only with
        ``override=True``."""
        if silo in self._excluded:
            if not override:
                self.events.append({"action": "rejoin_refused", "silo": silo,
                                    "step": step,
                                    "reason": "budget exclusion needs "
                                              "operator override"})
                return False
            self._excluded.discard(silo)
        if silo in self._out:
            del self._out[silo]
            self.events.append({"action": "rejoin", "silo": silo,
                                "step": step, "override": override})
        return True
