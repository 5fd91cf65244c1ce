"""Silo elasticity: which data owners contribute each round. Port of
``SiloMembership`` from ``repro/runtime/elastic.py`` (numpy). The DP
engine keeps the zero-sum mask and the noise-correction invariants over any
active subset, so dropping a straggling or failed silo is a per-round
decision and rejoining flips its bit back on. Device elasticity
(``plan_mesh``, ``resume_plan``) is not ported yet (``ROADMAP.md`` queue 1,
item 13).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SiloMembership:
    """``drop(silo, step)`` removes a silo from ``step`` on, for
    ``cooldown`` steps (then it rejoins by itself) or until :meth:`rejoin`.
    ``min_active`` is the quorum: a drop that would leave fewer contributors
    is refused and recorded in ``events``."""

    n_silos: int
    min_active: int = 1
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
        self._out[silo] = step + cooldown if cooldown else None
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
