"""Per-silo step-time attribution. Port of ``SiloTelemetry`` from
``repro/runtime/straggler.py``: an EMA of each silo's observed round trip
(on the wire tier, each handler's ``compute_update`` timed by the session),
so a straggler escalation drops the silo that is actually slow, and a
silo that missed a round's deadline is charged a penalty. The deadline
policy (``StragglerPolicy``) comes with ``ROADMAP.md`` queue 1, item 10.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class SiloTelemetry:
    n_silos: int
    ema_alpha: float = 0.3  # weight of the newest observation
    _ema: dict = field(default_factory=dict)  # silo -> EMA step time

    def observe(self, silo: int, step_time_s: float) -> None:
        prev = self._ema.get(silo)
        self._ema[silo] = step_time_s if prev is None else \
            (1.0 - self.ema_alpha) * prev + self.ema_alpha * step_time_s

    def observe_all(self, step_times_s: Sequence[float]) -> None:
        for silo, t in enumerate(step_times_s):
            self.observe(silo, float(t))

    def penalize(self, silo: int, deadline_s: float,
                 factor: float = 3.0) -> None:
        """A non-responder has no round trip to observe, and an untouched
        EMA would make a hung silo look fast to :meth:`slowest`: fold in a
        penalty of ``deadline_s * factor`` (or its EMA, if larger)."""
        self.observe(silo, max(deadline_s * factor,
                               self._ema.get(silo, 0.0)))

    def ema(self, silo: int) -> Optional[float]:
        return self._ema.get(silo)

    def snapshot(self) -> dict:
        """silo -> EMA seconds: the view the admin folds into the signed
        spend report."""
        return dict(self._ema)

    def slowest(self, candidates: Sequence[int]) -> Optional[int]:
        timed = [s for s in candidates if s in self._ema]
        if not timed:
            return None
        return max(timed, key=lambda s: self._ema[s])
