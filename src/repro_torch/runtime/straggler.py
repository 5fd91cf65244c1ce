"""Straggler mitigation on the host. Port of ``repro/runtime/straggler.py``.

:class:`SiloTelemetry` keeps an EMA of each silo's observed step time (on
the wire tier, each handler's ``compute_update`` round trip timed by the
session; on the fused tiers, the trainer's ``silo_latency_hook``), so a
straggler escalation drops the silo that is actually slow, and a silo that
missed a round's deadline is charged a penalty.

:class:`StragglerPolicy` flags a step past its deadline (``deadline_s``,
or an adaptive EMA times ``ema_factor``); ``escalate_after`` flags in a row
call ``on_escalate`` (the trainer wires it to
``SiloMembership.drop_one``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence


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


@dataclass
class StragglerPolicy:
    deadline_s: Optional[float] = None  # None -> adaptive (EMA * factor)
    ema_factor: float = 3.0
    escalate_after: int = 3
    on_escalate: Optional[Callable[[dict], None]] = None
    _ema: Optional[float] = None
    _strikes: int = 0
    events: list = field(default_factory=list)

    @property
    def calibrated(self) -> bool:
        return self._ema is not None

    def calibrate(self, step_time_s: float) -> None:
        """Re-anchor the adaptive baseline from an authoritative measurement
        (e.g. the amortized per-step wall time over a metrics-flush window)
        without flagging. Used by the trainer's async loop, where per-step
        dispatch times are only meaningful for *detecting* stalls (dispatch
        blocks under back-pressure) but would mis-seed the EMA."""
        self._ema = step_time_s if self._ema is None \
            else 0.5 * self._ema + 0.5 * step_time_s

    def observe(self, step_time_s: float, update_baseline: bool = True) -> bool:
        """Returns True if this step was flagged as straggling.

        ``update_baseline=False`` checks against the deadline without folding
        the sample into the adaptive EMA — for callers whose samples are only
        trustworthy as stall detectors (async dispatch times collapse to ~0
        right after a queue drain and would decay the baseline; such callers
        anchor the EMA via :meth:`calibrate` instead)."""
        if self._ema is None:
            self._ema = step_time_s
        limit = self.deadline_s if self.deadline_s is not None \
            else self._ema * self.ema_factor
        flagged = step_time_s > limit
        if flagged:
            self._strikes += 1
            self.events.append({"step_time_s": step_time_s, "limit": limit,
                                "strikes": self._strikes})
            if self._strikes >= self.escalate_after:
                decision = {"action": "reschedule", "strikes": self._strikes}
                self.events.append(decision)
                if self.on_escalate:
                    self.on_escalate(decision)
                self._strikes = 0
        else:
            self._strikes = 0
            if update_baseline:
                self._ema = 0.9 * self._ema + 0.1 * step_time_s
        return flagged
