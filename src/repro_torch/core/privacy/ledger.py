"""Per-silo privacy ledger: the port's copy of ``PrivacyLedger`` from
``repro/core/privacy/ledger.py``, the part the trainer charges and the
wire tier's admin reads.

The history is a per-step ``(n_silos,)`` participation bitmask, and each
silo's epsilon composes the tight analytic Gaussian bound over the steps it
contributed to; the global epsilon over every step taken. Noise correction
enters as the effective per-release scale ``sigma * (1 - lam)`` (Thm. 1).

Per-silo budgets (``epsilon_budget``, ``budgets``) turn the record into
enforcement: :meth:`allowed_mask` is the verdict vector the wire tier's
admin distributes, and :meth:`take_exclusions` the budget-driven
membership drops its session applies each round. The JAX ledger's RDP
mode, persistence, and the trainer's per-silo budgets come with
checkpointing (``ROADMAP.md`` queue 1, item 10).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.privacy.bounds import composed_eps


@dataclass
class PrivacyLedger:
    sigma: float
    delta: float
    n_silos: int = 1
    lam: float = 0.0
    epsilon_budget: Optional[float] = None  # uniform per-silo budget
    budgets: dict = field(default_factory=dict)  # silo -> budget override
    steps: int = 0
    history: list = field(default_factory=list)  # per-step bitmask (int)
    events: list = field(default_factory=list)
    _silo_steps: list = field(default_factory=list)
    _exhausted_seen: set = field(default_factory=set)
    _pending_exclusions: list = field(default_factory=list)
    _eps_cache: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self._silo_steps:
            self._silo_steps = [0] * self.n_silos

    @classmethod
    def from_privacy_config(cls, priv, n_silos: int, *,
                            epsilon_budget: Optional[float] = None,
                            budgets: Optional[dict] = None) -> "PrivacyLedger":
        """Per-step noise is drawn at sigma / (1 - lam); the ledger's
        (1 - lam) factor brings the effective scale back to ``priv.sigma``."""
        return cls(sigma=priv.sigma / max(1.0 - priv.noise_lambda, 1e-9),
                   delta=priv.delta, n_silos=n_silos, lam=priv.noise_lambda,
                   epsilon_budget=epsilon_budget, budgets=dict(budgets or {}))

    def record(self, active=None) -> None:
        """Record one step's participation bitmask (None = every silo): the
        only write path."""
        mask = np.ones(self.n_silos, bool) if active is None \
            else np.asarray(active).astype(bool)
        if mask.shape != (self.n_silos,):
            raise ValueError(f"participation mask has shape {mask.shape}, "
                             f"ledger tracks {self.n_silos} silos")
        self.steps += 1
        self.history.append(sum(1 << i for i, on in enumerate(mask) if on))
        for i in np.flatnonzero(mask):
            self._silo_steps[i] += 1
        self._refresh_exhausted()

    @property
    def contributions(self) -> list:
        """Per-step active-silo counts."""
        return [bin(bits).count("1") for bits in self.history]

    def _eps(self, steps: int) -> float:
        if steps not in self._eps_cache:
            sig = self.sigma * (1.0 - self.lam)
            self._eps_cache[steps] = composed_eps(self.delta, sig, steps) \
                if steps > 0 else 0.0
        return self._eps_cache[steps]

    def epsilon(self, silo: Optional[int] = None) -> float:
        """Spent epsilon: global (every step taken) or one silo's own."""
        return self._eps(self.steps if silo is None else self._silo_steps[silo])

    def epsilon_per_silo(self) -> list:
        return [self.epsilon(i) for i in range(self.n_silos)]

    # -- budgets & enforcement ----------------------------------------------
    def has_budgets(self) -> bool:
        return self.epsilon_budget is not None or bool(self.budgets)

    def budget_for(self, silo: int) -> Optional[float]:
        return self.budgets.get(silo, self.epsilon_budget)

    def silo_exhausted(self, silo: int) -> bool:
        b = self.budget_for(silo)
        return b is not None and self.epsilon(silo) >= b

    def allowed_mask(self) -> np.ndarray:
        """(n_silos,) bool verdicts: True = the owner still has budget."""
        return np.array([not self.silo_exhausted(i)
                         for i in range(self.n_silos)], bool)

    def exhausted(self) -> list:
        return [i for i in range(self.n_silos) if self.silo_exhausted(i)]

    def _refresh_exhausted(self) -> None:
        current = set(self.exhausted())
        readmitted = self._exhausted_seen - current
        if readmitted:
            # a budget raise re-admitted these silos: a later re-exhaustion
            # fires a fresh event and exclusion
            self._exhausted_seen -= readmitted
            self._pending_exclusions = [s for s in self._pending_exclusions
                                        if s in current]
        for i in sorted(current):
            if i not in self._exhausted_seen:
                self._exhausted_seen.add(i)
                self._pending_exclusions.append(i)
                self.events.append({"action": "budget_exhausted", "silo": i,
                                    "step": self.steps,
                                    "epsilon": self.epsilon(i),
                                    "budget": self.budget_for(i)})

    def take_exclusions(self) -> list:
        """Silos newly exhausted since the last call, drained once (budgets
        may have been edited since the last record, so re-derived first)."""
        self._refresh_exhausted()
        out, self._pending_exclusions = self._pending_exclusions, []
        return out

    # -- surfacing -------------------------------------------------------------
    def config_dict(self) -> dict:
        """The guarantee-relevant configuration, which joins the wire tier's
        attestation measurement."""
        return {"sigma": self.sigma, "delta": self.delta, "lam": self.lam,
                "q": 1.0, "mode": "analytic", "n_silos": self.n_silos,
                "epsilon_budget": self.epsilon_budget,
                "budgets": {str(k): v for k, v in sorted(self.budgets.items())}}

    def spend_report(self, round_trip_s: Optional[dict] = None) -> dict:
        """The admin-plane spend report in the JAX ledger's format (strict
        JSON: inf maps to null). ``round_trip_s`` (silo -> EMA seconds, from
        ``SiloTelemetry.snapshot``) adds each row's ``avg_round_trip_ms``."""
        def _f(x):
            return None if x is None or math.isinf(x) else float(x)
        rt = round_trip_s or {}
        silos = []
        for i in range(self.n_silos):
            eps, b = self.epsilon(i), self.budget_for(i)
            row = {"silo": i, "steps_participated": self._silo_steps[i],
                   "steps_sat_out": self.steps - self._silo_steps[i],
                   "epsilon": _f(eps), "budget": _f(b),
                   "remaining": _f(max(b - eps, 0.0)) if b is not None
                   else None,
                   "exhausted": self.silo_exhausted(i)}
            if rt:
                row["avg_round_trip_ms"] = (None if rt.get(i) is None
                                            else round(float(rt[i]) * 1e3, 3))
            silos.append(row)
        exclusions = [{**e, "epsilon": _f(e.get("epsilon")),
                       "budget": _f(e.get("budget"))}
                      for e in self.events
                      if e.get("action") == "budget_exhausted"]
        return {"mode": "analytic", "sigma": self.sigma, "delta": self.delta,
                "lam": self.lam, "q": 1.0, "steps": self.steps,
                "epsilon_global": _f(self.epsilon()),
                "n_silos": self.n_silos, "silos": silos,
                "exclusions": exclusions}
