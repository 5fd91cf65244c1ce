"""Per-silo privacy ledger: the port's copy of ``PrivacyLedger`` from
``repro/core/privacy/ledger.py``, the part the trainer charges.

The history is a per-step ``(n_silos,)`` participation bitmask, and each
silo's epsilon composes the tight analytic Gaussian bound over the steps it
contributed to; the global epsilon over every step taken. Noise correction
enters as the effective per-release scale ``sigma * (1 - lam)`` (Thm. 1).
The JAX ledger's RDP mode, per-silo budget enforcement and persistence come
with checkpointing and budgets (``ROADMAP.md`` queue 1, item 10); until
then ``spend_report`` reports every silo without a budget, as the JAX
ledger does when none is set.
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
    steps: int = 0
    history: list = field(default_factory=list)  # per-step bitmask (int)
    _silo_steps: list = field(default_factory=list)
    _eps_cache: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self._silo_steps:
            self._silo_steps = [0] * self.n_silos

    @classmethod
    def from_privacy_config(cls, priv, n_silos: int) -> "PrivacyLedger":
        """Per-step noise is drawn at sigma / (1 - lam); the ledger's
        (1 - lam) factor brings the effective scale back to ``priv.sigma``."""
        return cls(sigma=priv.sigma / max(1.0 - priv.noise_lambda, 1e-9),
                   delta=priv.delta, n_silos=n_silos, lam=priv.noise_lambda)

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

    def spend_report(self) -> dict:
        """The admin-plane spend report, the JAX ledger's format (strict
        JSON: inf maps to null)."""
        def _f(x):
            return None if x is None or math.isinf(x) else float(x)
        silos = [{"silo": i, "steps_participated": self._silo_steps[i],
                  "steps_sat_out": self.steps - self._silo_steps[i],
                  "epsilon": _f(self.epsilon(i)), "budget": None,
                  "remaining": None, "exhausted": False}
                 for i in range(self.n_silos)]
        return {"mode": "analytic", "sigma": self.sigma, "delta": self.delta,
                "lam": self.lam, "q": 1.0, "steps": self.steps,
                "epsilon_global": _f(self.epsilon()),
                "n_silos": self.n_silos, "silos": silos, "exclusions": []}
