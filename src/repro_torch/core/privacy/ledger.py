"""Per-silo privacy accounting with enforceable budgets. The port's copy of
``repro/core/privacy/ledger.py`` (pure Python and numpy, the same float
operations in the same order, so its epsilons and state dicts are the JAX
ledger's).

The paper's guarantee is per data owner: each silo's privacy loss composes
over the steps that silo contributed to.

* the history is a per-step ``(n_silos,)`` participation bitmask, and
  :meth:`PrivacyLedger.record` is the one write path;
* epsilon is computed per silo over its own history: composed step counts
  in ``mode='analytic'``, per-silo RDP state (subsampled Gaussian at rate
  ``q``) in ``mode='rdp'``;
* per-silo budgets (``epsilon_budget``, ``budgets``) turn the record into
  enforcement: :meth:`~PrivacyLedger.allowed_mask` is the verdict vector,
  :meth:`~PrivacyLedger.take_exclusions` feeds the membership layer's
  budget drops (no rejoin without an operator override);
* :meth:`~PrivacyLedger.spend_report` is the admin-plane surfacing;
* :meth:`~PrivacyLedger.state_dict` / ``from_state_dict`` carry the ledger
  across restarts (the budgets must survive them), and a legacy scalar
  :class:`PrivacyAccountant` dict restores into an all-silos-identical
  ledger.

With an all-active history every per-silo epsilon equals the scalar
accountant's in both modes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.privacy.bounds import (composed_eps,
                                             rdp_subsampled_gaussian,
                                             rdp_to_eps)

_RDP_ORDERS = range(2, 256)


def _as_mask(active, n_silos: int) -> np.ndarray:
    mask = np.asarray(active)
    if mask.dtype != np.bool_:
        mask = mask.astype(bool)
    if mask.shape != (n_silos,):
        raise ValueError(f"participation mask has shape {mask.shape}, "
                         f"ledger tracks {n_silos} silos")
    return mask


def _mask_to_bits(mask: np.ndarray) -> int:
    bits = 0
    for i, on in enumerate(mask):
        if on:
            bits |= 1 << i
    return bits


def _bits_to_mask(bits: int, n_silos: int) -> np.ndarray:
    return np.array([(bits >> i) & 1 for i in range(n_silos)], bool)


@dataclass
class PrivacyLedger:
    """Per-silo (eps, delta) ledger with budget enforcement.

    ``mode='analytic'`` composes the tight full-batch Gaussian bound over
    each silo's participated-step count; ``mode='rdp'`` keeps per-silo RDP
    state (subsampled Gaussian at rate ``q``). Noise correction enters
    through ``lam`` exactly as in the scalar accountant: the effective
    per-release scale is sigma*(1-lam) (Thm. 1).

    ``epsilon_budget`` is the uniform per-silo budget; ``budgets`` holds
    per-silo overrides (silo index -> eps). A silo whose spent epsilon
    reaches its budget is *exhausted*: it disappears from
    :meth:`allowed_mask` and surfaces once through :meth:`take_exclusions`
    so the membership layer can drop it.
    """

    sigma: float
    delta: float
    n_silos: int = 1
    lam: float = 0.0
    q: float = 1.0  # sampling rate; 1.0 = full batch
    mode: str = "analytic"
    epsilon_budget: Optional[float] = None  # uniform per-silo budget
    budgets: dict = field(default_factory=dict)  # silo -> budget override
    steps: int = 0
    history: list = field(default_factory=list)  # per-step bitmask (int)
    events: list = field(default_factory=list)
    _silo_steps: list = field(default_factory=list)  # per-silo participation
    _rdp: dict = field(default_factory=dict)         # global (all steps)
    _silo_rdp: list = field(default_factory=list)
    _exhausted_seen: set = field(default_factory=set)
    _pending_exclusions: list = field(default_factory=list)
    _eps_cache: dict = field(default_factory=dict)  # analytic: steps -> eps

    def __post_init__(self):
        if not self._silo_steps:
            self._silo_steps = [0] * self.n_silos
        if not self._silo_rdp:
            self._silo_rdp = [{} for _ in range(self.n_silos)]

    @classmethod
    def from_privacy_config(cls, priv, n_silos: int, *,
                            epsilon_budget: Optional[float] = None,
                            budgets: Optional[dict] = None,
                            q: float = 1.0,
                            mode: str = "analytic") -> "PrivacyLedger":
        """The one construction convention every tier shares: per-step noise
        is drawn at sigma/(1-lam), and the ledger's internal (1-lam) factor
        brings the effective per-release scale back to ``priv.sigma``
        (Thm. 1) — so the in-process and wire tiers compute identical
        epsilons for one PrivacyConfig."""
        return cls(sigma=priv.sigma / max(1.0 - priv.noise_lambda, 1e-9),
                   delta=priv.delta, n_silos=n_silos,
                   lam=priv.noise_lambda, q=q, mode=mode,
                   epsilon_budget=epsilon_budget,
                   budgets=dict(budgets or {}))

    # -- recording ----------------------------------------------------------
    def record(self, active=None) -> None:
        """Record one training step's ``(n_silos,)`` participation bitmask
        (``None`` = all silos contributed). The ONLY write path: per-silo
        step counts, RDP state and budget verdicts all derive from it."""
        mask = np.ones(self.n_silos, bool) if active is None \
            else _as_mask(active, self.n_silos)
        self.steps += 1
        self.history.append(_mask_to_bits(mask))
        if self.mode == "rdp":
            inc = self._rdp_increment()
            for a in _RDP_ORDERS:
                self._rdp[a] = self._rdp.get(a, 0.0) + inc[a]
        for i in range(self.n_silos):
            if mask[i]:
                self._silo_steps[i] += 1
                if self.mode == "rdp":
                    sr = self._silo_rdp[i]
                    for a in _RDP_ORDERS:
                        sr[a] = sr.get(a, 0.0) + inc[a]
        self._refresh_exhausted()

    def step(self, n: int = 1, contributions: Optional[int] = None) -> None:
        """Legacy count-only API: records ``n`` all-active steps (a bare
        count can't attribute participation to specific silos; callers with
        real membership information use :meth:`record`)."""
        del contributions
        for _ in range(n):
            self.record(None)

    def _rdp_increment(self) -> dict:
        # one step's RDP increment; constant across steps (sigma/lam/q fixed)
        cached = getattr(self, "_rdp_inc", None)
        if cached is None:
            sig = self.sigma * (1.0 - self.lam)
            cached = {a: rdp_subsampled_gaussian(a, sig, self.q)
                      for a in _RDP_ORDERS}
            self._rdp_inc = cached
        return cached

    # -- reading ------------------------------------------------------------
    @property
    def contributions(self) -> list:
        """Per-step active-silo counts (the old accountant's audit record,
        now derived from the bitmask history)."""
        return [bin(bits).count("1") for bits in self.history]

    def participation(self) -> np.ndarray:
        """(steps, n_silos) bool participation matrix."""
        if not self.history:
            return np.zeros((0, self.n_silos), bool)
        return np.stack([_bits_to_mask(b, self.n_silos) for b in self.history])

    def silo_steps(self, silo: int) -> int:
        return self._silo_steps[silo]

    def _eps_analytic(self, steps: int) -> float:
        if steps not in self._eps_cache:
            sig = self.sigma * (1.0 - self.lam)
            self._eps_cache[steps] = composed_eps(self.delta, sig, steps) \
                if steps > 0 else 0.0
        return self._eps_cache[steps]

    def _eps_rdp(self, rdp: dict) -> float:
        if not rdp:
            return 0.0
        return min(rdp_to_eps(r, a, self.delta) for a, r in rdp.items())

    def epsilon(self, silo: Optional[int] = None) -> float:
        """Spent epsilon: global (over every step taken — the old scalar
        semantics, a valid bound for every silo) or per-silo (over that
        silo's own participation history)."""
        if silo is None:
            if self.mode == "analytic":
                return self._eps_analytic(self.steps)
            return self._eps_rdp(self._rdp)
        if self.mode == "analytic":
            return self._eps_analytic(self._silo_steps[silo])
        return self._eps_rdp(self._silo_rdp[silo])

    def epsilon_per_silo(self) -> list:
        return [self.epsilon(i) for i in range(self.n_silos)]

    def spent(self, silo: Optional[int] = None) -> tuple:
        return self.epsilon(silo), self.delta

    # -- budgets & enforcement ----------------------------------------------
    def has_budgets(self) -> bool:
        """True when any enforcement is armed (the single definition the
        trainer's gating/membership-creation decisions share)."""
        return self.epsilon_budget is not None or bool(self.budgets)

    def budget_for(self, silo: int) -> Optional[float]:
        return self.budgets.get(silo, self.epsilon_budget)

    def silo_exhausted(self, silo: int) -> bool:
        b = self.budget_for(silo)
        return b is not None and self.epsilon(silo) >= b

    def allowed_mask(self) -> np.ndarray:
        """(n_silos,) bool verdict vector: True = the silo's owner still has
        budget. The admin distributes this alongside the participation set so
        handlers can refuse to contribute inside the TEE boundary."""
        return np.array([not self.silo_exhausted(i)
                         for i in range(self.n_silos)], bool)

    def exhausted(self) -> list:
        return [i for i in range(self.n_silos) if self.silo_exhausted(i)]

    def _refresh_exhausted(self) -> None:
        current = set(self.exhausted())
        readmitted = self._exhausted_seen - current
        if readmitted:
            # a budget raise re-admitted these silos; forget them so a later
            # re-exhaustion fires a fresh event + exclusion decision
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
        """Silos newly exhausted since the last call — the exclusion
        decisions the membership layer must honor (drained once). Budgets
        may have changed since the last :meth:`record` (operator edits), so
        the verdicts are re-derived first."""
        self._refresh_exhausted()
        out, self._pending_exclusions = self._pending_exclusions, []
        return out

    # -- surfacing -----------------------------------------------------------
    def config_dict(self) -> dict:
        """The ledger's guarantee-relevant configuration — what joins the
        attestation measurement on the wire tier (handlers must agree on the
        budgets they enforce)."""
        return {"sigma": self.sigma, "delta": self.delta, "lam": self.lam,
                "q": self.q, "mode": self.mode, "n_silos": self.n_silos,
                "epsilon_budget": self.epsilon_budget,
                "budgets": {str(k): v for k, v in sorted(self.budgets.items())}}

    def spend_report(self, round_trip_s: Optional[dict] = None) -> dict:
        """Admin-plane spend report (JSON-serializable): global epsilon plus
        one row per silo with its own history, spend, budget and verdict.
        ``round_trip_s`` (silo -> EMA seconds, from SiloTelemetry.snapshot)
        adds an ``avg_round_trip_ms`` column to each silo's row — the
        latency view rides inside the signed body."""
        def _f(x):
            return None if x is None or math.isinf(x) else float(x)
        rt = round_trip_s or {}
        silos = []
        for i in range(self.n_silos):
            eps = self.epsilon(i)
            b = self.budget_for(i)
            row = {
                "silo": i,
                "steps_participated": self._silo_steps[i],
                "steps_sat_out": self.steps - self._silo_steps[i],
                "epsilon": _f(eps),
                "budget": _f(b),
                "remaining": _f(max(b - eps, 0.0)) if b is not None else None,
                "exhausted": self.silo_exhausted(i),
            }
            if rt:
                row["avg_round_trip_ms"] = (
                    None if rt.get(i) is None
                    else round(float(rt[i]) * 1e3, 3))
            silos.append(row)
        # events carry raw floats (math.inf is fine in Python); the report
        # must be strict-JSON, so inf maps to null here too
        exclusions = [{**e, "epsilon": _f(e.get("epsilon")),
                       "budget": _f(e.get("budget"))}
                      for e in self.events
                      if e.get("action") == "budget_exhausted"]
        return {"mode": self.mode, "sigma": self.sigma, "delta": self.delta,
                "lam": self.lam, "q": self.q, "steps": self.steps,
                "epsilon_global": _f(self.epsilon()),
                "n_silos": self.n_silos, "silos": silos,
                "exclusions": exclusions}

    # -- persistence (budgets must survive restarts) -------------------------
    def state_dict(self) -> dict:
        return {"kind": "privacy_ledger", "version": 1,
                "sigma": self.sigma, "delta": self.delta, "lam": self.lam,
                "q": self.q, "mode": self.mode, "n_silos": self.n_silos,
                "steps": self.steps, "history": list(self.history),
                "contributions": self.contributions,  # human-readable audit
                "epsilon_budget": self.epsilon_budget,
                "budgets": {str(k): v for k, v in self.budgets.items()},
                "rdp": {str(a): v for a, v in self._rdp.items()},
                "silo_rdp": [{str(a): v for a, v in sr.items()}
                             for sr in self._silo_rdp],
                "exhausted_seen": sorted(self._exhausted_seen),
                "events": list(self.events)}

    @classmethod
    def from_state_dict(cls, d: dict, n_silos: Optional[int] = None) -> "PrivacyLedger":
        """Restore a ledger — from its own state dict, or from a legacy
        scalar ``PrivacyAccountant`` dict (pre-refactor checkpoints), which
        maps to an all-silos-identical ledger: every silo is treated as
        having contributed to all ``steps`` steps, so each per-silo epsilon
        equals the legacy global value (a valid upper bound)."""
        if d.get("kind") == "privacy_ledger":
            if n_silos is not None and int(n_silos) != int(d["n_silos"]):
                raise ValueError(
                    f"checkpointed ledger tracks {d['n_silos']} silos but "
                    f"the run is configured for {n_silos}; a silo-count "
                    f"change across a resume is not supported (the "
                    f"participation history would be unattributable)")
            led = cls(sigma=d["sigma"], delta=d["delta"],
                      n_silos=int(d["n_silos"]), lam=d["lam"], q=d["q"],
                      mode=d["mode"], epsilon_budget=d.get("epsilon_budget"),
                      budgets={int(k): v
                               for k, v in d.get("budgets", {}).items()},
                      steps=int(d["steps"]),
                      history=[int(b) for b in d.get("history", [])],
                      events=list(d.get("events", [])))
            n = led.n_silos
            led._silo_steps = [int(np.sum([(b >> i) & 1 for b in led.history]))
                               for i in range(n)]
            led._rdp = {int(a): v for a, v in d.get("rdp", {}).items()}
            led._silo_rdp = [{int(a): v for a, v in sr.items()}
                             for sr in d.get("silo_rdp", [{}] * n)]
            led._exhausted_seen = set(d.get("exhausted_seen", []))
            return led
        # legacy scalar accountant dict
        n = int(n_silos) if n_silos else 1
        steps = int(d["steps"])
        full = (1 << n) - 1
        led = cls(sigma=d["sigma"], delta=d["delta"], n_silos=n,
                  lam=d["lam"], q=d["q"], mode=d["mode"], steps=steps,
                  history=[full] * steps)
        led._silo_steps = [steps] * n
        led._rdp = {int(a): v for a, v in d.get("rdp", {}).items()}
        led._silo_rdp = [dict(led._rdp) for _ in range(n)]
        led.events.append({"action": "legacy_restore", "steps": steps,
                           "note": "PrivacyAccountant state mapped to an "
                                   "all-silos-identical ledger"})
        return led


# ---------------------------------------------------------------------------
# Legacy scalar accountant (pre-ledger checkpoints; scalar uses)


@dataclass
class PrivacyAccountant:
    """Scalar cumulative privacy-loss tracker (legacy).

    Superseded by :class:`PrivacyLedger` for anything with more than one
    data owner; kept as the restore source for pre-refactor checkpoints and
    for scalar tooling. ``mode='analytic'`` uses the tight Gaussian
    composition (full-batch DP-GD, as in the paper's appendix);
    ``mode='rdp'`` uses subsampled-Gaussian RDP (minibatch DP-SGD with
    sampling rate q). Noise correction enters through ``lam``: the
    *effective* per-release noise scale is sigma*(1-lam) for the final-model
    guarantee (Thm. 1) while each step's added noise has scale sigma
    (stronger per-iteration protection, Eq. 14).
    """

    sigma: float
    delta: float
    lam: float = 0.0
    q: float = 1.0  # sampling rate; 1.0 = full batch
    mode: str = "analytic"
    steps: int = 0
    # per-step active-silo counts (elastic membership): the count-only audit
    # record the PrivacyLedger's bitmask history supersedes
    contributions: list = field(default_factory=list)
    _rdp: dict = field(default_factory=dict)

    def step(self, n: int = 1, contributions: Optional[int] = None) -> None:
        self.steps += n
        if contributions is not None:
            self.contributions.extend([int(contributions)] * n)
        if self.mode == "rdp":
            sig = self.sigma * (1.0 - self.lam)
            for a in _RDP_ORDERS:
                self._rdp[a] = self._rdp.get(a, 0.0) + n * rdp_subsampled_gaussian(a, sig, self.q)

    def epsilon(self) -> float:
        if self.steps == 0:
            return 0.0
        if self.mode == "analytic":
            sig = self.sigma * (1.0 - self.lam)
            return composed_eps(self.delta, sig, self.steps)
        return min(rdp_to_eps(r, a, self.delta) for a, r in self._rdp.items())

    def spent(self) -> tuple[float, float]:
        return self.epsilon(), self.delta

    # -- persistence (fault tolerance: budget must survive restarts) --------
    def state_dict(self) -> dict:
        return {"sigma": self.sigma, "delta": self.delta, "lam": self.lam,
                "q": self.q, "mode": self.mode, "steps": self.steps,
                "contributions": list(self.contributions),
                "rdp": dict(self._rdp)}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PrivacyAccountant":
        acc = cls(sigma=d["sigma"], delta=d["delta"], lam=d["lam"], q=d["q"],
                  mode=d["mode"], steps=d["steps"],
                  contributions=[int(c) for c in d.get("contributions", [])])
        acc._rdp = {int(k): v for k, v in d["rdp"].items()}
        return acc
