"""Closed-form DP bounds (paper section 4.1, Appendix A): the part of
``repro/core/privacy/bounds.py`` the ledger reads, copied as it is: the
tight analytic Gaussian-mechanism bound (Eq. 1, Balle-Wang), its inverse,
and T-fold full-batch composition (D -> sqrt(T) * D).
"""
from __future__ import annotations

import math


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def gaussian_delta(eps: float, sigma: float, sensitivity: float = 1.0) -> float:
    """Tight delta(eps) for one Gaussian mechanism (Eq. 1)."""
    if sigma <= 0:
        return 1.0
    a = sensitivity / sigma
    x2 = -eps / a - a / 2.0
    tail = 0.5 * math.erfc(-x2 / math.sqrt(2.0))
    if tail == 0.0:
        second = 0.0
    else:
        log_second = eps + math.log(tail)
        second = math.exp(log_second) if log_second < 700 else math.inf
    return _phi(-eps / a + a / 2.0) - second


def gaussian_eps(delta: float, sigma: float, sensitivity: float = 1.0,
                 hi: float = 1e4) -> float:
    """Invert Eq. 1: smallest eps with delta(eps) <= delta (bisection)."""
    if gaussian_delta(0.0, sigma, sensitivity) <= delta:
        return 0.0
    lo, h = 0.0, 1.0
    while gaussian_delta(h, sigma, sensitivity) > delta:
        h *= 2.0
        if h > hi:
            return math.inf
    for _ in range(100):
        mid = 0.5 * (lo + h)
        if gaussian_delta(mid, sigma, sensitivity) > delta:
            lo = mid
        else:
            h = mid
    return h


def composed_eps(delta: float, sigma: float, steps: int,
                 sensitivity: float = 1.0) -> float:
    return gaussian_eps(delta, sigma, sensitivity * math.sqrt(steps))
