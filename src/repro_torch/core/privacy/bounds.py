"""Closed-form DP bounds (paper section 4.1, Appendix A). The port's copy of
``repro/core/privacy/bounds.py``, as it is: pure Python float math, so the
same arguments give the JAX package's floats bit for bit.

* the tight analytic Gaussian-mechanism bound (Eq. 1, Balle-Wang), its
  inverse, T-fold full-batch composition (D -> sqrt(T) * D) and the
  calibration of sigma by bisection;
* Theorem 1: the noise-corrected mechanism is plain DP-GD at
  sigma~ = (1 - lambda) * sigma;
* Eq. 14: the sensitivity of n subsequent updates under noise correction;
* RDP of the (Poisson-subsampled) Gaussian mechanism at integer orders
  (Mironov et al.), for minibatch DP-SGD, and its conversion to (eps,
  delta).

The stateful accounting on top lives in :mod:`repro_torch.core.privacy.ledger`.
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
    # exp(eps) * Phi(-eps/a - a/2) in log space (erfc keeps the tail)
    x2 = -eps / a - a / 2.0
    tail = 0.5 * math.erfc(-x2 / math.sqrt(2.0))
    if tail == 0.0:
        second = 0.0
    else:
        log_second = eps + math.log(tail)
        second = math.exp(log_second) if log_second < 700 else math.inf
    return _phi(-eps / a + a / 2.0) - second


def composed_delta(eps: float, sigma: float, steps: int, sensitivity: float = 1.0) -> float:
    """T-fold composition of the full-batch Gaussian mechanism."""
    return gaussian_delta(eps, sigma, sensitivity * math.sqrt(steps))


def corrected_delta(eps: float, sigma: float, steps: int, lam: float) -> float:
    """Theorem 1: the noise-corrected mechanism's (eps, delta) upper bound is
    the plain composition at sigma~ = (1 - lambda) * sigma."""
    if not (0.0 <= lam < 1.0):
        raise ValueError("lambda must be in [0, 1)")
    return composed_delta(eps, (1.0 - lam) * sigma, steps)


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


def composed_eps(delta: float, sigma: float, steps: int, sensitivity: float = 1.0) -> float:
    return gaussian_eps(delta, sigma, sensitivity * math.sqrt(steps))


def calibrate_sigma(eps: float, delta: float, steps: int = 1,
                    sensitivity: float = 1.0) -> float:
    """Smallest sigma giving (eps, delta)-DP after ``steps`` full-batch
    iterations (analytic calibration, bisection on Eq. 1)."""
    s = sensitivity * math.sqrt(steps)
    lo, hi = 1e-6, 1.0
    while gaussian_delta(eps, hi, s) > delta:
        hi *= 2.0
        if hi > 1e8:
            raise ValueError("cannot calibrate")
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if gaussian_delta(eps, mid, s) > delta:
            lo = mid
        else:
            hi = mid
    return hi


# ---------------------------------------------------------------------------
# Appendix A.3: sensitivity of n *subsequent* updates under noise correction


def sequence_sensitivity(n: int, lam: float) -> float:
    """Eq. 14: sqrt( sum_{l=0}^{n-1} (sum_{j=0}^{l} lam^j)^2 )."""
    total = 0.0
    geo = 0.0
    for ell in range(n):
        geo += lam ** ell  # sum_{j<=ell} lam^j
        total += geo * geo
    return math.sqrt(total)


def sequence_eps(delta: float, sigma: float, n: int, lam: float) -> float:
    """eps protecting a window of n subsequent updates (Fig. 14). Plain DP-GD
    is the lam=0 case (sensitivity sqrt(n))."""
    return gaussian_eps(delta, sigma, sequence_sensitivity(n, lam))


# ---------------------------------------------------------------------------
# RDP (minibatch DP-SGD with Poisson sampling rate q)

DEFAULT_ORDERS = tuple([1 + x / 10.0 for x in range(1, 100)] + list(range(12, 64)))


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def rdp_gaussian(alpha: float, sigma: float) -> float:
    return alpha / (2.0 * sigma * sigma)


def rdp_subsampled_gaussian(alpha: int, sigma: float, q: float) -> float:
    """Integer-order RDP of the Poisson-subsampled Gaussian (Mironov et al.
    2019, Thm 11 form via the binomial expansion)."""
    if q == 0.0:
        return 0.0
    if q == 1.0:
        return rdp_gaussian(alpha, sigma)
    logs = []
    for j in range(alpha + 1):
        log_term = (_log_comb(alpha, j) + j * math.log(q)
                    + (alpha - j) * math.log1p(-q)
                    + (j * j - j) / (2.0 * sigma * sigma))
        logs.append(log_term)
    m = max(logs)
    s = sum(math.exp(x - m) for x in logs)
    return (m + math.log(s)) / (alpha - 1)


def rdp_to_eps(rdp: float, alpha: float, delta: float) -> float:
    """Tight-ish conversion (Balle et al. 2020 / Canonne et al.)."""
    if alpha <= 1:
        return math.inf
    return rdp + math.log1p(-1.0 / alpha) - (math.log(delta) + math.log(alpha)) / (alpha - 1)
