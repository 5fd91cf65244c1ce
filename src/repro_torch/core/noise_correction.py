"""DP noise correction state (paper section 4.4). Port of the part of
``repro/core/noise_correction.py`` the fused tier reads.

Noise added at step t is ``xi_t - lambda * xi_{t-1}``. The state carries
only the 32-byte key that generated ``xi_{t-1}`` (not the O(P) tensor), and
the noise kernels regenerate ``xi_{t-1}`` from it on the fly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class NoiseState(NamedTuple):
    prev_key: tuple    # (k0, k1): the key that generated xi_{t-1}
    has_prev: bool     # the first step has no xi_{t-1}
    # (n_silos,) bool: which silos contributed xi_{t-1}; None = all of them
    prev_active: Optional[np.ndarray] = None


def init_state(key: tuple, n_silos: int = 0) -> NoiseState:
    """``n_silos > 0`` allocates the participation memory; 0 keeps the
    legacy two-field state (all silos implicitly active)."""
    prev_active = np.ones(n_silos, bool) if n_silos else None
    return NoiseState(prev_key=(int(key[0]), int(key[1])), has_prev=False,
                      prev_active=prev_active)
