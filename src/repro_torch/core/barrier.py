"""The privacy barrier's keys and dynamic bound (paper section 4). Port of
the part of ``repro/core/barrier.py`` the fused tier reads.

* ``BarrierKeys`` / ``step_keys``: the admin's 32 bytes of keys per step,
  ``split(fold_in(root, step), 3)``, bit-equal to JAX (``core/prng.py``).
* ``dynamic_bound_from_percentiles``: the percentile bound selection.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import clipping, prng


class BarrierKeys(NamedTuple):
    """Per-step keys owned by the admin, each a raw ``(k0, k1)`` pair."""

    key_r: tuple     # pairwise zero-sum streams
    key_xi: tuple    # DP noise streams (step t)
    key_clip: tuple  # dynamic-clipping DP noise


def step_keys(root_key: tuple, step: int) -> BarrierKeys:
    kr, kx, kc = prng.split(prng.fold_in(root_key, int(step)), 3)
    return BarrierKeys(kr, kx, kc)


def dynamic_bound_from_percentiles(percentiles_all, priv: PrivacyConfig, key):
    """percentiles_all: (n_silos, n_pct). The noisy r-th percentile bound,
    capped at ``clip_percentile_max``."""
    return clipping.select_clip_bound(
        percentiles_all, priv.clip_percentile, key,
        dp_noise_scale=0.05 * priv.clip_bound,
        upper_bound=priv.clip_percentile_max)
