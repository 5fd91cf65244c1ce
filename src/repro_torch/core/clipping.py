"""Gradient clipping and the dynamic percentile-clipping protocol (paper
section 4.3). Port of the part of ``repro/core/clipping.py`` the fused tier
runs: per-silo clip factors and the admin's noisy percentile bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import prng

PERCENTILES = (0.1, 0.25, 0.5, 0.75, 0.9)


def global_norm(tree: dict) -> torch.Tensor:
    """L2 norm over every tensor of a flat tree (stacked leaves included)."""
    total = None
    for leaf in tree.values():
        for t in (leaf if isinstance(leaf, (list, tuple)) else [leaf]):
            s = torch.sum(torch.square(t.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, clip_bound) -> torch.Tensor:
    """DP-SGD clip factor ``min(1, C / max(||g||, 1e-12))``, the one shared
    definition; ``norm`` may be a scalar or a vector of norms."""
    return torch.clamp(clip_bound / torch.clamp(norm, min=1e-12), max=1.0)


def _linear_quantile(xs: torch.Tensor, qs: torch.Tensor, count) -> torch.Tensor:
    """Linear-interpolation quantiles of the first ``count`` entries of the
    sorted ``xs``, in ``jnp.quantile``'s arithmetic."""
    pos = qs * (count - 1).to(torch.float32)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    frac = pos - lo
    return xs[lo.long()] * (1.0 - frac) + xs[hi.long()] * frac


def masked_quantile(x: torch.Tensor, qs, mask: torch.Tensor) -> torch.Tensor:
    """Linear quantiles restricted to the ``mask``-selected entries:
    inactive entries sort as +inf and never reach the result."""
    xs = torch.sort(torch.where(mask, x.float(),
                                torch.full_like(x, float("inf"),
                                                dtype=torch.float32))).values
    k = torch.clamp(mask.to(torch.int32).sum(), min=1)
    qs = torch.as_tensor(qs, dtype=torch.float32, device=x.device)
    return _linear_quantile(xs, qs, k)


def local_percentiles(norms: torch.Tensor, percentiles=PERCENTILES,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Silo side: the norms at the agreed percentiles (sent to the admin)."""
    if mask is None:
        mask = torch.ones_like(norms, dtype=torch.bool)
    return masked_quantile(norms, percentiles, mask)


def select_clip_bound(all_percentiles: torch.Tensor, r: float, key,
                      dp_noise_scale: float = 0.0,
                      upper_bound: float = float("inf")) -> torch.Tensor:
    """Admin side: the r-th percentile of the pooled summaries, plus DP
    noise ``dp_noise_scale * normal(key)``, clipped to
    ``[1e-6, upper_bound]``. ``key`` is a raw ``(k0, k1)`` key."""
    pooled = torch.sort(all_percentiles.reshape(-1).float()).values
    n = torch.tensor(pooled.numel(), device=pooled.device)
    q = torch.tensor([r], dtype=torch.float32, device=pooled.device)
    c = _linear_quantile(pooled, q, n)[0]
    if dp_noise_scale > 0.0:
        z = torch.tensor(prng.normal(key), dtype=torch.float32)
        c = c + (torch.tensor(dp_noise_scale, dtype=torch.float32) * z
                 ).to(c.device)
    return torch.clamp(c, 1e-6, upper_bound)
