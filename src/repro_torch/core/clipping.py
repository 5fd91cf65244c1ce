"""Gradient clipping and the dynamic percentile-clipping protocol (paper
section 4.3). Port of the part of ``repro/core/clipping.py`` the fused and
barrier tiers run: global norms and clipping of gradient trees, per-silo
clip factors and the admin's noisy percentile bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import prng

PERCENTILES = (0.1, 0.25, 0.5, 0.75, 0.9)
NORM_CHUNK = 1 << 26      # elements per dot product of a sum of squares
CPU_NORM_CHUNK = 1 << 18  # the same on the CPU (see sumsq)


def sumsq(t: torch.Tensor) -> torch.Tensor:
    """``sum(t * t)`` in fp32 as ``dot(c, c)`` over chunks: each chunk is
    read once and no tensor of squares is written (the chunks keep every
    call's length under 2**31). cuBLAS's dot is within about 1e-7 relative
    of an fp64 sum at any length; MKL's drifts with the chunk's length when
    it runs on few threads (single-threaded, 2.2e-5 at 2**26 and 3e-8 at
    2**18 over 12 M elements), so the CPU takes chunks of
    ``CPU_NORM_CHUNK``. torch's CPU ``vector_norm`` accumulates in sequence
    and loses 1e-4."""
    flat = t.reshape(-1).float()
    step = NORM_CHUNK if flat.is_cuda else CPU_NORM_CHUNK
    acc = None
    for a in range(0, flat.numel(), step):
        c = flat[a:a + step]
        part = torch.dot(c, c)
        acc = part if acc is None else acc + part
    return acc if acc is not None else flat.new_zeros(())


def _leaves(tree):
    """The tensors of a tree in JAX's leaf order: a dict's keys sorted by
    path (``jax.tree.flatten``), a list or tuple in its order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=lambda p: tuple(str(p).split("."))):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every tensor of a tree (a flat or nested dict, a list
    standing for a stacked leaf, or a list of tensors): the per-leaf sums of
    squares (:func:`sumsq`) added in leaf order, as JAX sums them."""
    total = None
    for leaf in _leaves(tree):
        s = sumsq(leaf)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_tree(tree, clip_bound) -> tuple:
    """Scale the whole tree to norm <= ``clip_bound``. Returns
    ``(clipped tree, pre-clip norm)``: the tree with the same structure,
    every tensor multiplied by the one clip factor."""
    norm = global_norm(tree)
    scale = clip_scale(norm, clip_bound)

    def scaled(node):
        if isinstance(node, dict):
            return {k: scaled(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(scaled(v) for v in node)
        return (node.float() * scale).to(node.dtype)

    return scaled(tree), norm


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
