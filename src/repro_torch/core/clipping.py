"""Gradient clipping (paper section 4.3): per-example, per-microbatch and
per-silo granularities and the dynamic percentile-clipping protocol. Port
of ``repro/core/clipping.py``.

Per-example clipping (DP-SGD) computes each example's gradient as a batch
of one (JAX vmaps ``x[None]``; the port loops, ``torch.autograd.grad`` per
example), writes it into its row of a ``(B, P)`` packed buffer
(``core/flatbuf.py``), and clips and sums the rows through
``kernels/dp_clip/ops.clip_and_sum_tree``: the ``packed`` route is one
``clip_sum`` launch, the ``perleaf`` route one ``per_example_sumsq_tree``
(every leaf's sums of squares, added in leaf order) and one
``clip_accumulate`` over the whole buffer. Each keeps the JAX package's clip
factor (``dp_fused/ref.clip_sum_ref`` and ``dp_clip/ref.clip_scales``:
``min(1, C / sqrt(max(ss, 1e-30)))``), which is not :func:`clip_scale`'s
``max(norm, 1e-12)``; the per-leaf route's norms are ``sqrt(ss)``.

Both granularities run over bf16 compute with fp32 weights (their
gradients are fp32, as JAX's) and over bf16 weights, a tree fp32, bf16 or
mixed. Per example, each example's bf16 gradient widens exactly into its
fp32 row, as JAX's kernels read ``g`` and widen it
(``repro/kernels/dp_clip/dp_clip.py:33,67``, ``dp_fused.py:63,76``), so
the clip-and-sum is the fp32 one. Per microbatch, JAX's ``clip_tree``
rounds each clipped group's gradient back to its leaf's dtype before the
fp32 sum (``repro/core/clipping.py:35,66``): the port scales each group's
row in fp32, rounds the row's bf16 ranges (``core/flatbuf.dtype_runs``)
to bf16 and back, then sums the rows.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch

from repro_torch.core import flatbuf, prng
from repro_torch.kernels.dp_clip import ops as clip_ops
from repro_torch.kernels.dp_clip import ref as clip_ref
from repro_torch.models import packing

PERCENTILES = (0.1, 0.25, 0.5, 0.75, 0.9)

# ``sum(t * t)`` in fp32, chunked dot products (kernels/dp_clip/ref.py)
sumsq = clip_ref.sumsq_ref


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


@contextmanager
def trainable(tensors):
    """Gradients of the weights ``tensors`` inside the block (weights made
    outside a train state do not require them), the flags restored
    after."""
    flags = [t.requires_grad for t in tensors]
    for t in tensors:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for t, f in zip(tensors, flags):
            t.requires_grad_(f)


def per_example_grads(loss_fn: Callable, params, batch: dict):
    """Every example's gradient, each example run as a batch of one:
    ``(layout, (B, P) buffer, losses (B,))``, row b example b's gradient
    packed with the layout of ``params``' tree."""
    tree = packing.param_tree(params)
    layout = flatbuf.layout_of(tree)
    tensors = flatbuf.flat_tensors(layout, tree)
    B = next(iter(batch.values())).shape[0]
    buf = torch.empty((B, layout.total), dtype=torch.float32,
                      device=tensors[0].device)
    losses = []
    with trainable(tensors):
        for b in range(B):
            loss = loss_fn(params, {k: v[b:b + 1] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, tensors,
                                        materialize_grads=True)
            with torch.no_grad():
                flatbuf.pack_tensors(layout, grads, out=buf[b])
            del grads
            losses.append(loss.detach())
    return layout, buf, torch.stack(losses)


def per_example_clipped_grad(loss_fn: Callable, params, batch: dict,
                             clip_bound, impl: str = "auto"):
    """DP-SGD per-example clipping: per-example grads, then the fused
    clip-and-sum (``dp_clip_tree``; ``auto`` is ``packed`` on the card,
    ``perleaf`` on the CPU). Returns ``(clipped sum tree fp32, pre-clip
    norms (B,), mean loss)``. ``batch`` leaves lead with the example
    axis."""
    layout, buf, losses = per_example_grads(loss_fn, params, batch)
    with torch.no_grad():
        summed, norms = clip_ops.clip_and_sum_tree(buf, clip_bound, impl,
                                                   layout=layout)
    return summed, norms, losses.mean()


def per_microbatch_clipped_grad(loss_fn: Callable, params, batch: dict,
                                clip_bound, n_micro: int):
    """Group-level clipping: the batch split into ``n_micro`` groups, each
    group's mean gradient clipped as a whole (:func:`clip_tree`), the
    clipped groups summed in order, a bf16 leaf's clipped gradient rounded
    to bf16 first (JAX's ``clip_tree``). Returns ``(summed tree fp32,
    norms (n_micro,), mean loss)``."""
    tree = packing.param_tree(params)
    layout = flatbuf.layout_of(tree)
    tensors = flatbuf.flat_tensors(layout, tree)
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} does not split into {n_micro} groups")
    m = B // n_micro
    buf = torch.empty((n_micro, layout.total), dtype=torch.float32,
                      device=tensors[0].device)
    losses, norms = [], []
    with trainable(tensors):
        for i in range(n_micro):
            loss = loss_fn(params, {k: v[i * m:(i + 1) * m]
                                    for k, v in batch.items()})
            grads = torch.autograd.grad(loss, tensors,
                                        materialize_grads=True)
            with torch.no_grad():
                norms.append(global_norm(grads))
                flatbuf.pack_tensors(layout, grads, out=buf[i])
            del grads
            losses.append(loss.detach())
    with torch.no_grad():
        norms = torch.stack(norms)
        scales = clip_scale(norms, clip_bound)
        runs = flatbuf.dtype_runs(layout, "bfloat16")
        if runs:
            buf.mul_(scales[:, None])
            for a, z in runs:
                buf[:, a:z] = buf[:, a:z].to(torch.bfloat16)
            scales = torch.ones_like(scales)
        summed = clip_ops.clipped_sum(buf, scales)
    return flatbuf.unpack(layout, summed, dtype=torch.float32), norms, \
        torch.stack(losses).mean()


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
        z = prng.normal(key)
        c = c + (torch.tensor(dp_noise_scale, dtype=torch.float32) * z
                 ).to(c.device)
    return torch.clamp(c, 1e-6, upper_bound)
