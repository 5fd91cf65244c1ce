"""Public per-example clip API: each tensor-level kernel runs its CUDA
kernel on CUDA tensors and its plain version on CPU tensors
(``kernels.dispatch.on_cuda``); the tree-level ``clip_and_sum_tree``
chooses between the packed and the per-leaf route
(``kernels.dispatch.resolve_tree``, kernel ``dp_clip_tree``), as
``repro/kernels/dp_clip/ops.py`` does."""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels.dispatch import on_cuda, resolve_tree
from repro_torch.kernels.dp_clip import ref
from repro_torch.kernels.dp_clip.dp_clip import (
    clip_accumulate_cuda, per_example_sumsq_cuda, per_example_sumsq_tree_cuda)
from repro_torch.kernels.dp_fused import ops as fused_ops

TREE = "dp_clip_tree"


def clip_accumulate(g, scale, out=None):
    """sum_i g[i] * scale[i] over a stacked (n, P) buffer -> (P,) fp32: the
    fused tier's masked aggregate (n = silos, P = the packed length) and
    the per-leaf route's clipped sum (n = examples, every column of the
    per-example buffer), written into ``out`` when given."""
    if on_cuda(g, scale):
        return clip_accumulate_cuda(g, scale, out=out)
    res = ref.clip_accumulate_ref(g, scale)
    return res if out is None else out.copy_(res)


clipped_sum = clip_accumulate  # the JAX package's name for it


def sumsq(g):
    """Per-example sums of squares of a (B, D) block -> (B,) fp32."""
    if on_cuda(g):
        return per_example_sumsq_cuda(g)
    return ref.per_example_sumsq_ref(g)


def sumsq_tree(buf, layout, per_leaf: bool = False):
    """Per-example squared norms of a (B, P) buffer of ``layout``: each
    leaf's columns' sums of squares (:func:`sumsq`), added in leaf order ->
    (B,) fp32; with ``per_leaf`` also the (L, B) per-leaf sums. One
    dispatch (two device launches on the card)."""
    if on_cuda(buf):
        return per_example_sumsq_tree_cuda(buf, layout, per_leaf)
    return ref.per_example_sumsq_tree_ref(buf, layout.offsets, layout.sizes,
                                          per_leaf)


def _clip_and_sum_perleaf(buf, clip_bound, layout):
    """Per-leaf route: the per-leaf sums of squares of the (B, P) buffer,
    read in place and added in leaf order to each example's squared norm
    (:func:`sumsq_tree`), then every column scaled and summed over the
    examples (:func:`clip_accumulate`, each column folded on its own: the
    leaves' columns as a launch a leaf would give them), the padding
    zeroed. Two dispatches."""
    total = sumsq_tree(buf, layout)
    scale = ref.clip_scales(total, clip_bound)
    summed = clip_accumulate(buf, scale, out=torch.empty(
        layout.total, dtype=torch.float32, device=buf.device))
    flatbuf.zero_padding(layout, summed)
    return flatbuf.unpack(layout, summed, dtype=torch.float32), \
        torch.sqrt(total)


def clip_and_sum_tree(grads, clip_bound, impl: str = "auto", layout=None):
    """Per-example clip of per-example gradients: a tree of ``(B, ...)``
    leaves, or their ``(B, P)`` packed buffer with one example's ``layout``.
    Returns the clipped *sum* tree (fp32; views into one buffer) and the
    per-example pre-clip norms."""
    if layout is None:
        layout = flatbuf.layout_of({k: (v[0] if not isinstance(v, list)
                                        else [t[0] for t in v])
                                    for k, v in grads.items()})
        grads = flatbuf.pack_rows(layout, grads)
    if resolve_tree(TREE, impl, on_cuda(grads)) == "packed":
        return fused_ops.packed_clip_and_sum(grads, clip_bound, layout)
    return _clip_and_sum_perleaf(grads, clip_bound, layout)
