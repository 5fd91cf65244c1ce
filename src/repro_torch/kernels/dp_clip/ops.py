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
from repro_torch.kernels.dp_clip.dp_clip import (clip_accumulate_cuda,
                                                 per_example_sumsq_cuda)
from repro_torch.kernels.dp_fused import ops as fused_ops

TREE = "dp_clip_tree"


def clip_accumulate(g, scale):
    """sum_i g[i] * scale[i] over a stacked (n, P) buffer -> (P,) fp32: the
    fused tier's masked aggregate (n = silos, P = the packed length) and
    the per-leaf clipped sum (n = examples, P = one leaf's columns)."""
    if on_cuda(g, scale):
        return clip_accumulate_cuda(g, scale)
    return ref.clip_accumulate_ref(g, scale)


clipped_sum = clip_accumulate  # the JAX package's name for it


def sumsq(g):
    """Per-example sums of squares of a (B, D) block -> (B,) fp32."""
    if on_cuda(g):
        return per_example_sumsq_cuda(g)
    return ref.per_example_sumsq_ref(g)


def _clip_and_sum_perleaf(buf, clip_bound, layout):
    """Per-leaf route: 2 launches per leaf. Each leaf's columns of the
    (B, P) buffer are read in place; the per-leaf sums of squares add up,
    in leaf order, to each example's squared norm, then each leaf is scaled
    and summed over the examples."""
    cols = [buf[:, off:off + size]
            for off, size in zip(layout.offsets, layout.sizes)]
    total = sum(sumsq(c) for c in cols)
    scale = ref.clip_scales(total, clip_bound)
    summed = torch.empty(layout.total, dtype=torch.float32, device=buf.device)
    for off, size, c in zip(layout.offsets, layout.sizes, cols):
        summed[off:off + size] = clipped_sum(c, scale)
    flatbuf.zero_padding(layout, summed)
    return flatbuf.unpack(layout, summed), torch.sqrt(total)


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
