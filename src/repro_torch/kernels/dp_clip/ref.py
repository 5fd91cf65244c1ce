"""Plain PyTorch versions of the per-example clip kernels.

``clip_accumulate_ref`` is the explicit left fold in row order,
``acc = 0; acc = acc + g[i] * scale[i]``, one separate multiply and add per
row, as the CUDA kernel folds: on the card the two are bit-equal.
``per_example_sumsq_ref`` takes each row's sum of squares as chunked fp32
dot products (:func:`sumsq_ref`); the CUDA kernel sums in fp64, and the two
agree to about 1e-7 relative. ``per_example_sumsq_tree_ref`` is its sum
over a layout's leaves in leaf order, the tree kernel's plain version. ``clip_scales`` is the JAX package's clip
factor of the per-leaf route. The JAX package's oracles
(``repro/kernels/dp_clip/ref.py``) sum the same terms with ``jnp.sum``; the
CPU tests hold these to them within fp32 rounding.
"""
from __future__ import annotations

import torch

NORM_CHUNK = 1 << 26      # elements per dot product of a sum of squares
CPU_NORM_CHUNK = 1 << 18  # the same on the CPU (see sumsq_ref)


def sumsq_ref(t: torch.Tensor) -> torch.Tensor:
    """``sum(t * t)`` in fp32 as ``dot(c, c)`` over chunks: each chunk is
    read once and no tensor of squares is written (the chunks keep every
    call's length under 2**31). cuBLAS's dot is within about 1e-7 relative
    of an fp64 sum at any length; MKL's drifts with the chunk's length when
    it runs on few threads (single-threaded, 2.2e-5 at 2**26 and 3e-8 at
    2**18 over 12 M elements), so the CPU takes chunks of
    ``CPU_NORM_CHUNK``; the card, and the meta device that stands for it
    in ``analysis/op_cost.py``, take ``NORM_CHUNK``. torch's CPU
    ``vector_norm`` accumulates in sequence and loses 1e-4."""
    flat = t.reshape(-1).float()
    step = CPU_NORM_CHUNK if flat.device.type == "cpu" else NORM_CHUNK
    acc = None
    for a in range(0, flat.numel(), step):
        c = flat[a:a + step]
        part = torch.dot(c, c)
        acc = part if acc is None else acc + part
    return acc if acc is not None else flat.new_zeros(())


def per_example_sumsq_ref(g: torch.Tensor) -> torch.Tensor:
    """g: (B, D) -> (B,) fp32 row sums of squares."""
    return torch.stack([sumsq_ref(row) for row in g])


def per_example_sumsq_tree_ref(g: torch.Tensor, offsets, sizes,
                               per_leaf: bool = False):
    """g: (B, P) -> (B,) fp32, the leaves' columns ``g[:, off:off + size]``
    each through :func:`per_example_sumsq_ref` and added in leaf order;
    with ``per_leaf`` also the (L, B) per-leaf sums."""
    leaves = [per_example_sumsq_ref(g[:, off:off + size])
              for off, size in zip(offsets, sizes)]
    total = sum(leaves)
    return (total, torch.stack(leaves)) if per_leaf else total


def clip_accumulate_ref(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_i g[i] * scale[i]; g (n, P), scale (n,) -> (P,) fp32."""
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for i in range(g.shape[0]):
        acc = acc + g[i].float() * scale[i].float()
    return acc


def clip_scales(sumsq_total: torch.Tensor, clip_bound) -> torch.Tensor:
    """DP-SGD clip factor per example, ``min(1, C / sqrt(max(ss, 1e-30)))``,
    the division on the device (a number bound is filled in there, not
    copied from the host, which would wait for the stream)."""
    norms = torch.sqrt(torch.clamp(sumsq_total, min=1e-30))
    if isinstance(clip_bound, torch.Tensor):
        c = clip_bound.to(dtype=torch.float32, device=norms.device)
    else:
        c = torch.full((), float(clip_bound), dtype=torch.float32,
                       device=norms.device)
    return torch.clamp(c / norms, max=1.0)
