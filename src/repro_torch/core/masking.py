"""Zero-sum DP masking (paper section 4.2) over gradient trees: the
key-derived pairwise construction. Port of the pairwise part of
``repro/core/masking.py``.

``m_i = B (r_i - r_{(i+1) mod n}) + xi_i`` with ``xi_i`` of std
``sigma_c / sqrt(n)``, every stream drawn from 8-byte per-step keys:
telescoping gives ``sum_i m_i = xi`` exactly. The tree-level kernel
``zsmask_tree`` has two variants that draw different, equally valid, stream
families, so every silo of a session must resolve to the same one:

* ``packed``: the whole tree as one flat buffer, one ``clip_mask`` launch,
  the global packed index as the counter (``dp_fused/ops.packed_mask_tree``);
* ``perleaf``: one ``zsmask`` launch per leaf (per tensor of a stacked
  leaf, at its counter offset), the leaf index i folded into both words of
  each key: ``k + 0x9E3779B9 * (i + 1)`` for ``key_r`` and
  ``k + 0x85EBCA6B * (i + 1)`` for ``key_xi``, uint32, in JAX's leaf order.

Not ported yet: the admin masks (``admin_masks``, ``admin_mask_row``,
``admin_xi``) and the integer-ring masks (``ROADMAP.md`` queue 1, item 9).
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels.dispatch import on_cuda, resolve_tree
from repro_torch.kernels.dp_fused import ops as fused_ops
from repro_torch.kernels.zsmask import ops as zs_ops
from repro_torch.kernels.zsmask.threefry import M32

TREE = "zsmask_tree"
R_FOLD, XI_FOLD = 0x9E3779B9, 0x85EBCA6B


def _raw(key) -> tuple:
    """``(k0, k1)`` ints of a raw key: a pair, a numpy array or a tensor."""
    k0, k1 = (int(k) for k in key)
    return k0 & M32, k1 & M32


def fold_leaf(key, mult: int, i: int) -> tuple:
    """Leaf i's key: ``key + mult * (i + 1)`` on both uint32 words."""
    d = (mult * (i + 1)) & M32
    k0, k1 = _raw(key)
    return (k0 + d) & M32, (k1 + d) & M32


def mask_leaf(g, key_r, key_xi, i: int, offset: int, silo: int, n_silos: int,
              sigma_c, b_scale, out=None):
    """Leaf i's mask applied to one flat tensor of it, ``offset`` its first
    element inside the leaf: one ``zsmask`` dispatch."""
    return zs_ops.apply_zsmask(g, fold_leaf(key_r, R_FOLD, i),
                               fold_leaf(key_xi, XI_FOLD, i), silo, n_silos,
                               sigma_c, b_scale, offset=offset, out=out)


def _mask_tree_perleaf(grads, key_r, key_xi, silo, n_silos, sigma_c, b_scale):
    layout = flatbuf.layout_of(grads)

    def one(i, offset, g):
        flat = g.reshape(-1)
        out = mask_leaf(flat, key_r, key_xi, i, offset, silo, n_silos,
                        sigma_c, b_scale)
        return out.reshape(g.shape).to(g.dtype)

    return flatbuf.map_leaf_slices(layout, grads, one)


def pairwise_mask_tree(grads, key_r, key_xi, silo: int, n_silos: int,
                       sigma_c, b_scale, impl: str = "auto"):
    """``m_silo`` applied to every leaf of ``grads`` (a flat tree; keys are
    per step). ``auto``: packed on the card, perleaf on the CPU."""
    first = flatbuf.flat_tensors(flatbuf.layout_of(grads), grads)[0]
    if resolve_tree(TREE, impl, on_cuda(first)) == "packed":
        return fused_ops.packed_mask_tree(grads, _raw(key_r), _raw(key_xi),
                                          silo, n_silos, sigma_c, b_scale)
    return _mask_tree_perleaf(grads, key_r, key_xi, silo, n_silos, sigma_c,
                              b_scale)


def pairwise_mask_only(shapes_tree, key_r, key_xi, silo: int, n_silos: int,
                       sigma_c, b_scale, impl: str = "jnp"):
    """The mask alone: :func:`pairwise_mask_tree` over zeros shaped as
    ``shapes_tree``. ``impl`` defaults to the legacy ``jnp`` (perleaf), as
    in JAX."""
    zeros = {k: [torch.zeros_like(t, dtype=torch.float32) for t in v]
             if isinstance(v, list) else torch.zeros_like(v, dtype=torch.float32)
             for k, v in shapes_tree.items()}
    return pairwise_mask_tree(zeros, key_r, key_xi, silo, n_silos, sigma_c,
                              b_scale, impl=impl)
