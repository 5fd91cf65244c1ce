"""Packed flat buffer: one fp32 buffer for a whole parameter tree.

Port of ``repro/core/flatbuf.py``. The DP engine clips, aggregates and
noises one ``(P,)`` buffer instead of one tensor per leaf, and the threefry
counters of the noise streams are the buffer's indices, so the layout must
be the JAX package's exactly:

* leaves in ``jax.tree.flatten`` order, which sorts dict keys;
* every leaf flattened and zero-padded to a multiple of ``LANE`` (128);
* the total zero-padded to a multiple of ``ALIGN`` (1024).

A tree here is a flat dict from the JAX path (``"layers.attn.wq"``) to a
tensor, or to a list of same-shape tensors: the JAX package stacks every
layer's weight into one ``(L, ...)`` leaf, the port keeps one tensor per
layer, so a list stands for the stacked leaf. Layer ``l`` of a stacked leaf
lands at ``offset + l * numel``, and the whole stacked leaf is padded once,
as in JAX.

The layout records each leaf's dtype, as JAX's does. ``pack`` widens every
leaf into the fp32 buffer (a bf16 leaf exactly) and can write into a given
row (one silo's row of the stacked ``(n, P)`` buffer), or into a buffer of
another dtype when asked (the packed bf16 weights of
``models.packing.pack_params``). ``unpack`` gives each leaf in the layout's
recorded dtype, or in ``dtype`` when given, as JAX's does: a leaf whose
dtype is the buffer's is a view into the buffer, not a copy; any other is
rounded to its dtype (a bf16 leaf of an fp32 buffer, to nearest even).

Per-example gradients (JAX's ``layout_of(tree, batch_dims=1)``) are the
``(B, P)`` buffer whose row b is example b's gradient packed with the
layout of one example: :func:`pack_rows` builds it from a tree of
``(B, ...)`` leaves, and the per-example clipping writes each example's
gradient straight into its row. The per-leaf engine works leaf by leaf:
:func:`leaf_slices` walks the tensors of a tree with their JAX leaf index
and their element offset inside the (stacked) leaf.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

LANE = 128      # leaf starts stay lane-aligned
ALIGN = 1024    # the padded total divides every kernel's block


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _sort_key(path: str) -> tuple:
    return tuple(path.split("."))


@dataclass(frozen=True)
class PackedLayout:
    """Static description of one tree flattened into a single fp32 buffer."""

    paths: tuple    # leaf paths in JAX order
    shapes: tuple   # JAX leaf shapes (a stacked leaf leads with its count)
    stacks: tuple   # per leaf: tensors stacked into it (0 = one tensor)
    dtypes: tuple   # per leaf: dtype name ("float32", "bfloat16"), as JAX's
    sizes: tuple
    padded: tuple
    offsets: tuple
    total: int      # padded buffer length (multiple of ALIGN)

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def n_params(self) -> int:
        return sum(self.sizes)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: JAX's ``jnp.dtype(x).name``."""
    return str(dtype).removeprefix("torch.")


def layout_of(tree: dict) -> PackedLayout:
    if not tree:
        raise ValueError("cannot build a PackedLayout for an empty tree")
    paths, shapes, stacks, dtypes = [], [], [], []
    for path in sorted(tree, key=_sort_key):  # jax.tree.flatten's order
        leaf = tree[path]
        if isinstance(leaf, (list, tuple)):
            shape = tuple(leaf[0].shape)
            if any(tuple(t.shape) != shape for t in leaf):
                raise ValueError(f"{path}: stacked tensors differ in shape")
            if any(t.dtype != leaf[0].dtype for t in leaf):
                raise ValueError(f"{path}: stacked tensors differ in dtype")
            shapes.append((len(leaf),) + shape)
            stacks.append(len(leaf))
            dtypes.append(dtype_name(leaf[0].dtype))
        else:
            shapes.append(tuple(leaf.shape))
            stacks.append(0)
            dtypes.append(dtype_name(leaf.dtype))
        paths.append(path)
    return build_layout(paths, shapes, stacks, dtypes)


def build_layout(paths, shapes, stacks, dtypes=None) -> PackedLayout:
    """The layout of leaves ``paths`` (in JAX order) with ``shapes``,
    ``stacks`` and ``dtypes`` (see :class:`PackedLayout`; fp32 leaves when
    None): offsets, padding and total. The dtypes move no offset."""
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    sizes = tuple(math.prod(s) if s else 1 for s in shapes)
    padded = tuple(_round_up(max(s, 1), LANE) for s in sizes)
    offsets, off = [], 0
    for p in padded:
        offsets.append(off)
        off += p
    dtypes = ("float32",) * len(shapes) if dtypes is None \
        else tuple(str(d) for d in dtypes)
    return PackedLayout(tuple(paths), shapes, tuple(int(k) for k in stacks),
                        dtypes, sizes, padded, tuple(offsets),
                        _round_up(off, ALIGN))


@functools.lru_cache(maxsize=64)
def dtype_runs(layout: PackedLayout, dtype: str) -> tuple:
    """The ``(start, end)`` ranges of the (P,) buffer that the leaves of
    ``dtype`` (a name, ``"bfloat16"``) and their padding span, adjacent
    leaves merged into one range, in buffer order; a range that ends at
    the last leaf takes the buffer's tail padding too, so a tree of one
    dtype is the one range ``(0, total)``."""
    runs: list = []
    for dt, off, pad in zip(layout.dtypes, layout.offsets, layout.padded):
        if dt != dtype:
            continue
        if runs and runs[-1][1] == off:
            runs[-1][1] = off + pad
        else:
            runs.append([off, off + pad])
    if runs and runs[-1][1] == layout.offsets[-1] + layout.padded[-1]:
        runs[-1][1] = layout.total
    return tuple((a, z) for a, z in runs)


def flat_tensors(layout: PackedLayout, tree: dict) -> list:
    """Every tensor of ``tree`` in buffer order (stacked leaves expanded)."""
    out = []
    for path, k in zip(layout.paths, layout.stacks):
        leaf = tree[path]
        out.extend(leaf if k else [leaf])
    return out


def pack_tensors(layout: PackedLayout, tensors,
                 out: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Copy ``tensors`` (in :func:`flat_tensors` order) into one fp32
    ``(total,)`` buffer, ``out`` when given (contiguous, fp32), with every
    padding position exactly zero. A bf16 tensor widens exactly. ``dtype``
    names another buffer dtype (``out``'s, when given)."""
    tensors = list(tensors)
    if out is None:
        out = torch.empty(layout.total, dtype=dtype,
                          device=tensors[0].device)
    if out.shape != (layout.total,) or out.dtype != dtype \
            or not out.is_contiguous():
        raise ValueError(f"pack target must be contiguous {dtype} "
                         f"({layout.total},), got {out.dtype} {tuple(out.shape)}")
    it = iter(tensors)
    for shape, k, size, pad, off in zip(layout.shapes, layout.stacks,
                                        layout.sizes, layout.padded,
                                        layout.offsets):
        part = size // k if k else size
        for j in range(k or 1):
            t = next(it)
            if t.numel() != part:
                raise ValueError(f"tensor of {t.numel()} elements where the "
                                 f"layout has {part} (leaf shape {shape})")
            out[off + j * part:off + (j + 1) * part].copy_(t.reshape(-1))
    if next(it, None) is not None:
        raise ValueError("more tensors than the layout has leaves")
    return zero_padding(layout, out)


@functools.lru_cache(maxsize=64)
def padding_index(layout: PackedLayout, device: torch.device) -> torch.Tensor:
    """Every padding position of the layout's (P,) buffer, ascending, as an
    int64 tensor on ``device``: built and copied once per layout and
    device."""
    ends = [(off + size, off + pad) for size, pad, off
            in zip(layout.sizes, layout.padded, layout.offsets)]
    ends.append((layout.offsets[-1] + layout.padded[-1], layout.total))
    idx = torch.cat([torch.arange(a, z, dtype=torch.int64) for a, z in ends])
    return idx.to(device)


def zero_padding(layout: PackedLayout, buf: torch.Tensor) -> torch.Tensor:
    """Set every padding position of ``buf`` (P,) to zero, in place (a noisy
    aggregate carries noise there, which no leaf reads): one fill over
    :func:`padding_index`, not a launch a leaf."""
    if buf.shape != (layout.total,):
        raise ValueError(f"buf {tuple(buf.shape)}, the layout's packed "
                         f"buffer is ({layout.total},)")
    return buf.index_fill_(0, padding_index(layout, buf.device), 0.0)


def pack(layout: PackedLayout, tree: dict,
         out: Optional[torch.Tensor] = None,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return pack_tensors(layout, flat_tensors(layout, tree), out, dtype)


def pack_rows(layout: PackedLayout, tree: dict) -> torch.Tensor:
    """A tree of ``(B, ...)`` per-example leaves (a stacked leaf a list of
    them) -> the ``(B, P)`` buffer, row b packed from example b; ``layout``
    is one example's. Equal to JAX's ``pack(layout_of(tree, batch_dims=1),
    tree)``."""
    tensors = flat_tensors(layout, tree)
    B = tensors[0].shape[0]
    out = torch.empty((B, layout.total), dtype=torch.float32,
                      device=tensors[0].device)
    for b in range(B):
        pack_tensors(layout, [t[b] for t in tensors], out=out[b])
    return out


def leaf_slices(layout: PackedLayout, tree: dict):
    """``(i, offset, tensor)`` for every tensor of ``tree`` in buffer order:
    ``i`` its leaf's index in JAX's order, ``offset`` the element at which
    it starts inside that leaf (``l * numel`` for layer l of a stacked
    leaf, 0 otherwise)."""
    for i, (path, k, size) in enumerate(zip(layout.paths, layout.stacks,
                                            layout.sizes)):
        leaf = tree[path]
        for j, t in enumerate(leaf if k else [leaf]):
            yield i, j * (size // k if k else size), t


def leaf_table(layout: PackedLayout, dtype: Optional[str] = None) -> tuple:
    """One row per tensor of the layout's tree, in :func:`leaf_slices`
    order: ``(buffer offset, numel, leaf index i, counter offset inside the
    leaf mod 2**32, start in the prefix of all tensors' elements)``. What
    the one-launch perleaf mask (``kernels/zsmask``'s ``zsmask_buffer``)
    walks, its device copy cached there; padding is in no row. ``dtype``
    (a name, ``"bfloat16"``) keeps the tensors of that dtype's leaves
    only, the prefix over them alone."""
    rows, start = [], 0
    for i, (k, size, off) in enumerate(zip(layout.stacks, layout.sizes,
                                           layout.offsets)):
        if dtype is not None and layout.dtypes[i] != dtype:
            continue
        m = size // k if k else size
        for j in range(k or 1):
            rows.append((off + j * m, m, i, (j * m) & 0xFFFFFFFF, start))
            start += m
    return tuple(rows)


def map_leaf_slices(layout: PackedLayout, tree: dict, fn) -> dict:
    """The tree of ``fn(i, offset, tensor)`` over :func:`leaf_slices`, in
    ``tree``'s structure."""
    out: dict = {}
    it = leaf_slices(layout, tree)
    for path, k in zip(layout.paths, layout.stacks):
        parts = [fn(*next(it)) for _ in range(k or 1)]
        out[path] = parts if k else parts[0]
    return out


def unpack(layout: PackedLayout, buf: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> dict:
    """The tree of ``buf`` (lists of per-layer tensors for the stacked
    leaves), shaped as the layout's leaves, each in the layout's recorded
    dtype or in ``dtype`` when given (JAX's ``unpack``): views into ``buf``
    where that is ``buf``'s dtype, rounded copies otherwise."""
    if buf.shape != (layout.total,):
        raise ValueError(f"buffer {tuple(buf.shape)}, layout ({layout.total},)")
    want = dtype_name(dtype) if dtype is not None else None
    have = dtype_name(buf.dtype)
    tree = {}
    for path, shape, k, dt, size, off in zip(
            layout.paths, layout.shapes, layout.stacks, layout.dtypes,
            layout.sizes, layout.offsets):
        piece = buf[off:off + size].view(shape)
        dt = want or dt
        if dt != have:
            piece = piece.to(getattr(torch, dt))
        tree[path] = list(piece.unbind(0)) if k else piece
    return tree
