"""CUDA wrappers of the per-example clip kernels: the masked aggregate
(``clip_accumulate``) and the per-example sums of squares
(``per_example_sumsq`` of one leaf, ``per_example_sumsq_tree`` of every
leaf in one call).

The kernels are in ``csrc/clip_accumulate.cu`` and ``csrc/sumsq.cu`` (each
header says which TPU kernel it replaces, what bounds it on an H100, and
how the design answers that). A wrapper checks what its kernel takes,
allocates the output and scratch, launches on the current stream, raises
on a CUDA error and counts the launch. The first two take a (B, D) matrix
whose rows may lie apart (one leaf's columns of the (B, P) per-example
buffer); the tree kernel takes the whole buffer and a table of its leaves
(:func:`sumsq_table`), copied to the card once per layout, row count and
alignment. CUDA tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_rows, check_tensor, register,
                                          require)

CLIP_ACCUMULATE = register(
    "clip_accumulate",
    "src/repro_torch/kernels/dp_clip/csrc/clip_accumulate.cu",
    "src/repro/kernels/dp_clip/dp_clip.py:77")
PER_EXAMPLE_SUMSQ = register(
    "per_example_sumsq",
    "src/repro_torch/kernels/dp_clip/csrc/sumsq.cu",
    "src/repro/kernels/dp_clip/dp_clip.py:42")

PER_EXAMPLE_SUMSQ_TREE = register(
    "per_example_sumsq_tree",
    "src/repro_torch/kernels/dp_clip/csrc/sumsq.cu",
    "src/repro/kernels/dp_clip/dp_clip.py:42")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CLIP_ACCUMULATE = _build.Entry("clip_accumulate_f32",
                                [_P, _P, _P, _I, _L, _L, _I, _P])
_SUMSQ = _build.Entry("per_example_sumsq_f32",
                      [_P, _P, _P, _I, _L, _L, _I, _I, _P])
_SUMSQ_TREE = _build.Entry("per_example_sumsq_tree_f32",
                           [_P, _L, _I, _P, _I, _L, _P, _P, _P, _P])
RS_THREADS = 256  # csrc/rowsq.cuh
MAX_ROWS = 65535  # the grid's y extent
MAX_LEAVES = 12288  # the tree's per-leaf sums in 48 KB of shared memory


def vec_ok(ld: int, D: int, *tensors) -> int:
    """1 when the kernels may load 16 bytes a thread: D and the row stride
    multiples of 4, every pointer 16-byte aligned."""
    return int(D % 4 == 0 and ld % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def row_blocks(B: int, D: int, device: torch.device) -> int:
    """Blocks per row of the sum-of-squares pass: enough for 8 resident
    blocks an SM over all B rows, at least 8 elements a thread."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-D // (RS_THREADS * 8))
    return max(1, min(want, (sms * 8) // B))


def clip_accumulate_cuda(g: torch.Tensor, scale: torch.Tensor,
                         out=None) -> torch.Tensor:
    """Launch the kernel: g (n, P) fp32, rows contiguous (they may lie
    apart), scale (n,) fp32 -> (P,) fp32, written into ``out`` when given
    (contiguous, disjoint from g)."""
    dev = g.device
    require(dev.type == "cuda", "clip_accumulate_cuda takes CUDA tensors")
    ld = check_rows("g", g, dev)
    check_tensor("scale", scale, torch.float32, 1, dev)
    n, P = g.shape
    require(scale.shape == (n,), f"scale {tuple(scale.shape)}, expected ({n},)")
    require(n >= 1, "clip_accumulate needs at least one row")
    if out is None:
        out = torch.empty(P, dtype=torch.float32, device=dev)
    check_tensor("out", out, torch.float32, 1, dev)
    if out.shape != (P,):
        raise ValueError(f"out {tuple(out.shape)}, expected ({P},)")
    if P == 0:
        return out
    err = _CLIP_ACCUMULATE.launch(dev, g.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), n, P, ld,
                                  vec_ok(ld, P, g, out))
    _build.check(err, "clip_accumulate")
    CLIP_ACCUMULATE.launches += 1
    return out


def per_example_sumsq_cuda(g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: g (B, D) fp32, rows contiguous (they may lie
    apart) -> (B,) fp32 row sums of squares."""
    dev = g.device
    require(dev.type == "cuda", "per_example_sumsq_cuda takes CUDA tensors")
    ld = check_rows("g", g, dev)
    B, D = g.shape
    require(1 <= B <= MAX_ROWS, f"per_example_sumsq takes 1 to {MAX_ROWS} "
                                f"rows, got {B}")
    out = torch.empty(B, dtype=torch.float32, device=dev)
    nblk = row_blocks(B, D, dev)
    partial = torch.empty(B * nblk, dtype=torch.float64, device=dev)
    err = _SUMSQ.launch(dev, g.data_ptr(), out.data_ptr(), partial.data_ptr(),
                        B, D, ld, vec_ok(ld, D, g), nblk)
    _build.check(err, "per_example_sumsq")
    PER_EXAMPLE_SUMSQ.launches += 1
    return out


@functools.lru_cache(maxsize=32)
def sumsq_table(layout, B: int, aligned: bool, device: torch.device) -> tuple:
    """``(table, blocks)``: one row a leaf of ``layout``, ``(column offset,
    D, vec, nblk, first block)`` as an (L, 5) int64 tensor on ``device``,
    and the blocks of pass 1 over B rows. ``vec`` and ``nblk`` are what
    ``per_example_sumsq_cuda`` picks for that leaf's columns (``vec_ok``
    with the buffer's base 16-byte aligned and its row stride a multiple
    of 4 when ``aligned``, :func:`row_blocks`); a leaf's first block is
    also its first partial. Built and copied once per (layout, B,
    aligned, card)."""
    rows, first = [], 0
    for off, D in zip(layout.offsets, layout.sizes):
        nblk = row_blocks(B, D, device)
        vec = int(aligned and D % 4 == 0 and off % 4 == 0)
        rows.append((off, D, vec, nblk, first))
        first += B * nblk
    require(len(rows) <= MAX_LEAVES, f"per_example_sumsq_tree takes at most "
                                     f"{MAX_LEAVES} leaves, the layout has "
                                     f"{len(rows)}")
    return torch.tensor(rows, dtype=torch.int64).to(device), first


def per_example_sumsq_tree_cuda(buf: torch.Tensor, layout,
                                per_leaf: bool = False):
    """Launch the tree kernel: ``buf`` the (B, P) fp32 per-example buffer
    of ``layout`` (rows contiguous, they may lie apart) -> the (B,) fp32
    sums of squares over every leaf, each leaf's sum rounded to fp32 and
    the leaves added in order; with ``per_leaf`` also the (L, B) per-leaf
    sums."""
    dev = buf.device
    require(dev.type == "cuda", "per_example_sumsq_tree_cuda takes CUDA "
                                "tensors")
    ld = check_rows("buf", buf, dev)
    B, P = buf.shape
    if P != layout.total:
        raise ValueError(f"buf has {P} columns, the layout's packed buffer "
                         f"{layout.total}")
    require(1 <= B <= MAX_ROWS, f"per_example_sumsq_tree takes 1 to "
                                f"{MAX_ROWS} rows")
    aligned = ld % 4 == 0 and buf.data_ptr() % 16 == 0
    table, blocks = sumsq_table(layout, B, aligned, dev)
    L = layout.n_leaves
    out = torch.empty(B, dtype=torch.float32, device=dev)
    leaves = torch.empty((L, B), dtype=torch.float32, device=dev) \
        if per_leaf else None
    partial = torch.empty(blocks, dtype=torch.float64, device=dev)
    err = _SUMSQ_TREE.launch(dev, buf.data_ptr(), ld, B, table.data_ptr(), L,
                             blocks, partial.data_ptr(), out.data_ptr(),
                             0 if leaves is None else leaves.data_ptr())
    _build.check(err, "per_example_sumsq_tree")
    PER_EXAMPLE_SUMSQ_TREE.launches += 1
    return (out, leaves) if per_leaf else out
