"""CUDA wrappers of the paged-attention, page-reset and rollback kernels.

The kernels are in ``csrc/paged_attention.cu`` (its header says which TPU
kernels they replace, what bounds them on an H100, and how the design
answers that). These wrappers check what the kernels take, allocate the
output (and the attention's split scratch), launch on the current stream,
raise on a CUDA error and count the launch. They take CUDA tensors only;
``ops`` routes CPU tensors to ``ref``. A wrapper's host time is most of a
call at the serving shapes, so each keeps it short: the C entry points are
bound once, the device is switched only when it is not already current, and
the stream is read once; every check that raises stays, and builds its
message only when it fails.

Layouts (as in the JAX package):
  q                (B, C, Hq, D)   C new tokens per slot
  k_pages/v_pages  (N, P, Hkv, D)  one layer's pool: N pages of P tokens
  tables           (B, nP) int32   the slots' physical page ids
  q_start          (B,) int32      tokens already cached per slot
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (HEAD_DIMS, check_tensor, register,
                                          require)

PAGED_ATTENTION = register(
    "paged_attention",
    "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
    "src/repro/kernels/paged_attention/paged_attention.py:128")
PAGED_RESET = register(
    "paged_reset",
    "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
    "src/repro/kernels/paged_attention/paged_attention.py:213")
PAGED_ROLLBACK = register(
    "paged_rollback",
    "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
    "src/repro/kernels/paged_attention/paged_attention.py:184")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ATTENTION = _build.Entry("paged_attention_f32",
                          [_P] * 7 + [_I] * 10 + [_F, _P])
_RESET = _build.Entry("paged_reset_f32",
                      [_P] * 3 + [_I] * 2 + [ctypes.c_longlong, _I, _P])
_ROLLBACK = _build.Entry("paged_rollback_f32", [_P] * 3 + [_I] * 7 + [_P])

# the kernel's row tiles (csrc/paged_attention.cu): the folded G*C rows in
# tiles of 8, 16, 32 or 64
ROW_TILES = (8, 16, 32, 64)
# blocks a call aims for, per SM: two resident blocks of 8 warps hide each
# other's shared-memory and copy latency; and tokens a split walks at
# least: the kernel's K/V tile (ATTN_COLS), so no split runs a tile that
# is mostly padding (PERF.md records the plans measured on the card)
BLOCKS_PER_SM = 2
TILE_TOKENS = 32


@functools.lru_cache(maxsize=1024)  # a serving loop repeats a few shapes
def plan(B: int, Hkv: int, GC: int, nP: int, P: int,
         sms: int) -> tuple[int, int]:
    """(row tile, page splits) of one call: the smallest row tile that
    holds the G*C folded rows (64 beyond), and about enough splits of the
    nP pages of P tokens for B * Hkv * row tiles * splits blocks to fill
    ``BLOCKS_PER_SM`` x ``sms`` (the runs are whole pages of equal length,
    so the count rounds), each split at least ``TILE_TOKENS`` tokens (or
    all nP pages) and none empty.
    Split s walks pages ``[s*pps, min(nP, (s+1)*pps))``,
    ``pps = ceil(nP / splits)``."""
    rows = next((r for r in ROW_TILES if GC <= r), ROW_TILES[-1])
    tiles = B * Hkv * -(-GC // rows)
    want = -(-BLOCKS_PER_SM * sms // tiles)
    splits = max(min(want, nP // -(-TILE_TOKENS // P)), 1)
    return rows, -(-nP // -(-nP // splits))  # no empty trailing split


def paged_attention_cuda(q, k_pages, v_pages, tables, q_start) -> torch.Tensor:
    """Launch the paged-attention kernels (the split kernel, then the
    combine unless one split covers the call); returns fp32
    (B, C, Hq, D). Counts one launch a call."""
    dev = q.device
    require(dev.type == "cuda", "paged_attention_cuda takes CUDA tensors")
    f32, i32 = torch.float32, torch.int32
    check_tensor("q", q, f32, 4, dev)
    check_tensor("k_pages", k_pages, f32, 4, dev)
    check_tensor("v_pages", v_pages, f32, 4, dev)
    check_tensor("tables", tables, i32, 2, dev)
    check_tensor("q_start", q_start, i32, 1, dev)
    B, C, Hq, D = q.shape
    N, P, Hkv, Dk = k_pages.shape
    nP = tables.shape[1]
    require(v_pages.shape == k_pages.shape, "k_pages/v_pages shapes differ")
    if Dk != D:
        raise ValueError(f"head dim: q {D}, pages {Dk}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    require(tables.shape[0] == B and q_start.shape == (B,),
            "tables/q_start batch differs from q")
    require(nP > 0, "tables must name at least one page per slot")
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    require(not (ptrs[0] | ptrs[1] | ptrs[2]) & 15,
            "q, k_pages, v_pages must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    GC = Hq // Hkv * C
    rows, splits = plan(B, Hkv, GC, nP, P, _build.sm_count(dev))
    part = (torch.empty(B * Hkv * splits * GC * (D + 2), dtype=f32, device=dev)
            if splits > 1 else out)
    err = _ATTENTION.launch(dev, *ptrs, tables.data_ptr(), q_start.data_ptr(),
                            out.data_ptr(), part.data_ptr(), B, C, Hq, Hkv, N,
                            P, D, nP, rows, splits, 1.0 / D ** 0.5)
    _build.check(err, "paged_attention")
    PAGED_ATTENTION.launches += 1
    return out


def _check_pools(what, k_pages, v_pages, row) -> torch.device:
    """The pools' and the row's checks of the reset and rollback kernels;
    returns their device."""
    dev = k_pages.device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    check_tensor("k_pages", k_pages, torch.float32, 5, dev)
    check_tensor("v_pages", v_pages, torch.float32, 5, dev)
    check_tensor("row", row, torch.int32, 1, dev)
    require(v_pages.shape == k_pages.shape, "k_pages/v_pages shapes differ")
    return dev


def paged_reset_cuda(k_pages, v_pages, row) -> None:
    """Launch the page-reset kernel: zero the pages named in ``row`` across
    every layer of the stacked (L, N, P, H, D) pools, in place."""
    dev = _check_pools("paged_reset_cuda", k_pages, v_pages, row)
    L, N, P, H, D = k_pages.shape
    nP = row.shape[0]
    if L == 0 or nP == 0:
        return
    err = _RESET.launch(dev, k_pages.data_ptr(), v_pages.data_ptr(),
                        row.data_ptr(), L, N, P * H * D, nP)
    _build.check(err, "paged_reset")
    PAGED_RESET.launches += 1


def paged_rollback_cuda(k_pages, v_pages, row, start: int, end: int) -> None:
    """Launch the rollback kernel: zero logical positions ``[start, end)``
    of ``row`` (page ``j`` holds ``j*P .. j*P+P-1``) across every layer of
    the stacked (L, N, P, H, D) pools, in place. Positions outside
    ``[0, nP*P)`` are skipped; an empty range launches nothing."""
    dev = _check_pools("paged_rollback_cuda", k_pages, v_pages, row)
    L, N, P, H, D = k_pages.shape
    nP = row.shape[0]
    start, end = int(start), int(end)
    if L == 0 or min(end, nP * P) <= max(start, 0):
        return
    err = _ROLLBACK.launch(dev, k_pages.data_ptr(), v_pages.data_ptr(),
                           row.data_ptr(), L, N, P, H * D, nP, start, end)
    _build.check(err, "paged_rollback")
    PAGED_ROLLBACK.launches += 1
