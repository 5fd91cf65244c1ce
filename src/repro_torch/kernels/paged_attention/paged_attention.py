"""CUDA wrappers of the paged-attention kernel and of the page pools'
batched zeroing kernel (the page reset and the rollback).

The kernels are in ``csrc/paged_attention.cu`` and ``csrc/pool_zero.cu``
(each header says which TPU kernels it replaces, what bounds it on an H100,
and how the design answers that). These wrappers check what the kernels
take, allocate the output (and the attention's split scratch), launch on the
current stream, raise on a CUDA error and count the launches. They take
CUDA tensors only; ``ops`` routes CPU tensors to ``ref``. A wrapper's host
time is most of a call at the serving shapes, so each keeps it short: the C
entry points are bound once, the device is switched only when it is not
already current, and the stream is read once; every check that raises
stays, and builds its message only when it fails.

Element types: q and the pools are fp32 or bf16, one type for all of
them; attention returns fp32 whichever it is (as the JAX kernel does), and
the zeroing keeps the pools' type. Each type is its own instantiation,
counted apart (``variants``); another type, or a mix, raises.

Layouts (as in the JAX package):
  q                (B, C, Hq, D)   C new tokens per slot
  k_pages/v_pages  (N, P, Hkv, D)  one layer's pool: N pages of P tokens
  tables           (B, nP) int32   the slots' physical page ids
  q_start          (B,) int32      tokens already cached per slot
  a stacked pool   (L, N, P, H, D) every layer's K or V pages, for zeroing
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (DTYPE_VARIANTS, HEAD_DIMS,
                                          check_tensor, dtype_variant,
                                          register, require)
from repro_torch.kernels.paged_attention.ref import TC_CHUNK_TOKENS

_VARIANTS = tuple(DTYPE_VARIANTS.values())
PAGED_ATTENTION = register(
    "paged_attention",
    "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
    "src/repro/kernels/paged_attention/paged_attention.py:128",
    variants=_VARIANTS)
PAGED_RESET = register(
    "paged_reset",
    "src/repro_torch/kernels/paged_attention/csrc/pool_zero.cu",
    "src/repro/kernels/paged_attention/paged_attention.py:213",
    variants=_VARIANTS)
PAGED_ROLLBACK = register(
    "paged_rollback",
    "src/repro_torch/kernels/paged_attention/csrc/pool_zero.cu",
    "src/repro/kernels/paged_attention/paged_attention.py:184",
    variants=_VARIANTS)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_ATTENTION = {v: _build.Entry(f"paged_attention_{v}",
                              [_P] * 7 + [_I] * 10 + [_F, _P])
              for v in _VARIANTS}
_ZERO = {v: _build.Entry(f"pool_zero_{v}",
                         [_P, _P, _I, _P, _P, _I, _LL, _LL, _LL, _P, _I, _P])
         for v in _VARIANTS}

# what a slab is: a page (reset; the TPU kernel paged_reset_pallas) or a
# token (rollback; paged_rollback_pallas), and the counter of each
SLABS = {"page": PAGED_RESET, "token": PAGED_ROLLBACK}

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


# the bf16 kernel's plan (csrc/paged_attention.cu, paged_attention_tc_kernel):
# blocks of 4 warps, each block a chunk of TC_CHUNK_TOKENS (a warp's two
# tiles of 16 keys: ref.TC_*); the folded rows transposed onto the tensor
# cores' 8 columns up to 8 of them, else in tiles of 16
TC_THREADS = 128
TC_ROW_TILES = (8, 16)


def plan_tc(GC: int, nP: int, P: int) -> tuple[int, int]:
    """(row tile, token chunks) of one bf16 call, from shapes alone (the
    slots' lengths stay on the card): 8 (the scores transposed) when the
    G*C folded rows fit in 8, else 16; and ``ceil(nP * P / 128)`` chunks,
    chunk c taking tokens ``[128 c, 128 (c + 1))`` of every slot."""
    rows = TC_ROW_TILES[0] if GC <= TC_ROW_TILES[0] else TC_ROW_TILES[1]
    return rows, -(-nP * P // TC_CHUNK_TOKENS)


def paged_attention_cuda(q, k_pages, v_pages, tables, q_start) -> torch.Tensor:
    """Launch the paged-attention kernels (the split kernel, then the
    combine unless one split or chunk covers the call); q and the pools
    fp32 (``plan``) or bf16 (the tensor-core kernel, ``plan_tc``), one type;
    returns fp32 (B, C, Hq, D). Counts one launch a call, on its dtype's
    variant."""
    dev = q.device
    require(dev.type == "cuda", "paged_attention_cuda takes CUDA tensors")
    f32, i32 = torch.float32, torch.int32
    variant = dtype_variant("q", q)
    check_tensor("q", q, q.dtype, 4, dev)
    check_tensor("k_pages", k_pages, q.dtype, 4, dev)
    check_tensor("v_pages", v_pages, q.dtype, 4, dev)
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
    # fp32 whatever q's type, as the JAX kernel returns
    out = torch.empty(q.shape, dtype=f32, device=dev)
    if B == 0 or C == 0:
        return out
    GC = Hq // Hkv * C
    rows, splits = (plan_tc(GC, nP, P) if variant == "bf16" else
                    plan(B, Hkv, GC, nP, P, _build.sm_count(dev)))
    part = (torch.empty(B * Hkv * splits * GC * (D + 2), dtype=f32, device=dev)
            if splits > 1 else out)
    err = _ATTENTION[variant].launch(
        dev, *ptrs, tables.data_ptr(), q_start.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, C, Hq, Hkv, N, P, D, nP, rows, splits,
        1.0 / D ** 0.5)
    _build.check(err, "paged_attention")
    PAGED_ATTENTION.count(variant)
    return out


def _check_pools(k_pages, v_pages, dtype=None) -> tuple:
    """A stacked pool's checks (CUDA, fp32 or bf16 (``dtype`` when given),
    5-d, contiguous, K and V alike); returns its device and its dtype's
    variant."""
    dev = k_pages.device
    if dev.type != "cuda":
        raise ValueError("pool_zero_cuda takes CUDA tensors")
    variant = dtype_variant("k_pages", k_pages)
    dtype = k_pages.dtype if dtype is None else dtype
    check_tensor("k_pages", k_pages, dtype, 5, dev)
    check_tensor("v_pages", v_pages, dtype, 5, dev)
    require(v_pages.shape == k_pages.shape, "k_pages/v_pages shapes differ")
    return dev, variant


def pool_zero_cuda(pools, idx, slab: str) -> None:
    """Launch the zeroing kernel: the distinct slabs among ``idx`` (host
    ints) in every layer of one or two stacked pools ``pools``, a sequence
    of ``(k_pages, v_pages)`` pairs of (L, N, P, H, D) sharing N, P, H, D
    and the dtype (fp32 or bf16), in place. ``slab`` is ``"page"`` (page
    ids, below N) or ``"token"`` (pool token indices ``page*P + t``, below
    N*P); an index outside that range is skipped. The C entry launches once
    for each chunk of indices its parameter block holds and returns how
    many launches it made, which are counted on the slab's kernel
    (``SLABS``), on its dtype's variant; the indices travel in the launch's
    parameters, so nothing is copied to the card."""
    if not 1 <= len(pools) <= 2:
        raise ValueError(f"pool_zero takes one or two pools, got {len(pools)}")
    counter = SLABS.get(slab)
    if counter is None:
        raise ValueError(f"slab {slab!r}: expected one of {sorted(SLABS)}")
    (k_a, v_a), *rest = pools
    dev, variant = _check_pools(k_a, v_a)
    L_a, N, P, H, D = k_a.shape
    kb = vb = L_b = 0
    if rest:
        (k_b, v_b), = rest
        _check_pools(k_b, v_b, k_a.dtype)
        if k_b.device != dev:
            raise ValueError(f"pools on {dev} and {k_b.device}")
        if k_b.shape[1:] != k_a.shape[1:]:
            raise ValueError(f"pools differ in (N, P, H, D): "
                             f"{tuple(k_a.shape[1:])} and "
                             f"{tuple(k_b.shape[1:])}")
        kb, vb, L_b = k_b.data_ptr(), v_b.data_ptr(), k_b.shape[0]
    width, limit = (P * H * D, N) if slab == "page" else (H * D, N * P)
    # distinct and sorted (an event's few ints: a set, not numpy), and
    # int32-safe: one outside [0, limit) becomes -1 or limit, which the
    # kernel skips
    ids = sorted(set(map(int, idx)))
    if ids and (ids[0] < 0 or ids[-1] >= limit):
        ids = [-1 if i < 0 else min(i, limit) for i in ids]
    if not ids:
        return
    ids = array.array("i", ids)  # the C entry reads them in place
    made = _ZERO[variant].launch(dev, k_a.data_ptr(), v_a.data_ptr(), L_a,
                                 kb, vb, L_b, N * P * H * D, limit, width,
                                 ids.buffer_info()[0], len(ids))
    if made < 0:
        _build.check(-made, "pool_zero")
    counter.count(variant, made)
