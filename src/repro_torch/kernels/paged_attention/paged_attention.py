"""CUDA wrappers of the paged-attention, page-reset and rollback kernels.

The kernels are in ``csrc/paged_attention.cu`` (its header says which TPU
kernels they replace, what bounds them on an H100, and how the design
answers that). These wrappers check what the kernels take, allocate the
output, launch on the current stream, raise on a CUDA error and count the
launch. They take CUDA tensors only; ``ops`` routes CPU tensors to ``ref``.

Layouts (as in the JAX package):
  q                (B, C, Hq, D)   C new tokens per slot
  k_pages/v_pages  (N, P, Hkv, D)  one layer's pool: N pages of P tokens
  tables           (B, nP) int32   the slots' physical page ids
  q_start          (B,) int32      tokens already cached per slot
"""
from __future__ import annotations

import ctypes

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


def paged_attention_cuda(q, k_pages, v_pages, tables, q_start) -> torch.Tensor:
    """Launch the paged-attention kernel; returns fp32 (B, C, Hq, D)."""
    dev = q.device
    require(dev.type == "cuda", "paged_attention_cuda takes CUDA tensors")
    for name, t, dt, nd in (("q", q, torch.float32, 4),
                            ("k_pages", k_pages, torch.float32, 4),
                            ("v_pages", v_pages, torch.float32, 4),
                            ("tables", tables, torch.int32, 2),
                            ("q_start", q_start, torch.int32, 1)):
        check_tensor(name, t, dt, nd, dev)
    B, C, Hq, D = q.shape
    N, P, Hkv, Dk = k_pages.shape
    require(v_pages.shape == k_pages.shape, "k_pages/v_pages shapes differ")
    require(Dk == D, f"head dim: q {D}, pages {Dk}")
    require(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    require(Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    require(tables.shape[0] == B and q_start.shape == (B,),
            "tables/q_start batch differs from q")
    nP = tables.shape[1]
    require(nP > 0, "tables must name at least one page per slot")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    fn = _build.function("paged_attention_f32",
                         [_P] * 6 + [_I] * 8 + [_F, _P])
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), q_start.data_ptr(), out.data_ptr(),
                 B, C, Hq, Hkv, N, P, D, nP, 1.0 / D ** 0.5,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention")
    PAGED_ATTENTION.launches += 1
    return out


def paged_reset_cuda(k_pages, v_pages, row) -> None:
    """Launch the page-reset kernel: zero the pages named in ``row`` across
    every layer of the stacked (L, N, P, H, D) pools, in place."""
    dev = k_pages.device
    require(dev.type == "cuda", "paged_reset_cuda takes CUDA tensors")
    for name, t, dt, nd in (("k_pages", k_pages, torch.float32, 5),
                            ("v_pages", v_pages, torch.float32, 5),
                            ("row", row, torch.int32, 1)):
        check_tensor(name, t, dt, nd, dev)
    require(v_pages.shape == k_pages.shape, "k_pages/v_pages shapes differ")
    L, N, P, H, D = k_pages.shape
    nP = row.shape[0]
    if L == 0 or nP == 0:
        return
    fn = _build.function("paged_reset_f32",
                         [_P] * 3 + [_I] * 2 + [ctypes.c_longlong, _I, _P])
    with torch.cuda.device(dev):
        err = fn(k_pages.data_ptr(), v_pages.data_ptr(), row.data_ptr(), L, N,
                 P * H * D, nP, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_reset")
    PAGED_RESET.launches += 1


def paged_rollback_cuda(k_pages, v_pages, row, start: int, end: int) -> None:
    """Launch the rollback kernel: zero logical positions ``[start, end)``
    of ``row`` (page ``j`` holds ``j*P .. j*P+P-1``) across every layer of
    the stacked (L, N, P, H, D) pools, in place. Positions outside
    ``[0, nP*P)`` are skipped; an empty range launches nothing."""
    dev = k_pages.device
    require(dev.type == "cuda", "paged_rollback_cuda takes CUDA tensors")
    for name, t, dt, nd in (("k_pages", k_pages, torch.float32, 5),
                            ("v_pages", v_pages, torch.float32, 5),
                            ("row", row, torch.int32, 1)):
        check_tensor(name, t, dt, nd, dev)
    require(v_pages.shape == k_pages.shape, "k_pages/v_pages shapes differ")
    L, N, P, H, D = k_pages.shape
    nP = row.shape[0]
    start, end = int(start), int(end)
    if L == 0 or min(end, nP * P) <= max(start, 0):
        return
    fn = _build.function("paged_rollback_f32",
                         [_P] * 3 + [_I] * 7 + [_P])
    with torch.cuda.device(dev):
        err = fn(k_pages.data_ptr(), v_pages.data_ptr(), row.data_ptr(), L, N,
                 P, H * D, nP, start, end,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_rollback")
    PAGED_ROLLBACK.launches += 1
