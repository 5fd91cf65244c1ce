"""CUDA wrappers of the per-example clip kernels: the masked aggregate
(``clip_accumulate``) and the per-example sums of squares
(``per_example_sumsq``).

The kernels are in ``csrc/clip_accumulate.cu`` and ``csrc/sumsq.cu`` (each
header says which TPU kernel it replaces, what bounds it on an H100, and
how the design answers that). A wrapper checks what its kernel takes,
allocates the output and scratch, launches on the current stream, raises
on a CUDA error and counts the launch. Both take a (B, D) matrix whose rows
may lie apart (one leaf's columns of the (B, P) per-example buffer). CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes

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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CLIP_ACCUMULATE = _build.Entry("clip_accumulate_f32",
                                [_P, _P, _P, _I, _L, _L, _I, _P])
_SUMSQ = _build.Entry("per_example_sumsq_f32",
                      [_P, _P, _P, _I, _L, _L, _I, _I, _P])
RS_THREADS = 256  # csrc/rowsq.cuh
MAX_ROWS = 65535  # the grid's y extent


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


def clip_accumulate_cuda(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: g (n, P) fp32, rows contiguous (they may lie
    apart), scale (n,) fp32 -> (P,) fp32."""
    dev = g.device
    require(dev.type == "cuda", "clip_accumulate_cuda takes CUDA tensors")
    ld = check_rows("g", g, dev)
    check_tensor("scale", scale, torch.float32, 1, dev)
    n, P = g.shape
    require(scale.shape == (n,), f"scale {tuple(scale.shape)}, expected ({n},)")
    require(n >= 1, "clip_accumulate needs at least one row")
    out = torch.empty(P, dtype=torch.float32, device=dev)
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
