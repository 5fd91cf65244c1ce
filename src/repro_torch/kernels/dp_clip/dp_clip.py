"""CUDA wrapper of the masked-aggregate kernel.

The kernel is in ``csrc/clip_accumulate.cu`` (its header says which TPU
kernel it replaces, what bounds it on an H100, and how the design answers
that). The wrapper checks what the kernel takes, allocates the output,
launches on the current stream, raises on a CUDA error and counts the
launch. CUDA tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_tensor, register, require

CLIP_ACCUMULATE = register(
    "clip_accumulate",
    "src/repro_torch/kernels/dp_clip/csrc/clip_accumulate.cu",
    "src/repro/kernels/dp_clip/dp_clip.py:77")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def clip_accumulate_cuda(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: g (n, P) fp32, scale (n,) fp32 -> (P,) fp32."""
    dev = g.device
    require(dev.type == "cuda", "clip_accumulate_cuda takes CUDA tensors")
    check_tensor("g", g, torch.float32, 2, dev)
    check_tensor("scale", scale, torch.float32, 1, dev)
    n, P = g.shape
    require(scale.shape == (n,), f"scale {tuple(scale.shape)}, expected ({n},)")
    require(n >= 1, "clip_accumulate needs at least one row")
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    vec = int(P % 4 == 0 and g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = _build.function("clip_accumulate_f32", [_P, _P, _P, _I, _L, _I, _P])
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), scale.data_ptr(), out.data_ptr(), n, P, vec,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "clip_accumulate")
    CLIP_ACCUMULATE.launches += 1
    return out
