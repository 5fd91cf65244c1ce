"""CUDA wrapper of the flash-attention forward kernel.

The kernel is in ``csrc/flash_attention.cu`` (its header says which TPU
kernel it replaces, what bounds it on an H100, and how the design answers
that). The wrapper checks what the kernel takes, allocates the output,
launches on the current stream, raises on a CUDA error and counts the
launch. CUDA tensors only; ``ops`` routes CPU tensors to ``ref``.

q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype
(fp32: the wrapper takes nothing else yet).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (FLASH_HEAD_DIMS, check_tensor,
                                          register, require)

FLASH_ATTENTION = register(
    "flash_attention",
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "src/repro/kernels/flash_attention/flash_attention.py:66")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch the flash-attention forward kernel; returns (B, Sq, Hq, D)."""
    dev = q.device
    require(dev.type == "cuda", "flash_attention_cuda takes CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, torch.float32, 4, dev)
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    require(v.shape == k.shape, "k/v shapes differ")
    require(Bk == B and Dk == D, f"q {tuple(q.shape)} vs k {tuple(k.shape)}")
    require(D in FLASH_HEAD_DIMS, f"head dim {D} not in {FLASH_HEAD_DIMS}")
    require(Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    require(Sk > 0, "empty key sequence")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    fn = _build.function("flash_attention_fwd_f32",
                         [_P] * 4 + [_I] * 7 + [_F, _P])
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, D, int(causal), 1.0 / D ** 0.5,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    FLASH_ATTENTION.launches += 1
    return out
