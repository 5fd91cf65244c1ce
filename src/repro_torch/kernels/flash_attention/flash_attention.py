"""CUDA wrapper of the flash-attention forward kernel.

The kernel is in ``csrc/flash_attention.cu`` (its header says which TPU
kernel it replaces, what bounds it on an H100, and how the design answers
that). The wrapper checks what the kernel takes, allocates the output,
launches on the current stream, raises on a CUDA error and counts the
launch. CUDA tensors only; ``ops`` routes CPU tensors to ``ref``. Its host
time is most of a call at the prefill shapes, so the C entry point is bound
once, the device is switched only when it is not already current, and the
stream is read once; every check that raises stays, and builds its message
only when it fails.

q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype:
fp32 or bf16, q, k and v alike (another dtype, or a mix, raises). Each
dtype is its own instantiation, counted apart (``variants``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (DTYPE_VARIANTS, FLASH_HEAD_DIMS,
                                          check_tensor, dtype_variant,
                                          register, require)

FLASH_ATTENTION = register(
    "flash_attention",
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "src/repro/kernels/flash_attention/flash_attention.py:66",
    variants=tuple(DTYPE_VARIANTS.values()))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLASH = {v: _build.Entry(f"flash_attention_fwd_{v}",
                          [_P] * 4 + [_I] * 7 + [_F, _P])
          for v in DTYPE_VARIANTS.values()}


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch the flash-attention forward kernel; returns (B, Sq, Hq, D)."""
    dev = q.device
    require(dev.type == "cuda", "flash_attention_cuda takes CUDA tensors")
    variant = dtype_variant("q", q)
    check_tensor("q", q, q.dtype, 4, dev)
    check_tensor("k", k, q.dtype, 4, dev)
    check_tensor("v", v, q.dtype, 4, dev)
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    require(v.shape == k.shape, "k/v shapes differ")
    if Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {FLASH_HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    require(Sk > 0, "empty key sequence")
    pq, pk, pv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    require(not (pq | pk | pv) & 15, "q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    err = _FLASH[variant].launch(dev, pq, pk, pv, out.data_ptr(), B, Sq, Sk,
                                 Hq, Hkv, D, int(causal), 1.0 / D ** 0.5)
    _build.check(err, "flash_attention")
    FLASH_ATTENTION.count(variant)
    return out
