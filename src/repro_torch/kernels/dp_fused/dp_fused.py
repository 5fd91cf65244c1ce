"""CUDA wrapper of the corrected-noise kernel.

The kernel is in ``csrc/noise_batch.cu`` (its header says which TPU kernel
it replaces, what bounds it on an H100, and how the design answers that).
The wrapper checks what the kernel takes, allocates the output, launches on
the current stream, raises on a CUDA error and counts the launch. CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_tensor, register, require

NOISE_BATCH = register(
    "noise_batch",
    "src/repro_torch/kernels/dp_fused/csrc/noise_batch.cu",
    "src/repro/kernels/dp_fused/dp_fused.py:255")

_P, _I, _L, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint32, ctypes.c_float)


def _key(name: str, key) -> tuple:
    k0, k1 = (int(k) for k in key)
    require(0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF,
            f"{name}: key words must be uint32, got {key}")
    return k0, k1


def noise_batch_cuda(g_sum, key_xi, prev_key, noise_scales, lam_gates,
                     prev_noise_scale, use_prev: bool = True) -> torch.Tensor:
    """Launch the kernel: g_sum (P,) fp32, noise_scales / lam_gates (n,)
    fp32 on the same card, keys (k0, k1) ints -> (P,) fp32."""
    dev = g_sum.device
    require(dev.type == "cuda", "noise_batch_cuda takes CUDA tensors")
    check_tensor("g_sum", g_sum, torch.float32, 1, dev)
    check_tensor("noise_scales", noise_scales, torch.float32, 1, dev)
    check_tensor("lam_gates", lam_gates, torch.float32, 1, dev)
    n = noise_scales.shape[0]
    require(lam_gates.shape == (n,), f"lam_gates {tuple(lam_gates.shape)}, "
                                     f"expected ({n},)")
    kx, kp = _key("key_xi", key_xi), _key("prev_key", prev_key)
    P = g_sum.shape[0]
    out = torch.empty_like(g_sum)
    if P == 0:
        return out
    fn = _build.function("noise_batch_f32",
                         [_P, _P, _L, _U, _U, _U, _U, _P, _P, _I, _F, _I, _P])
    with torch.cuda.device(dev):
        err = fn(g_sum.data_ptr(), out.data_ptr(), P, kx[0], kx[1], kp[0],
                 kp[1], noise_scales.data_ptr(), lam_gates.data_ptr(), n,
                 float(prev_noise_scale), int(bool(use_prev)),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "noise_batch")
    NOISE_BATCH.launches += 1
    return out
