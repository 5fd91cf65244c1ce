"""CUDA wrappers of the packed DP kernels: the corrected noise of the fused
tier, one silo's contribution of the barrier and wire tiers (its noise
streams drawn in the kernel, or read from memory), one silo's noise stream,
and the per-example clip and sum.

The kernels are in ``csrc/noise_batch.cu``, ``csrc/clip_mask.cu`` (two
kernels), ``csrc/noise_stream.cu`` and ``csrc/clip_sum.cu`` (each header
says which TPU kernel it replaces, or that none is behind it, what bounds
it on an H100, and how the design answers that). A wrapper checks what its
kernel takes, allocates the output, launches on the current stream, raises
on a CUDA error and counts the launch. CUDA tensors only; ``ops`` routes
CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_key, check_tensor, register,
                                          require)
from repro_torch.kernels.dp_clip.dp_clip import MAX_ROWS, row_blocks, vec_ok

NOISE_BATCH = register(
    "noise_batch",
    "src/repro_torch/kernels/dp_fused/csrc/noise_batch.cu",
    "src/repro/kernels/dp_fused/dp_fused.py:255")
CLIP_MASK = register(
    "clip_mask",
    "src/repro_torch/kernels/dp_fused/csrc/clip_mask.cu",
    "src/repro/kernels/dp_fused/dp_fused.py:171")
NOISE_STREAM = register(
    "noise_stream",
    "src/repro_torch/kernels/dp_fused/csrc/noise_stream.cu",
    "none (a port kernel): the jnp _silo_stream, "
    "src/repro/core/dp_pipeline.py:74, behind DPPipeline.noise_stream :302")
CLIP_MASK_EXT = register(
    "clip_mask_ext",
    "src/repro_torch/kernels/dp_fused/csrc/clip_mask.cu",
    "none (a port kernel): ref.clip_mask_ref with xi=/xp=, reached through "
    "src/repro/kernels/dp_fused/ops.py:61")
CLIP_SUM = register(
    "clip_sum",
    "src/repro_torch/kernels/dp_fused/csrc/clip_sum.cu",
    "src/repro/kernels/dp_fused/dp_fused.py:100")

_P, _I, _L, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint32, ctypes.c_float)
_NOISE_BATCH = _build.Entry("noise_batch_f32",
                           [_P, _P, _L, _U, _U, _U, _U, _P, _P, _I, _F, _I, _P])
_CLIP_MASK = _build.Entry("clip_mask_f32",
                          [_P, _P, _L] + [_U] * 8 + [_P, _I, _I, _P])
_NOISE_STREAM = _build.Entry("noise_stream_f32", [_P, _L, _U, _U, _U, _P])
_CLIP_MASK_EXT = _build.Entry("clip_mask_ext_f32",
                              [_P] * 4 + [_L] + [_U] * 8 + [_P, _I, _I, _P])
_CLIP_SUM = _build.Entry("clip_sum_f32", [_P] * 6 + [_I, _L, _I, _I, _P])


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
    kx, kp = check_key("key_xi", key_xi), check_key("prev_key", prev_key)
    P = g_sum.shape[0]
    out = torch.empty_like(g_sum)
    if P == 0:
        return out
    err = _NOISE_BATCH.launch(dev, g_sum.data_ptr(), out.data_ptr(), P,
                              kx[0], kx[1], kp[0], kp[1],
                              noise_scales.data_ptr(), lam_gates.data_ptr(),
                              n, float(prev_noise_scale), int(bool(use_prev)))
    _build.check(err, "noise_batch")
    NOISE_BATCH.launches += 1
    return out


def clip_mask_cuda(g, scalars, key_r, key_xi, prev_key, silo: int, nxt: int,
                   use_pairwise: bool = True, use_prev: bool = True,
                   out=None) -> torch.Tensor:
    """Launch the kernel: g (P,) fp32; scalars (5,) fp32 on the same card,
    ``(scale, s, b, lam, s_prev)``; keys (k0, k1) ints; ``silo`` and ``nxt``
    the stream ids -> (P,) fp32, written into ``out`` when given (``g``
    itself included)."""
    dev = g.device
    require(dev.type == "cuda", "clip_mask_cuda takes CUDA tensors")
    check_tensor("g", g, torch.float32, 1, dev)
    check_tensor("scalars", scalars, torch.float32, 1, dev)
    require(scalars.shape == (5,), f"scalars {tuple(scalars.shape)}, expected "
                                   f"(5,): scale, s, b, lam, s_prev")
    require(0 <= silo <= 0xFFFFFFFF and 0 <= nxt <= 0xFFFFFFFF,
            f"stream ids must be uint32, got silo {silo}, nxt {nxt}")
    kr, kx, kp = (check_key("key_r", key_r), check_key("key_xi", key_xi),
                  check_key("prev_key", prev_key))
    P = g.shape[0]
    if out is None:
        out = torch.empty_like(g)
    check_tensor("out", out, torch.float32, 1, dev)
    require(out.shape == g.shape, f"out {tuple(out.shape)}, expected ({P},)")
    require(g.data_ptr() == out.data_ptr() or _disjoint(g, out),
            "out must be g itself or disjoint from it")
    if P == 0:
        return out
    err = _CLIP_MASK.launch(dev, g.data_ptr(), out.data_ptr(), P, kr[0],
                            kr[1], kx[0], kx[1], kp[0], kp[1], int(silo),
                            int(nxt), scalars.data_ptr(),
                            int(bool(use_pairwise)), int(bool(use_prev)))
    _build.check(err, "clip_mask")
    CLIP_MASK.launches += 1
    return out


def _disjoint(a: torch.Tensor, b: torch.Tensor) -> bool:
    pa, pb = a.data_ptr(), b.data_ptr()
    return pa + 4 * a.numel() <= pb or pb + 4 * b.numel() <= pa


def check_stream(name: str, x: torch.Tensor, g: torch.Tensor) -> None:
    """An external noise stream: (P,) fp32, contiguous, on ``g``'s device
    and of its length (a wrong one raises, never a quiet draw instead)."""
    check_tensor(name, x, torch.float32, 1, g.device)
    if x.shape != g.shape:
        raise ValueError(f"{name}: {tuple(x.shape)}, expected "
                         f"{tuple(g.shape)}")


def clip_mask_ext_cuda(g, xi, xp, scalars, key_r, key_xi, prev_key,
                       silo: int, nxt: int, use_pairwise: bool = True,
                       use_prev: bool = True, out=None) -> torch.Tensor:
    """Launch the external-stream kernel: :func:`clip_mask_cuda` with
    ``xi`` (and ``xp``, read when ``use_prev``) (P,) fp32 buffers on the
    same card, disjoint from ``out``; a stream given as None is drawn in
    the kernel from its key."""
    dev = g.device
    require(dev.type == "cuda", "clip_mask_ext_cuda takes CUDA tensors")
    check_tensor("g", g, torch.float32, 1, dev)
    check_tensor("scalars", scalars, torch.float32, 1, dev)
    if scalars.shape != (5,):
        raise ValueError(f"scalars {tuple(scalars.shape)}, expected (5,): "
                         f"scale, s, b, lam, s_prev")
    if not (0 <= silo <= 0xFFFFFFFF and 0 <= nxt <= 0xFFFFFFFF):
        raise ValueError(f"stream ids must be uint32, got silo {silo}, "
                         f"nxt {nxt}")
    kr, kx, kp = (check_key("key_r", key_r), check_key("key_xi", key_xi),
                  check_key("prev_key", prev_key))
    P = g.shape[0]
    if out is None:
        out = torch.empty_like(g)
    check_tensor("out", out, torch.float32, 1, dev)
    if out.shape != g.shape:
        raise ValueError(f"out {tuple(out.shape)}, expected ({P},)")
    require(g.data_ptr() == out.data_ptr() or _disjoint(g, out),
            "out must be g itself or disjoint from it")
    ptrs = []
    for name, x in (("xi", xi), ("xp", xp if use_prev else None)):
        if x is not None:
            check_stream(name, x, g)
            if not _disjoint(x, out):
                raise ValueError(f"{name} must be disjoint from out")
        ptrs.append(None if x is None else x.data_ptr())
    if P == 0:
        return out
    err = _CLIP_MASK_EXT.launch(dev, g.data_ptr(), ptrs[0], ptrs[1],
                                out.data_ptr(), P, kr[0], kr[1], kx[0], kx[1],
                                kp[0], kp[1], int(silo), int(nxt),
                                scalars.data_ptr(), int(bool(use_pairwise)),
                                int(bool(use_prev)))
    _build.check(err, "clip_mask_ext")
    CLIP_MASK_EXT.launches += 1
    return out


def noise_stream_cuda(key, silo: int, out) -> torch.Tensor:
    """Launch the kernel: silo ``silo``'s standard-normal stream under the
    raw key ``(k0, k1)`` into ``out``, (P,) fp32 on a card."""
    dev = out.device
    require(dev.type == "cuda", "noise_stream_cuda takes CUDA tensors")
    check_tensor("out", out, torch.float32, 1, dev)
    if not 0 <= silo <= 0xFFFFFFFF:
        raise ValueError(f"stream id must be uint32, got {silo}")
    k = check_key("key", key)
    if out.shape[0] == 0:
        return out
    err = _NOISE_STREAM.launch(dev, out.data_ptr(), out.shape[0], k[0], k[1],
                               int(silo))
    _build.check(err, "noise_stream")
    NOISE_STREAM.launches += 1
    return out


def clip_sum_cuda(g, clip_bound) -> tuple:
    """Launch the kernel: g (B, P) fp32 contiguous, clip_bound a (1,) fp32
    tensor on the same card -> (clipped sum (P,), pre-clip norms (B,))."""
    dev = g.device
    require(dev.type == "cuda", "clip_sum_cuda takes CUDA tensors")
    check_tensor("g", g, torch.float32, 2, dev)
    check_tensor("clip_bound", clip_bound, torch.float32, 1, dev)
    require(clip_bound.shape == (1,), f"clip_bound {tuple(clip_bound.shape)}, "
                                      f"expected (1,)")
    B, P = g.shape
    require(1 <= B <= MAX_ROWS, f"clip_sum takes 1 to {MAX_ROWS} rows, got {B}")
    out = torch.empty(P, dtype=torch.float32, device=dev)
    norms = torch.empty(B, dtype=torch.float32, device=dev)
    scale = torch.empty(B, dtype=torch.float32, device=dev)
    nblk = row_blocks(B, P, dev)
    partial = torch.empty(B * nblk, dtype=torch.float64, device=dev)
    err = _CLIP_SUM.launch(dev, g.data_ptr(), out.data_ptr(), norms.data_ptr(),
                           scale.data_ptr(), partial.data_ptr(),
                           clip_bound.data_ptr(), B, P, vec_ok(P, P, g, out),
                           nblk)
    _build.check(err, "clip_sum")
    CLIP_SUM.launches += 1
    return out, norms
