"""CUDA wrappers of the flash-attention kernels: the forward (serving's,
and the training forward that also writes the log-sum-exp) and the
backward.

The kernels are in ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (each header says what it replaces, what
bounds it on an H100, and how the design answers that). The wrapper checks what the kernel takes, allocates the output,
launches on the current stream, raises on a CUDA error and counts the
launch. CUDA tensors only; ``ops`` routes CPU tensors to ``ref``. Its host
time is most of a call at the prefill shapes, so the C entry point is bound
once, the device is switched only when it is not already current, and the
stream is read once; every check that raises stays, and builds its message
only when it fails.

q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype:
fp32 or bf16, q, k and v alike (another dtype, or a mix, raises). Each
dtype is its own instantiation, counted apart (``variants``); the training
forward counts as its own variants of ``flash_attention`` (``lse_f32``,
``lse_bf16``), and the backward (``flash_attention_bwd``: delta, dk/dv,
the combine of the query heads' partials when Hq > Hkv, and dq, counted as
one) by dtype. Everything runs on the tensor cores (fp32 with every
operand as three bf16 terms): the serving forward is the training
forward's kernel of its dtype with no lse, counted as ``f32`` / ``bf16``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (DTYPE_VARIANTS, FLASH_HEAD_DIMS,
                                          check_tensor, countable,
                                          dtype_variant, register, require)

FLASH_ATTENTION = register(
    "flash_attention",
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "src/repro/kernels/flash_attention/flash_attention.py:66",
    variants=tuple(DTYPE_VARIANTS.values())
    + tuple(f"lse_{v}" for v in DTYPE_VARIANTS.values()))
FLASH_ATTENTION_BWD = register(
    "flash_attention_bwd",
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
    "src/repro/kernels/flash_attention/blocked.py:100",
    variants=tuple(DTYPE_VARIANTS.values()))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLASH = {v: _build.Entry(f"flash_attention_fwd_{v}",
                          [_P] * 4 + [_I] * 7 + [_F, _P])
          for v in DTYPE_VARIANTS.values()}
_FLASH_LSE = {v: _build.Entry(f"flash_attention_fwd_lse_{v}",
                              [_P] * 5 + [_I] * 7 + [_F, _P])
              for v in DTYPE_VARIANTS.values()}
_FLASH_BWD = {v: _build.Entry(f"flash_attention_bwd_{v}",
                              [_P] * 11 + [_I] * 7 + [_F, _P])
              for v in DTYPE_VARIANTS.values()}


def _check_qkv(what: str, q, k, v) -> str:
    """The checks every flash entry makes; returns the dtype variant."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
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
    require(not (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15,
            "q, k, v must be 16-byte aligned")
    return variant


@countable("flash_attention")
def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch the serving forward (the lse forward's kernel, no lse);
    returns (B, Sq, Hq, D)."""
    variant = _check_qkv("flash_attention_cuda", q, k, v)
    dev = q.device
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    pq, pk, pv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    err = _FLASH[variant].launch(dev, pq, pk, pv, out.data_ptr(), B, Sq, Sk,
                                 Hq, Hkv, D, int(causal), 1.0 / D ** 0.5)
    _build.check(err, "flash_attention")
    FLASH_ATTENTION.count(variant)
    return out


@countable("flash_attention_fwd_lse")
def flash_attention_fwd_lse_cuda(q, k, v, causal: bool = True):
    """The training forward: the same kernel writing each row's log-sum-exp
    too. Returns (out (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) fp32)."""
    variant = _check_qkv("flash_attention_fwd_lse_cuda", q, k, v)
    dev = q.device
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, device=dev, dtype=torch.float32)
    if B == 0 or Sq == 0:
        return out, lse
    err = _FLASH_LSE[variant].launch(
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal), 1.0 / D ** 0.5)
    _build.check(err, "flash_attention (lse)")
    FLASH_ATTENTION.count(f"lse_{variant}")
    return out, lse


@countable("flash_attention_bwd")
def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool = True):
    """Launch the backward kernel (delta, dk/dv a key tile and query head,
    their combine when Hq > Hkv, dq: one count) on the saved q, k, v, the
    training forward's ``out`` and ``lse`` and the cotangent ``dout``.
    Returns (dq, dk, dv), each in its input's dtype. With G = Hq / Hkv > 1
    the dk/dv pass writes each query head's fp32 partial to a scratch (2,
    G, B, Sk, Hkv, D) that the combine folds in ascending head order."""
    variant = _check_qkv("flash_attention_bwd_cuda", q, k, v)
    dev = q.device
    check_tensor("out", out, q.dtype, 4, dev)
    check_tensor("dout", dout, q.dtype, 4, dev)
    check_tensor("lse", lse, torch.float32, 3, dev)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} "
                         f"vs q {tuple(q.shape)}")
    if lse.shape != (B, Hq, Sq):
        raise ValueError(f"lse {tuple(lse.shape)}, expected {(B, Hq, Sq)}")
    require(not (out.data_ptr() | dout.data_ptr()) & 15,
            "out, dout must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(B, Hq, Sq, device=dev, dtype=torch.float32)
    part = (torch.empty(2, Hq // Hkv, B, Sk, Hkv, D, device=dev,
                        dtype=torch.float32) if Hq > Hkv else None)
    err = _FLASH_BWD[variant].launch(
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if part is None else part.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, int(causal), 1.0 / D ** 0.5)
    _build.check(err, "flash_attention_bwd")
    FLASH_ATTENTION_BWD.count(variant)
    return dq, dk, dv
