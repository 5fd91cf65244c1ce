"""CUDA wrapper of the RWKV-6 WKV scan kernel.

The kernel is in ``csrc/wkv.cu`` (its header says which TPU kernel it
replaces, what bounds it on an H100, and how the design answers that). The
wrapper checks what the kernel takes, allocates the outputs, launches on
the current stream, raises on a CUDA error and counts the launch. CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.

r, k, v, w (B, S, H, N); u (H, N); state0 (B, H, N, N), fp32, contiguous,
N in ``HEAD_SIZES``, any S >= 1 -> (o (B, S, H, N), state (B, H, N, N)).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_tensor, register, require

WKV = register("wkv", "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
               "src/repro/kernels/rwkv6/rwkv6.py:70")

# head sizes the kernel is instantiated for (csrc/wkv.cu)
HEAD_SIZES = (16, 32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_WKV = _build.Entry("wkv_f32", [_P] * 8 + [_I] * 4 + [_P])


def wkv_cuda(r, k, v, w, u, state0):
    """Launch the WKV scan; returns (o, final state)."""
    dev = r.device
    require(dev.type == "cuda", "wkv_cuda takes CUDA tensors")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_tensor(name, t, torch.float32, 4, dev)
    check_tensor("u", u, torch.float32, 2, dev)
    check_tensor("state0", state0, torch.float32, 4, dev)
    B, S, H, N = r.shape
    require(k.shape == v.shape == w.shape == r.shape,
            f"r/k/v/w shapes differ: {[tuple(t.shape) for t in (r, k, v, w)]}")
    require(N in HEAD_SIZES, f"head size {N} not in {HEAD_SIZES}")
    require(S >= 1, "empty sequence")
    require(u.shape == (H, N), f"u {tuple(u.shape)}, expected ({H}, {N})")
    require(state0.shape == (B, H, N, N),
            f"state0 {tuple(state0.shape)}, expected ({B}, {H}, {N}, {N})")
    o = torch.empty_like(r)
    state = torch.empty_like(state0)
    if B == 0:
        return o, state
    err = _WKV.launch(dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      w.data_ptr(), u.data_ptr(), state0.data_ptr(),
                      o.data_ptr(), state.data_ptr(), B, S, H, N)
    _build.check(err, "wkv")
    WKV.launches += 1
    return o, state
