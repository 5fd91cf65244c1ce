"""CUDA wrapper of the per-leaf zero-sum mask kernel.

The kernel is in ``csrc/zsmask.cu`` (its header says which TPU kernel it
replaces, what bounds it on an H100, and how the design answers that). The
wrapper checks what the kernel takes, allocates the output, launches on the
current stream, raises on a CUDA error and counts the launch. CUDA tensors
only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_key, check_tensor, register,
                                          require)

ZSMASK = register(
    "zsmask",
    "src/repro_torch/kernels/zsmask/csrc/zsmask.cu",
    "src/repro/kernels/zsmask/zsmask.py:51")

_P, _L, _U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32
_ZSMASK = _build.Entry("zsmask_f32", [_P, _P, _L] + [_U] * 7 + [_P, _P])


def zsmask_cuda(g, scalars, key_r, key_xi, silo: int, nxt: int,
                offset: int = 0, out=None) -> torch.Tensor:
    """Launch the kernel: g (D,) fp32; scalars (2,) fp32 on the same card,
    ``(s, b)``; keys (k0, k1) ints; ``silo`` and ``nxt`` the stream ids;
    ``offset`` the uint32 counter of g's first element -> (D,) fp32,
    written into ``out`` when given (``g`` itself included)."""
    dev = g.device
    require(dev.type == "cuda", "zsmask_cuda takes CUDA tensors")
    check_tensor("g", g, torch.float32, 1, dev)
    check_tensor("scalars", scalars, torch.float32, 1, dev)
    require(scalars.shape == (2,), f"scalars {tuple(scalars.shape)}, "
                                   f"expected (2,): s, b")
    require(0 <= silo <= 0xFFFFFFFF and 0 <= nxt <= 0xFFFFFFFF,
            f"stream ids must be uint32, got silo {silo}, nxt {nxt}")
    require(0 <= offset <= 0xFFFFFFFF, f"offset {offset} is not a uint32")
    kr, kx = check_key("key_r", key_r), check_key("key_xi", key_xi)
    D = g.shape[0]
    if out is None:
        out = torch.empty_like(g)
    check_tensor("out", out, torch.float32, 1, dev)
    require(out.shape == g.shape, f"out {tuple(out.shape)}, expected ({D},)")
    a, b = g.data_ptr(), out.data_ptr()
    require(a == b or b + 4 * D <= a or a + 4 * D <= b,
            "out must be g itself or disjoint from it")
    if D == 0:
        return out
    err = _ZSMASK.launch(dev, g.data_ptr(), out.data_ptr(), D, kr[0], kr[1],
                         kx[0], kx[1], int(silo), int(nxt), int(offset),
                         scalars.data_ptr())
    _build.check(err, "zsmask")
    ZSMASK.launches += 1
    return out
