"""CUDA wrapper of the Mamba-2 SSD scan kernel.

The kernel is in ``csrc/ssd.cu`` (its header says which TPU kernel it
replaces, what bounds it on an H100, and how the design answers that). The
wrapper checks what the kernel takes, allocates the outputs, launches on
the current stream, raises on a CUDA error and counts the launch. CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.

xh (B, S, nh, P); dt, la (B, S, nh); Bc, Cc (B, S, N); h0 (B, nh, P, N),
fp32, contiguous, (P, N) in ``SHAPES``, any S >= 1 -> (y (B, S, nh, P),
h (B, nh, P, N)).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_tensor, register, require

SSD = register("ssd", "src/repro_torch/kernels/mamba2/csrc/ssd.cu",
               "src/repro/kernels/mamba2/mamba2.py:67")

# (head dim P, state size N) pairs the kernel is instantiated for: the
# smoke configs' and zamba2-7b's
SHAPES = ((16, 16), (64, 64))

_P, _I = ctypes.c_void_p, ctypes.c_int
_SSD = _build.Entry("ssd_f32", [_P] * 8 + [_I] * 5 + [_P])


def ssd_cuda(xh, dt, la, Bc, Cc, h0):
    """Launch the SSD scan; returns (y, final h)."""
    dev = xh.device
    require(dev.type == "cuda", "ssd_cuda takes CUDA tensors")
    check_tensor("xh", xh, torch.float32, 4, dev)
    for name, t in (("dt", dt), ("la", la)):
        check_tensor(name, t, torch.float32, 3, dev)
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        check_tensor(name, t, torch.float32, 3, dev)
    check_tensor("h0", h0, torch.float32, 4, dev)
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    require((P, N) in SHAPES, f"(P, N) = ({P}, {N}) not in {SHAPES}")
    require(S >= 1, "empty sequence")
    require(dt.shape == la.shape == (B, S, nh),
            f"dt {tuple(dt.shape)}, la {tuple(la.shape)}, expected "
            f"({B}, {S}, {nh})")
    require(Bc.shape == Cc.shape == (B, S, N),
            f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, expected "
            f"({B}, {S}, {N})")
    require(h0.shape == (B, nh, P, N),
            f"h0 {tuple(h0.shape)}, expected ({B}, {nh}, {P}, {N})")
    y = torch.empty_like(xh)
    h = torch.empty_like(h0)
    if B == 0:
        return y, h
    err = _SSD.launch(dev, xh.data_ptr(), dt.data_ptr(), la.data_ptr(),
                      Bc.data_ptr(), Cc.data_ptr(), h0.data_ptr(),
                      y.data_ptr(), h.data_ptr(), B, S, nh, P, N)
    _build.check(err, "ssd")
    SSD.launches += 1
    return y, h
