"""CUDA wrapper of the Mamba-2 SSD scan kernel.

The kernel is in ``csrc/ssd.cu`` (its header says which TPU kernel it
replaces, what bounds it on an H100, and how the design answers that). The
wrapper checks what the kernel takes, allocates the outputs, launches on
the current stream, raises on a CUDA error and counts the launch. CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.

xh (B, S, nh, P); dt, la (B, S, nh); Bc, Cc (B, S, N); h0 (B, nh, P, N),
fp32, contiguous, (P, N) in ``SHAPES``, any S >= 1 -> (y (B, S, nh, P),
h (B, nh, P, N)). The kernel copies xh, Bc, Cc and h0 16 bytes at a time:
their data must be 16-byte aligned.

The kernel sums each y_t[p] over ``GROUPS[(P, N)]`` threads of a state
row; ``ref.ssd_split_ref`` is that order in plain torch.
:func:`kernel_config` reads the launch configuration from the built
library (the card tests hold its groups to ``GROUPS``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_tensor, register, require

SSD = register("ssd", "src/repro_torch/kernels/mamba2/csrc/ssd.cu",
               "src/repro/kernels/mamba2/mamba2.py:67")

# (head dim P, state size N) pairs the kernel is instantiated for (the
# smoke configs' and zamba2-7b's), each with the threads that share a state
# row's n (csrc/ssd.cu, SsdShape::G)
GROUPS = {(16, 16): 4, (64, 64): 8}
SHAPES = tuple(GROUPS)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SSD = _build.Entry("ssd_f32", [_P] * 8 + [_I] * 5 + [_P])
_CONFIG = ("rows", "groups", "tokens", "threads", "smem_bytes",
           "blocks_per_sm")


def kernel_config(P: int, N: int) -> dict:
    """The launch configuration the built library reports at (P, N) (on
    the card; builds the library at first use): state rows a thread,
    threads a row, tokens staged a pass, threads and shared bytes a block,
    and the blocks an SM the card's occupancy calculator allows."""
    fn = _build.library().ssd_config
    fn.argtypes, fn.restype = [_I, _I, _P], _I
    cfg = (ctypes.c_int * len(_CONFIG))()
    _build.check(fn(P, N, cfg), "ssd_config")
    return dict(zip(_CONFIG, cfg))


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
    if (P, N) not in SHAPES:
        raise ValueError(f"(P, N) = ({P}, {N}) not in {SHAPES}")
    require(S >= 1, "empty sequence")
    if not dt.shape == la.shape == (B, S, nh):
        raise ValueError(f"dt {tuple(dt.shape)}, la {tuple(la.shape)}, "
                         f"expected ({B}, {S}, {nh})")
    if not Bc.shape == Cc.shape == (B, S, N):
        raise ValueError(f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, "
                         f"expected ({B}, {S}, {N})")
    if h0.shape != (B, nh, P, N):
        raise ValueError(f"h0 {tuple(h0.shape)}, expected "
                         f"({B}, {nh}, {P}, {N})")
    ptrs = (xh.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), h0.data_ptr())
    for name, ptr in zip(("xh", "Bc", "Cc", "h0"), ptrs):
        if ptr % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    y = torch.empty_like(xh)
    h = torch.empty_like(h0)
    if B == 0:
        return y, h
    err = _SSD.launch(dev, ptrs[0], dt.data_ptr(), la.data_ptr(), *ptrs[1:],
                      y.data_ptr(), h.data_ptr(), B, S, nh, P, N)
    _build.check(err, "ssd")
    SSD.launches += 1
    return y, h
