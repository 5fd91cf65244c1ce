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

:func:`ssd_bwd_cuda` launches the backward, ``csrc/ssd_bwd.cu`` (the
reverse scan ``ops.SSD`` runs in training): the same inputs plus ``dy``
and ``dh`` (None is zero) -> ``(dxh, ddt, dla, dBc, dCc, dh0)``, at the
same (P, N) and any S >= 1. It sums ``dBc`` and ``dCc`` over the heads in a
second launch, in ascending head, so two calls agree bit for bit;
``ref.ssd_backward_split_ref`` is its order of sums in plain torch.
:func:`bwd_config` reads its launch configuration,
:func:`bwd_scratch_floats` the checkpoint scratch a call allocates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_tensor, countable, register,
                                          require)

SSD = register("ssd", "src/repro_torch/kernels/mamba2/csrc/ssd.cu",
               "src/repro/kernels/mamba2/mamba2.py:67")
# the backward of the same TPU kernel's forward (JAX has none: it
# differentiates its jnp chunked form)
SSD_BWD = register("ssd_bwd", "src/repro_torch/kernels/mamba2/csrc/ssd_bwd.cu",
                   "src/repro/kernels/mamba2/mamba2.py:67")

# (head dim P, state size N) pairs the kernel is instantiated for (the
# smoke configs' and zamba2-7b's), each with the threads that share a state
# row's n (csrc/ssd.cu, SsdShape::G)
GROUPS = {(16, 16): 4, (64, 64): 8}
SHAPES = tuple(GROUPS)
# tokens a pass of the backward (csrc/ssd_bwd.cu, SSDB_T): its scratch holds
# the state before each pass but the first and the last (the C entry
# refuses a smaller one)
_BWD_T = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SSD = _build.Entry("ssd_f32", [_P] * 8 + [_I] * 5 + [_P])
_SSD_BWD = _build.Entry("ssd_bwd_f32", [_P] * 9 + [ctypes.c_longlong]
                        + [_P] * 8 + [_I] * 5 + [_P])
_CONFIG = ("rows", "groups", "tokens", "threads", "smem_bytes",
           "blocks_per_sm")
_BWD_CONFIG = ("rows", "warps", "tokens", "sub_tokens", "threads",
               "smem_bytes", "blocks_per_sm")


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


def bwd_config(P: int, N: int) -> dict:
    """The backward's launch configuration at (P, N), as the built library
    reports it (on the card): state rows a thread, warps a block (four
    column groups each), tokens a pass (between global checkpoints) and a
    sub-chunk (between shared-memory ones), threads and shared bytes a
    block, and the blocks an SM the card's occupancy calculator allows."""
    fn = _build.library().ssd_bwd_config
    fn.argtypes, fn.restype = [_I, _I, _P], _I
    cfg = (ctypes.c_int * len(_BWD_CONFIG))()
    _build.check(fn(P, N, cfg), "ssd_bwd_config")
    return dict(zip(_BWD_CONFIG, cfg))


def bwd_scratch_floats(B: int, S: int, nh: int, P: int, N: int) -> int:
    """The floats of checkpoint scratch ``ssd_bwd_cuda`` allocates."""
    return B * nh * max(-(-S // _BWD_T) - 2, 0) * P * N


def _check_inputs(xh, dt, la, Bc, Cc, h0, dev, what: str):
    """What both kernels take; returns (B, S, nh, P, N)."""
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
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
    for name, t in (("xh", xh), ("Bc", Bc), ("Cc", Cc), ("h0", h0)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    return B, S, nh, P, N


@countable("ssd")
def ssd_cuda(xh, dt, la, Bc, Cc, h0):
    """Launch the SSD scan; returns (y, final h)."""
    dev = xh.device
    B, S, nh, P, N = _check_inputs(xh, dt, la, Bc, Cc, h0, dev, "ssd_cuda")
    ptrs = (xh.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), h0.data_ptr())
    y = torch.empty_like(xh)
    h = torch.empty_like(h0)
    if B == 0:
        return y, h
    err = _SSD.launch(dev, ptrs[0], dt.data_ptr(), la.data_ptr(), *ptrs[1:],
                      y.data_ptr(), h.data_ptr(), B, S, nh, P, N)
    _build.check(err, "ssd")
    SSD.launches += 1
    return y, h


@countable("ssd_bwd")
def ssd_bwd_cuda(xh, dt, la, Bc, Cc, h0, dy, dh=None):
    """Launch the SSD scan's backward; returns ``(dxh, ddt, dla, dBc, dCc,
    dh0)``, the gradients of ``ssd_cuda``'s ``(y, h)`` given ``dy``
    (B, S, nh, P) and ``dh`` (B, nh, P, N; None is zero)."""
    dev = xh.device
    B, S, nh, P, N = _check_inputs(xh, dt, la, Bc, Cc, h0, dev,
                                   "ssd_bwd_cuda")
    check_tensor("dy", dy, torch.float32, 4, dev)
    if dy.shape != xh.shape:
        raise ValueError(f"dy {tuple(dy.shape)}, expected {tuple(xh.shape)}")
    if dh is not None:
        check_tensor("dh", dh, torch.float32, 4, dev)
        if dh.shape != h0.shape:
            raise ValueError(f"dh {tuple(dh.shape)}, expected "
                             f"{tuple(h0.shape)}")
    for name, t in (("dy", dy), ("dh", dh)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    dxh, dBc, dCc, dh0 = (torch.empty_like(t) for t in (xh, Bc, Cc, h0))
    ddt, dla = torch.empty_like(dt), torch.empty_like(la)
    if B == 0:
        return dxh, ddt, dla, dBc, dCc, dh0
    ckpt = torch.empty(bwd_scratch_floats(B, S, nh, P, N), device=dev,
                       dtype=torch.float32)
    dB_part = torch.empty(B, S, nh, N, device=dev, dtype=torch.float32)
    dC_part = torch.empty_like(dB_part)
    err = _SSD_BWD.launch(
        dev, xh.data_ptr(), dt.data_ptr(), la.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), h0.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), ckpt.data_ptr(), ckpt.numel(),
        dB_part.data_ptr(), dC_part.data_ptr(), dxh.data_ptr(),
        ddt.data_ptr(), dla.data_ptr(), dBc.data_ptr(), dCc.data_ptr(),
        dh0.data_ptr(), B, S, nh, P, N)
    _build.check(err, "ssd_bwd")
    SSD_BWD.launches += 1
    return dxh, ddt, dla, dBc, dCc, dh0
