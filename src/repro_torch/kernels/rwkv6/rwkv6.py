"""CUDA wrapper of the RWKV-6 WKV scan kernel.

The kernel is in ``csrc/wkv.cu`` (its header says which TPU kernel it
replaces, what bounds it on an H100, and how the design answers that). The
wrapper checks what the kernel takes, allocates the outputs, launches on
the current stream, raises on a CUDA error and counts the launch. CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.

r, k, v, w (B, S, H, N); u (H, N); state0 (B, H, N, N), fp32, contiguous,
N in ``HEAD_SIZES``, any S >= 1 -> (o (B, S, H, N), state (B, H, N, N)).
The kernel copies r, k, v, w and state0 16 bytes at a time: their data
must be 16-byte aligned.

The kernel sums each o_t[j] over ``GROUPS[N]`` threads of a state column;
``ref.wkv_split_ref`` is that order in plain torch. :func:`kernel_config`
reads the launch configuration from the built library (the card tests
hold its groups to ``GROUPS``).

:func:`wkv_bwd_cuda` launches the backward, ``csrc/wkv_bwd.cu`` (the
reverse scan ``ops.WKV`` runs in training): the same inputs plus ``do``
and ``dstate`` (None is zero) -> ``(dr, dk, dv, dw, du, dstate0)``, at the
same head sizes and any S >= 1. It sums ``du`` over b in a second launch,
in ascending b, so two calls agree bit for bit; ``ref.wkv_backward_split_ref``
is its order of sums in plain torch. :func:`bwd_config` reads its launch
configuration, :func:`bwd_scratch_floats` the checkpoint scratch a call
allocates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_tensor, countable, register,
                                          require)

WKV = register("wkv", "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
               "src/repro/kernels/rwkv6/rwkv6.py:70")
# the backward of the same TPU kernel's forward (JAX has none: it
# differentiates its jnp chunked forms)
WKV_BWD = register("wkv_bwd", "src/repro_torch/kernels/rwkv6/csrc/wkv_bwd.cu",
                   "src/repro/kernels/rwkv6/rwkv6.py:70")

# head sizes the kernel is instantiated for, each with the threads that
# share a state column's n (csrc/wkv.cu, WkvShape::G)
GROUPS = {16: 4, 32: 4, 64: 8}
HEAD_SIZES = tuple(GROUPS)
# tokens a pass of the backward (csrc/wkv_bwd.cu, WKVB_T): its scratch holds
# the state before each pass but the first and the last (the C entry
# refuses a smaller one)
_BWD_T = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_WKV = _build.Entry("wkv_f32", [_P] * 8 + [_I] * 4 + [_P])
_WKV_BWD = _build.Entry("wkv_bwd_f32", [_P] * 9 + [ctypes.c_longlong]
                        + [_P] * 7 + [_I] * 4 + [_P])
_CONFIG = ("cols", "groups", "tokens", "threads", "smem_bytes",
           "blocks_per_sm")
_BWD_CONFIG = ("rows", "lanes_a_row", "tokens", "sub_tokens", "threads",
               "smem_bytes", "blocks_per_sm")


def kernel_config(N: int) -> dict:
    """The launch configuration the built library reports at head size N
    (on the card; builds the library at first use): state columns a
    thread, threads a column, tokens staged a pass, threads and shared
    bytes a block, and the blocks an SM the card's occupancy calculator
    allows."""
    fn = _build.library().wkv_config
    fn.argtypes, fn.restype = [_I, _P], _I
    cfg = (ctypes.c_int * len(_CONFIG))()
    _build.check(fn(N, cfg), "wkv_config")
    return dict(zip(_CONFIG, cfg))


def bwd_config(N: int) -> dict:
    """The backward's launch configuration at head size N, as the built
    library reports it (on the card): state rows a thread, lanes that share
    a row, tokens a pass (between global checkpoints) and a sub-chunk
    (between shared-memory ones), threads and shared bytes a block, and the
    blocks an SM the card's occupancy calculator allows."""
    fn = _build.library().wkv_bwd_config
    fn.argtypes, fn.restype = [_I, _P], _I
    cfg = (ctypes.c_int * len(_BWD_CONFIG))()
    _build.check(fn(N, cfg), "wkv_bwd_config")
    return dict(zip(_BWD_CONFIG, cfg))


def bwd_scratch_floats(B: int, S: int, H: int, N: int) -> int:
    """The floats of checkpoint scratch ``wkv_bwd_cuda`` allocates."""
    return B * H * max(-(-S // _BWD_T) - 2, 0) * N * N


def _check_inputs(r, k, v, w, u, state0, dev, what: str):
    """What both kernels take; returns (B, S, H, N)."""
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_tensor(name, t, torch.float32, 4, dev)
    check_tensor("u", u, torch.float32, 2, dev)
    check_tensor("state0", state0, torch.float32, 4, dev)
    B, S, H, N = r.shape
    if not k.shape == v.shape == w.shape == r.shape:
        raise ValueError(f"r/k/v/w shapes differ: "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not in {HEAD_SIZES}")
    require(S >= 1, "empty sequence")
    if u.shape != (H, N):
        raise ValueError(f"u {tuple(u.shape)}, expected ({H}, {N})")
    if state0.shape != (B, H, N, N):
        raise ValueError(f"state0 {tuple(state0.shape)}, expected "
                         f"({B}, {H}, {N}, {N})")
    for name, t in (*zip("rkvw", (r, k, v, w)), ("state0", state0)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    return B, S, H, N


@countable("wkv")
def wkv_cuda(r, k, v, w, u, state0):
    """Launch the WKV scan; returns (o, final state)."""
    dev = r.device
    B, S, H, N = _check_inputs(r, k, v, w, u, state0, dev, "wkv_cuda")
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr())
    o = torch.empty_like(r)
    state = torch.empty_like(state0)
    if B == 0:
        return o, state
    err = _WKV.launch(dev, *ptrs, u.data_ptr(), state0.data_ptr(),
                      o.data_ptr(), state.data_ptr(), B, S, H, N)
    _build.check(err, "wkv")
    WKV.launches += 1
    return o, state


@countable("wkv_bwd")
def wkv_bwd_cuda(r, k, v, w, u, state0, do, dstate=None):
    """Launch the WKV scan's backward; returns ``(dr, dk, dv, dw, du,
    dstate0)``, the gradients of ``wkv_cuda``'s ``(o, state)`` given ``do``
    (B, S, H, N) and ``dstate`` (B, H, N, N; None is zero)."""
    dev = r.device
    B, S, H, N = _check_inputs(r, k, v, w, u, state0, dev, "wkv_bwd_cuda")
    check_tensor("do", do, torch.float32, 4, dev)
    if do.shape != r.shape:
        raise ValueError(f"do {tuple(do.shape)}, expected {tuple(r.shape)}")
    if dstate is not None:
        check_tensor("dstate", dstate, torch.float32, 4, dev)
        if dstate.shape != state0.shape:
            raise ValueError(f"dstate {tuple(dstate.shape)}, expected "
                             f"{tuple(state0.shape)}")
    for name, t in (("do", do), ("dstate", dstate)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    ds0 = torch.empty_like(state0)
    if B == 0:
        return dr, dk, dv, dw, du, ds0
    ckpt = torch.empty(bwd_scratch_floats(B, S, H, N), device=dev,
                       dtype=torch.float32)
    du_part = torch.empty(B, H, N, device=dev, dtype=torch.float32)
    err = _WKV_BWD.launch(
        dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), state0.data_ptr(), do.data_ptr(),
        None if dstate is None else dstate.data_ptr(), ckpt.data_ptr(),
        ckpt.numel(), du_part.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(), B, S, H,
        N)
    _build.check(err, "wkv_bwd")
    WKV_BWD.launches += 1
    return dr, dk, dv, dw, du, ds0
