"""CUDA wrappers of the per-leaf zero-sum mask kernels: one tensor
(``zsmask``) and every tensor of a packed buffer in one launch
(``zsmask_buffer``, counted by instantiation: ``plain``, and ``prev`` with
the lambda correction fused in, over an fp32 buffer; ``bf16`` and
``bf16_prev`` over the bf16 leaves of a bf16 or mixed tree, read from a
packed bf16 buffer into the fp32 contribution row).

The kernels are in ``csrc/zsmask.cu`` (its header says which TPU kernel they
replace, what bounds them on an H100, and how the design answers that). A
wrapper checks what its kernel takes, allocates the output, launches on the
current stream, raises on a CUDA error and counts the launch. The buffer
kernel's table of tensors (``core/flatbuf.leaf_table``) is copied to each
card once per layout (:func:`buffer_table`). CUDA tensors only; ``ops``
routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_key, check_tensor, register,
                                          require)

ZSMASK = register(
    "zsmask",
    "src/repro_torch/kernels/zsmask/csrc/zsmask.cu",
    "src/repro/kernels/zsmask/zsmask.py:51")

ZSMASK_BUFFER = register(
    "zsmask_buffer",
    "src/repro_torch/kernels/zsmask/csrc/zsmask.cu",
    "src/repro/kernels/zsmask/zsmask.py:51",
    variants=("plain", "prev", "bf16", "bf16_prev"))

_P, _L, _U, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                  ctypes.c_int)
_ZSMASK = _build.Entry("zsmask_f32", [_P, _P, _L] + [_U] * 7 + [_P, _P])
_ZSMASK_BUFFER = _build.Entry("zsmask_buffer_f32",
                              [_P, _P, _I, _L] + [_U] * 9 + [_P] * 3
                              + [_I, _P])
_ZSMASK_BUFFER_BF16 = _build.Entry("zsmask_buffer_bf16",
                                   [_P, _P, _P, _I, _L] + [_U] * 9
                                   + [_P] * 3 + [_I, _P])
MAX_TENSORS = 6143  # the table's prefix in 48 KB of shared memory
BUFFER_CONFIG = ("threads", "width", "blocks_per_sm", "registers",
                 "local_bytes")


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


@functools.lru_cache(maxsize=32)
def buffer_table(layout, device: torch.device, dtype=None) -> tuple:
    """``(table, E, total)``: the layout's tensor table as an (E, 5) int64
    tensor on ``device`` (built and copied once per layout, card and
    ``dtype``: the leaves of that dtype name only, every leaf when None),
    its rows and its tensors' elements (E 0: no such leaf)."""
    rows = flatbuf.leaf_table(layout, dtype)
    if not rows:
        return None, 0, 0
    require(len(rows) <= MAX_TENSORS, f"zsmask_buffer takes at most "
                                      f"{MAX_TENSORS} tensors, the layout "
                                      f"has {len(rows)}")
    return (torch.tensor(rows, dtype=torch.int64).to(device), len(rows),
            rows[-1][4] + rows[-1][1])


def _word(name, x, dev) -> torch.Tensor:
    check_tensor(name, x, torch.float32, 0, dev)
    return x


def _checked(buf, layout, sigma_c, b_scale, key_r, key_xi, silo: int,
             nxt: int, n_silos: int, prev_key, lam) -> tuple:
    """The buffer kernels' common checks: ``(scalars' pointers, keys)``."""
    dev = buf.device
    if buf.shape[0] != layout.total:
        raise ValueError(f"buffer ({buf.shape[0]},), the layout's packed "
                         f"buffer is ({layout.total},)")
    sig, bs = _word("sigma_c", sigma_c, dev), _word("b_scale", b_scale, dev)
    use_prev = prev_key is not None
    lw = _word("lam", lam, dev) if use_prev else sig  # unread without prev
    require(0 <= silo <= 0xFFFFFFFF and 0 <= nxt <= 0xFFFFFFFF
            and 1 <= n_silos <= 0xFFFFFFFF, "stream ids and the ring's size "
                                             "must be uint32")
    kr, kx = check_key("key_r", key_r), check_key("key_xi", key_xi)
    kp = check_key("prev_key", prev_key) if use_prev else (0, 0)
    return ((sig.data_ptr(), bs.data_ptr(), lw.data_ptr(), int(use_prev)),
            (kr[0], kr[1], kx[0], kx[1], kp[0], kp[1], int(silo), int(nxt),
             int(n_silos)))


def zsmask_buffer_cuda(buf, layout, sigma_c, b_scale, key_r, key_xi,
                       silo: int, nxt: int, n_silos: int, prev_key=None,
                       lam=None, dtype=None) -> torch.Tensor:
    """Launch the fp32 buffer kernel: ``buf`` the packed (P,) fp32 buffer
    of ``layout``, masked in place and returned; ``sigma_c``, ``b_scale``
    and ``lam`` 0-dim fp32 tensors on the same card, read there (``s =
    sigma_c / sqrt(n_silos)`` is divided in the kernel); raw keys (k0, k1)
    ints, folded per leaf in the kernel; ``silo`` and ``nxt`` the stream
    ids; ``prev_key`` given: the lambda correction's pass fused in, times
    ``lam``; ``dtype`` (a name) masks that dtype's leaves only (None:
    every leaf; no launch when there is none)."""
    dev = buf.device
    require(dev.type == "cuda", "zsmask_buffer_cuda takes CUDA tensors")
    check_tensor("buf", buf, torch.float32, 1, dev)
    words, keys = _checked(buf, layout, sigma_c, b_scale, key_r, key_xi,
                           silo, nxt, n_silos, prev_key, lam)
    table, E, total = buffer_table(layout, dev, dtype)
    if E == 0:
        return buf
    err = _ZSMASK_BUFFER.launch(dev, buf.data_ptr(), table.data_ptr(), E,
                                total, *keys, *words)
    _build.check(err, "zsmask_buffer")
    ZSMASK_BUFFER.count("prev" if prev_key is not None else "plain")
    return buf


def zsmask_buffer_bf16_cuda(src, out, layout, sigma_c, b_scale, key_r,
                            key_xi, silo: int, nxt: int, n_silos: int,
                            prev_key=None, lam=None) -> torch.Tensor:
    """Launch the bf16 buffer kernel over the bf16 leaves of ``layout``:
    ``src`` the packed (P,) bf16 buffer of the clipped leaves, ``out`` the
    (P,) fp32 contribution row, written over those leaves' tensors and
    returned (``kernels/zsmask/ref.py``'s sequence); the rest as
    :func:`zsmask_buffer_cuda`. No launch when no leaf is bf16."""
    dev = out.device
    require(dev.type == "cuda", "zsmask_buffer_bf16_cuda takes CUDA tensors")
    check_tensor("src", src, torch.bfloat16, 1, dev)
    check_tensor("out", out, torch.float32, 1, dev)
    require(src.shape == out.shape, "src and out are one layout's buffers")
    words, keys = _checked(out, layout, sigma_c, b_scale, key_r, key_xi,
                           silo, nxt, n_silos, prev_key, lam)
    table, E, total = buffer_table(layout, dev, "bfloat16")
    if E == 0:
        return out
    err = _ZSMASK_BUFFER_BF16.launch(dev, src.data_ptr(), out.data_ptr(),
                                     table.data_ptr(), E, total, *keys,
                                     *words)
    _build.check(err, "zsmask_buffer")
    ZSMASK_BUFFER.count("bf16_prev" if prev_key is not None else "bf16")
    return out


def buffer_config(use_prev: bool, bf16: bool = False) -> dict:
    """A buffer kernel's launch configuration on the current card (the
    fp32 or the bf16 instantiation), as the built library reports it
    (builds it at first use): threads a block, elements a thread at a
    time, blocks an SM, registers and local bytes a thread."""
    lib = _build.library()
    cfg = (ctypes.c_int * len(BUFFER_CONFIG))()
    fn = lib.zsmask_buffer_config
    fn.argtypes, fn.restype = [_I, _P], _I
    _build.check(fn(int(use_prev) + 2 * int(bf16), cfg),
                 "zsmask_buffer config")
    return dict(zip(BUFFER_CONFIG, cfg))
