"""Public API of the per-leaf normal draw: the CUDA kernel
(``csrc/normal.cu``) for CUDA tensors, the plain version (``ref``) for CPU
tensors (``kernels.dispatch.on_cuda``). A wrapper checks what its kernel
takes, launches on the current stream, raises on a CUDA error and counts
the launch. The kernel draws any length in one launch; the plain version
draws ``ref.WINDOW`` elements at a time.

Keys are raw ``(k0, k1)`` uint32 pairs; ``offset`` is the counter of the
output's first element (a stacked leaf's tensor starts at its place in the
leaf). The scalars of ``normal_combine`` are 0-dim fp32 tensors on the
output's device, read there (no host copy, no stream wait).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (check_key, check_tensor, countable,
                                          on_cuda, register, require)
from repro_torch.kernels.prng import ref

NORMAL = register(
    "normal",
    "src/repro_torch/kernels/prng/csrc/normal.cu",
    "none (a port kernel): JAX's jnp jax.random.normal draws of the admin "
    "masks, src/repro/core/masking.py:147-150, :189-196, :214 "
    "(admin_masks, admin_mask_row, admin_xi)")
NORMAL_COMBINE = register(
    "normal_combine",
    "src/repro_torch/kernels/prng/csrc/normal.cu",
    "none (a port kernel): JAX's jnp jax.random.normal in _noise_like, "
    "src/repro/core/noise_correction.py:50-56, behind corrected_noise "
    ":59-70; the admin xi with its correction, core/masking.py:150-152")

_P, _I, _L, _Q, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_ulonglong, ctypes.c_uint32)
# the current stream's raw handle last (_build.Entry.launch passes it)
_NORMAL = _build.Entry("normal_f32", [_P, _L, _Q, _U, _U, _P])
_NORMAL_COMBINE = _build.Entry("normal_combine_f32", [_P, _L, _Q] + [_U] * 4
                               + [_I, _P, _P, _P, _I, _P])

# the plain version's counters are int64: offset + n stays below 2**63
_MAX_COUNTER = 1 << 63
CONFIG = ("threads", "width", "blocks_per_sm", "registers", "local_bytes")


def _check_out(out: torch.Tensor, offset: int) -> int:
    require(out.dtype == torch.float32 and out.is_contiguous(),
            f"out: a contiguous fp32 tensor, got {out.dtype}"
            f"{'' if out.is_contiguous() else ', not contiguous'}")
    offset = int(offset)
    require(0 <= offset and offset + out.numel() <= _MAX_COUNTER,
            f"counters {offset} .. {offset} + {out.numel()} out of range")
    return offset


def normal(key, offset: int, out: torch.Tensor) -> torch.Tensor:
    """``out`` <- ``jax.random.normal(key, out.shape, float32)`` counted
    from ``offset``: one launch on the card."""
    offset = _check_out(out, offset)
    if not on_cuda(out):
        return ref.normal_into(key, offset, out)
    k = check_key("key", key)
    if out.numel() == 0:
        return out
    err = _NORMAL.launch(out.device, out.data_ptr(), out.numel(), offset,
                         k[0], k[1])
    _build.check(err, "normal")
    NORMAL.launches += 1
    return out


@countable("normal_combine")
def normal_combine(out: torch.Tensor, key_a, key_b, offset: int, sa,
                   sb=None, g=None, accumulate: bool = False) -> torch.Tensor:
    """``out`` <- ``out + r`` (``accumulate``) or ``r``, with ``r = z_a *
    sa - (z_b * sb) * g``, or ``z_a * sa`` when ``key_b`` is None (``sb``
    and ``g`` unused then): ``corrected_noise``'s window in one pass, one
    launch on the card. ``sa``, ``sb``, ``g``: 0-dim fp32 tensors on
    ``out``'s device."""
    offset = _check_out(out, offset)
    scalars = (sa,) if key_b is None else (sa, sb, g)
    for name, s in zip(("sa", "sb", "g"), scalars):
        require(isinstance(s, torch.Tensor), f"{name}: a 0-dim fp32 tensor, "
                                             f"got {type(s).__name__}")
        check_tensor(name, s, torch.float32, 0, out.device)
    if not on_cuda(out, *scalars):
        return ref.normal_combine_ref(out, key_a, key_b, offset, sa, sb, g,
                                      accumulate)
    ka = check_key("key_a", key_a)
    kb = (0, 0) if key_b is None else check_key("key_b", key_b)
    if out.numel() == 0:
        return out
    sb_p, g_p = (None, None) if key_b is None else (sb.data_ptr(),
                                                    g.data_ptr())
    err = _NORMAL_COMBINE.launch(
        out.device, out.data_ptr(), out.numel(), offset, ka[0], ka[1], kb[0],
        kb[1], int(key_b is not None), sa.data_ptr(), sb_p, g_p,
        int(bool(accumulate)))
    _build.check(err, "normal_combine")
    NORMAL_COMBINE.launches += 1
    return out


def config(kernel: str) -> dict:
    """The launch configuration the built library reports for ``kernel``,
    ``"normal"`` or ``"normal_combine"`` (its two-key instantiation), on
    the current card (builds the library at first use)."""
    fn = _build.library().normal_config
    fn.argtypes, fn.restype = [_I, _P], _I
    cfg = (ctypes.c_int * len(CONFIG))()
    _build.check(fn(("normal", "normal_combine").index(kernel), cfg),
                 f"{kernel} config")
    return dict(zip(CONFIG, cfg))
