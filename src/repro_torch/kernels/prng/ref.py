"""Plain PyTorch versions of the per-leaf ``jax.random.normal`` draw (the
CPU route of ``ops``, and what ``csrc/normal.cu`` is held to on the card).

Element j of a draw under key ``(k0, k1)`` from counter ``offset``:

* ``i = offset + j`` (int64); the word ``y0 ^ y1`` of
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* the mantissa uniform: the word's high 23 bits read as a float in
  ``[1, 2)``, minus 1, scaled to ``[nextafter(-1, 0), 1)`` as
  ``max(lo, u * (hi - lo) + lo)``;
* XLA's single-precision ``erf_inv`` (Giles' polynomials), each step
  ``c + p * w`` taken in float64 (the product of two floats is exact
  there) and rounded to float32;
* times the float32 ``sqrt(2)``.

Every operation is a separate, rounded torch op, which is what the kernel
repeats with ``__f*_rn`` / ``__d*_rn``. The draws are taken ``WINDOW``
elements at a time, so that the int64 temporaries of the plain threefry
(about 20 words an element) stay a few hundred MB whatever the size.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels.zsmask.threefry import M32, threefry2x32

# elements drawn at a time by the plain versions
WINDOW = 1 << 22

# Giles, "Approximating the erfinv function" (single precision), as XLA
# lowers erf_inv for f32: w < 5 and w >= 5 branches, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(math.sqrt(2.0)))
# the normal's uniform lies on [nextafter(-1, 0), 1)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def bits(key: tuple, shape=(), offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    ``[0, 2**32)``, counted from ``offset``."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return (y0 ^ y1).reshape(shape)


def _unit(b: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): the high 23 bits as a mantissa."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: tuple, shape=(), minval=0.0, maxval=1.0, offset: int = 0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    # fills, not host copies: a copy would wait for the stream every window
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    u = _unit(bits(key, shape, offset, device))
    return torch.maximum(lo, u * (hi - lo) + lo)


@functools.lru_cache(maxsize=None)
def _erfinv_tables(device: torch.device) -> tuple:
    """The two coefficient tables as fp32 tensors on ``device``, copied
    there once per device, not once per window."""
    return (torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=device),
            torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=device))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``p(w) * x`` with ``w = -log1p(-x*x)``;
    +-inf at +-1."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lo, hi = _erfinv_tables(x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(lt, lo[i], hi[i])
        p = (c.double() + p.double() * w).float()  # one fused multiply-add
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _draw(key: tuple, n: int, offset: int, device) -> torch.Tensor:
    """``n`` normals of ``key`` from counter ``offset``: one window."""
    return _SQRT2 * erfinv(uniform(key, (n,), _LO, 1.0, offset, device))


def _windows(n: int):
    for a in range(0, n, WINDOW):
        yield a, min(a + WINDOW, n)


def normal_into(key: tuple, offset: int, out: torch.Tensor) -> torch.Tensor:
    """``out`` (contiguous fp32, any shape) <- ``jax.random.normal(key,
    out.shape)`` counted from ``offset``, a window at a time."""
    flat = out.view(-1)
    for a, b in _windows(flat.numel()):
        flat[a:b] = _draw(key, b - a, offset + a, out.device)
    return out


def normal_ref(key: tuple, n: int, offset: int = 0, device=None):
    """A new (n,) fp32 tensor of :func:`normal_into`'s draw."""
    return normal_into(key, offset, torch.empty(n, dtype=torch.float32,
                                                device=device))


def normal_combine_ref(out: torch.Tensor, key_a: tuple, key_b, offset: int,
                       sa, sb=None, g=None,
                       accumulate: bool = False) -> torch.Tensor:
    """``r = z_a * sa - (z_b * sb) * g`` (``z_a * sa`` when ``key_b`` is
    None), ``z_a`` / ``z_b`` the normals of the two keys at the counters
    ``offset ..``; ``out = out + r`` when ``accumulate``, else ``r``. The
    order of ``corrected_noise``'s window (``z.mul_(sc)``,
    ``zp.mul_(sc).mul_(gate)``, ``z.sub_(zp)``, ``flat.add_(z)``), a
    window at a time."""
    flat = out.view(-1)
    for a, b in _windows(flat.numel()):
        z = _draw(key_a, b - a, offset + a, out.device).mul_(sa)
        if key_b is not None:
            zp = _draw(key_b, b - a, offset + a, out.device)
            z.sub_(zp.mul_(sb).mul_(g))
        if accumulate:
            flat[a:b].add_(z)
        else:
            flat[a:b] = z
    return out
