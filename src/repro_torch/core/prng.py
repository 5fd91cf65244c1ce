"""The slice of ``jax.random`` the training path uses, bit for bit.

JAX (with ``jax_threefry_partitionable``, the default of the reference's
jax) derives every key and every random word with threefry2x32 on counters
``(hi, lo)``. Keys here are ``(k0, k1)`` tuples of ints, the two uint32 words
of JAX's raw key data:

* ``PRNGKey(seed) = (seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* ``split(k, n)[i] = threefry2x32(k, (0, i))``;
* ``bits(k, shape)``: element i (row-major) is ``y0 ^ y1`` of
  ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``. ``offset`` starts the
  count at ``offset``: the tensors of a stacked ``layers.*`` leaf, which the
  port holds as a list, draw slice by slice what the whole leaf draws;
* ``uniform``: the mantissa trick, bits ``>> 9 | 0x3F800000`` read as a
  float in ``[1, 2)``, minus 1, scaled to ``[minval, maxval)``;
* ``normal``: ``uniform`` on ``[nextafter(-1, 0), 1)``, then
  ``sqrt(2) * erfinv``, with XLA's single-precision ``erfinv`` (Giles'
  polynomials, each step ``c + p * w`` one fused multiply-add, taken exactly
  in float64 and rounded once).

The bits and the uniforms are exact. ``erfinv`` goes through ``log1p``,
which is libm's here and XLA's own in JAX: the normals agree with JAX's
within 3 ulp (measured over 2**21 draws: 97% equal).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels.zsmask.threefry import M32, threefry2x32

# elements drawn at a time: bounds the int64 temporaries of the plain
# threefry (about 20 words of 8 bytes an element)
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


def _words(key: tuple, c0, c1) -> list:
    """The (y0, y1) words of threefry2x32(key, (c0[i], c1[i])) as ints."""
    y0, y1 = threefry2x32(key[0], key[1],
                          torch.as_tensor(c0, dtype=torch.int64),
                          torch.as_tensor(c1, dtype=torch.int64))
    return [(int(a), int(b)) for a, b in zip(y0.reshape(-1).tolist(),
                                             y1.reshape(-1).tolist())]


def PRNGKey(seed: int) -> tuple:
    seed = int(seed)
    return ((seed >> 32) & M32, seed & M32)


def fold_in(key: tuple, data: int) -> tuple:
    return _words(key, [0], [int(data) & M32])[0]


def split(key: tuple, n: int) -> list:
    return _words(key, [0] * n, list(range(n)))


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


def normal(key: tuple, shape=(), offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, drawn ``WINDOW``
    elements at a time."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    flat = out.view(-1)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    for a in range(0, flat.numel(), WINDOW):
        b = min(a + WINDOW, flat.numel())
        u = uniform(key, (b - a,), lo, 1.0, offset + a, device)
        flat[a:b] = _SQRT2 * erfinv(u)
    return out
