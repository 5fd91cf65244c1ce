"""The slice of ``jax.random`` the training path uses, bit for bit.

JAX (with ``jax_threefry_partitionable``, the default of the reference's
jax) derives every key with threefry2x32 on counters ``(hi, lo)``. Keys here
are ``(k0, k1)`` tuples of ints, the two uint32 words of JAX's raw key data:

* ``PRNGKey(seed) = (seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* ``split(k, n)[i] = threefry2x32(k, (0, i))``;
* ``normal(k)``: bits ``y0 ^ y1`` of ``threefry2x32(k, (0, 0))``, the
  mantissa trick to ``[1, 2) - 1``, scaled to ``[nextafter(-1, 0), 1)``,
  then ``sqrt(2) * erfinv``. The bits are exact; ``erfinv`` is libm's, so
  the normal agrees with JAX's to a tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.zsmask.threefry import M32, threefry2x32


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


def normal(key: tuple) -> float:
    """``jax.random.normal(key, (), float32)`` as a Python float (its value
    is a float32)."""
    y0, y1 = _words(key, [0], [0])[0]
    bits = np.uint32(((y0 ^ y1) >> 9) | 0x3F800000)
    floats = torch.tensor(bits.view(np.float32)) - torch.tensor(1.0)
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    hi = torch.tensor(1.0)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    return float(torch.tensor(np.float32(np.sqrt(2))) * torch.erfinv(u))
