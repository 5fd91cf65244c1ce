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

``normal`` is the per-leaf draw of the DP noise and the admin masks: on a
CUDA device one launch of the ``normal`` kernel (``kernels/prng``), any
length; on the CPU its plain version (``kernels/prng/ref.py``, which also
holds the plain ``bits`` and the ``uniform`` and ``erfinv`` it is made
of), a window at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prng import ops as prng_ops
from repro_torch.kernels.prng import ref
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


def bits(key: tuple, shape=(), offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    ``[0, 2**32)``, counted from ``offset`` (plain torch on any device: the
    integer-ring masks' draw)."""
    return ref.bits(key, shape, offset, device)


def normal(key: tuple, shape=(), offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` counted from ``offset``:
    one ``normal`` launch on a CUDA device, the plain version elsewhere."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return prng_ops.normal(key, offset, out)
