"""Threefry-2x32 counter-based PRNG and Box-Muller normals in plain torch.

Port of ``repro/kernels/zsmask/threefry.py``, the one generator every DP
stream of the system draws through. The CUDA kernels inline the same
functions from ``kernels/csrc/threefry.cuh``; this module is their plain
version, and it gives the JAX package's bits exactly.

torch on the CPU has no uint32 ``+``, ``<<`` or ``>>``, so the words are held
in int64 tensors and masked to 32 bits after every add and rotate (values
stay in ``[0, 2**32)``). The float part keeps the JAX association operation
for operation: each multiply and add is a separate op, so nothing contracts
into a fused multiply-add.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# one turn of cos / sin as polynomials in t = (2u - 1)^2, as in the JAX
# package (deterministic bits, no libm trig)
COS_COEF = (1.000000000e+00, -4.934802055e+00, 4.058712006e+00,
            -1.335262775e+00, 2.353304178e-01, -2.580626495e-02,
            1.928504556e-03, -1.035682435e-04)
SIN_COEF = (3.141592741e+00, -5.167712688e+00, 2.550163984e+00,
            -5.992645025e-01, 8.214584738e-02, -7.370326202e-03,
            4.661239800e-04, -2.173679604e-05)
INV_2_32 = 1.0 / 4294967296.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Keys are ints, counters integer tensors (broadcastable) holding
    values in ``[0, 2**32)``. Returns ``(y0, y1)`` as int64 tensors."""
    k0, k1 = int(k0) & M32, int(k1) & M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0.to(torch.int64) + ks[0]) & M32
    x1 = (x1.to(torch.int64) + ks[1]) & M32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & M32
    return x0, x1


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values -> float32 uniform in (0, 1]."""
    return (bits.to(torch.float32) + 1.0) * INV_2_32


def _poly(t: torch.Tensor, coef) -> torch.Tensor:
    acc = None
    for c in coef[-2::-1]:
        acc = (t * coef[-1] if acc is None else acc * t) + c
    return acc


def cos_turn(u: torch.Tensor) -> torch.Tensor:
    """cos(2*pi*u) for u in [0, 1], polynomial."""
    x = 2.0 * u - 1.0
    return -_poly(x * x, COS_COEF)


def sin_turn(u: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*u) for u in [0, 1], polynomial."""
    x = 2.0 * u - 1.0
    return -(x * _poly(x * x, SIN_COEF))


def _radius(b0: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(uniform01(b0)))


def normal_pair(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """One Box-Muller pair of standard normals per counter pair."""
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    rad = _radius(b0)
    u2 = uniform01(b1)
    return rad * cos_turn(u2), rad * sin_turn(u2)


def normal_z0(k0: int, k1: int, c0: torch.Tensor, c1) -> torch.Tensor:
    """The first normal of :func:`normal_pair` only (the noise streams never
    read the second)."""
    b0, b1 = threefry2x32(k0, k1, c0, torch.as_tensor(c1, device=c0.device))
    return _radius(b0) * cos_turn(uniform01(b1))


def normal_stream(k0: int, k1: int, idx: torch.Tensor, stream: int):
    """Standard normal per element: ``idx`` the counters, ``stream`` the
    second counter word (the silo id)."""
    return normal_z0(k0, k1, idx, int(stream) & M32)
