"""Kernel routing for the port: a minimal twin of ``repro.kernels.dispatch``.

The JAX registry chooses among several implementations per kernel, with
capability fallbacks. The port has exactly two per kernel and the choice is
the tensors' device, nothing else:

* every tensor on a CUDA device -> the hand-written CUDA kernel. A shape,
  dtype or layout the kernel does not take raises; there is no fallback to
  the plain version on CUDA.
* every tensor on the CPU -> the kernel's plain PyTorch version.
* anything else (mixed devices, another backend) raises.

Each kernel is a :class:`Kernel` record holding its launch counter: the
CUDA wrapper adds one where it launches, and nowhere else, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Kernel:
    """One hand-written CUDA kernel of the port."""

    name: str
    source: str    # the .cu file, relative to the repository root
    replaces: str  # the TPU kernel it ports, file:line in src/repro
    launches: int = 0


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    if name in KERNELS:
        raise ValueError(f"kernel {name!r} registered twice")
    KERNELS[name] = Kernel(name, source, replaces)
    return KERNELS[name]


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every tensor
    is on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on cuda or all on cpu, "
                     f"got {sorted(kinds)}")


# head dims the attention kernels are instantiated for (csrc/*.cu)
HEAD_DIMS = (16, 32, 64, 128)


def require(cond: bool, what: str) -> None:
    """A wrapper's check of what its kernel takes: raises ``ValueError``."""
    if not cond:
        raise ValueError(what)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Device, dtype, rank and contiguity of one kernel argument."""
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    require(t.dim() == ndim, f"{name}: {t.dim()}-d, expected {ndim}-d")
    require(t.is_contiguous(), f"{name}: must be contiguous")
