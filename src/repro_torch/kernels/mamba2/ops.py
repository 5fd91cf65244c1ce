"""Public Mamba-2 SSD scan API: the CUDA kernel for CUDA tensors (any S),
the plain chunked version for CPU tensors (``kernels.dispatch.on_cuda``).

JAX's Pallas variant needs ``S % chunk == 0`` and sends other lengths to
jnp (``repro/kernels/mamba2/ops.py:13-20``); here the kernel takes every
length, so no shape reaches the plain version on the card."""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.mamba2 import ref
from repro_torch.kernels.mamba2.mamba2 import ssd_cuda


def ssd_chunked(xh, dt, la, Bc, Cc, h0, chunk: int = 64):
    """xh (B, S, nh, P); dt, la (B, S, nh); Bc, Cc (B, S, N); h0
    (B, nh, P, N), fp32 -> (y (B, S, nh, P), h (B, nh, P, N)). ``chunk`` is
    the plain version's (the kernel walks the tokens one by one)."""
    if on_cuda(xh, dt, la, Bc, Cc, h0):
        return ssd_cuda(xh, dt, la, Bc, Cc, h0)
    return ref.ssd_chunked_ref(xh, dt, la, Bc, Cc, h0, chunk=chunk)
