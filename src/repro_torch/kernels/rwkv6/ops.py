"""Public RWKV-6 WKV scan API: the CUDA kernel for CUDA tensors (any S),
the plain chunked version for CPU tensors (``kernels.dispatch.on_cuda``).

JAX's Pallas variant needs ``S % chunk == 0`` and sends other lengths to
jnp (``repro/kernels/rwkv6/ops.py:18-24``); here the kernel takes every
length, so no shape reaches the plain version on the card."""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.rwkv6 import wkv_cuda


def wkv_chunked(r, k, v, w, u, state0, chunk: int = 32):
    """r, k, v, w (B, S, H, N) fp32; u (H, N); state0 (B, H, N, N) ->
    (o (B, S, H, N), state (B, H, N, N)). ``chunk`` is the plain version's
    (the kernel walks the tokens one by one)."""
    if on_cuda(r, k, v, w, u, state0):
        return wkv_cuda(r, k, v, w, u, state0)
    return ref.wkv_chunked_ref(r, k, v, w, u, state0, chunk=chunk)
