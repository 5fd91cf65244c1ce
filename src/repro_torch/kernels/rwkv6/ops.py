"""Public RWKV-6 WKV scan API: the CUDA kernel for CUDA tensors (any S),
the plain chunked version for CPU tensors (``kernels.dispatch.on_cuda``).

JAX's Pallas variant needs ``S % chunk == 0`` and sends other lengths to
jnp (``repro/kernels/rwkv6/ops.py:18-24``); here the kernel takes every
length, so no shape reaches the plain version on the card.

Training differentiates the scan through :class:`WKV`: its forward is the
same kernel (or plain version), its backward the hand-written reverse scan
``wkv_bwd`` (or its plain version, ``ref.wkv_backward_ref``). The JAX
package has no backward of its own here: it differentiates its jnp chunked
forms. Autograd never sees inside the kernel, so on the card no gradient
comes from autograd of the plain version.

Training in bf16 runs the same fp32 scan: the model widens the bf16
projections to fp32 before it (``repro/models/rwkv6.py:100-104``, as the JAX
package does), and autograd takes the scan's fp32 gradients back through
each ``.float()`` to bf16, as JAX's ``astype`` does. No bf16 scan kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.rwkv6 import wkv_bwd_cuda, wkv_cuda


def _forward(r, k, v, w, u, state0, chunk):
    if on_cuda(r, k, v, w, u, state0):
        return wkv_cuda(r, k, v, w, u, state0)
    return ref.wkv_chunked_ref(r, k, v, w, u, state0, chunk=chunk)


class WKV(torch.autograd.Function):
    """``(o, state) = wkv(r, k, v, w, u, state0)`` with a hand-written
    backward. Saves only the inputs: the backward recomputes the states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, chunk: int = 32):
        ctx.save_for_backward(r, k, v, w, u, state0)
        return _forward(r, k, v, w, u, state0, chunk)

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        # autograd may hand the output gradients over strided
        do = do.contiguous()
        dstate = dstate.contiguous()
        if on_cuda(r, k, v, w, u, state0, do, dstate):
            grads = wkv_bwd_cuda(r, k, v, w, u, state0, do, dstate)
        else:
            grads = ref.wkv_backward_ref(r, k, v, w, u, state0, do, dstate)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (None,)


def wkv_chunked(r, k, v, w, u, state0, chunk: int = 32):
    """r, k, v, w (B, S, H, N) fp32; u (H, N); state0 (B, H, N, N) ->
    (o (B, S, H, N), state (B, H, N, N)). ``chunk`` is the plain version's
    (the kernel walks the tokens one by one). With grad mode on and an
    input that requires grad, the call goes through :class:`WKV`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state0)):
        return WKV.apply(r, k, v, w, u, state0, chunk)
    return _forward(r, k, v, w, u, state0, chunk)
