"""Public Mamba-2 SSD scan API: the CUDA kernel for CUDA tensors (any S),
the plain chunked version for CPU tensors (``kernels.dispatch.on_cuda``).

JAX's Pallas variant needs ``S % chunk == 0`` and sends other lengths to
jnp (``repro/kernels/mamba2/ops.py:13-20``); here the kernel takes every
length, so no shape reaches the plain version on the card.

Training differentiates the scan through :class:`SSD`: its forward is the
same kernel (or plain version), its backward the hand-written reverse scan
``ssd_bwd`` (or its plain version, ``ref.ssd_backward_ref``). The JAX
package differentiates its jnp chunked form instead; on the card no
gradient comes from autograd of the plain version.

Training in bf16 runs the same fp32 scan: the model widens the bf16
projections to fp32 before it (``repro/models/mamba2.py:86,96-97``, as the JAX
package does), and autograd takes the scan's fp32 gradients back through
each ``.float()`` to bf16, as JAX's ``astype`` does. No bf16 scan kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.mamba2 import ref
from repro_torch.kernels.mamba2.mamba2 import ssd_bwd_cuda, ssd_cuda


def _forward(xh, dt, la, Bc, Cc, h0, chunk):
    if on_cuda(xh, dt, la, Bc, Cc, h0):
        return ssd_cuda(xh, dt, la, Bc, Cc, h0)
    return ref.ssd_chunked_ref(xh, dt, la, Bc, Cc, h0, chunk=chunk)


class SSD(torch.autograd.Function):
    """``(y, h) = ssd(xh, dt, la, Bc, Cc, h0)`` with a hand-written
    backward. Saves only the inputs: the backward recomputes the states."""

    @staticmethod
    def forward(ctx, xh, dt, la, Bc, Cc, h0, chunk: int = 64):
        ctx.save_for_backward(xh, dt, la, Bc, Cc, h0)
        return _forward(xh, dt, la, Bc, Cc, h0, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        xh, dt, la, Bc, Cc, h0 = ctx.saved_tensors
        # autograd may hand the output gradients over strided
        dy = dy.contiguous()
        dh = dh.contiguous()
        if on_cuda(xh, dt, la, Bc, Cc, h0, dy, dh):
            grads = ssd_bwd_cuda(xh, dt, la, Bc, Cc, h0, dy, dh)
        else:
            grads = ref.ssd_backward_ref(xh, dt, la, Bc, Cc, h0, dy, dh)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (None,)


def ssd_chunked(xh, dt, la, Bc, Cc, h0, chunk: int = 64):
    """xh (B, S, nh, P); dt, la (B, S, nh); Bc, Cc (B, S, N); h0
    (B, nh, P, N), fp32 -> (y (B, S, nh, P), h (B, nh, P, N)). ``chunk`` is
    the plain version's (the kernel walks the tokens one by one). With grad
    mode on and an input that requires grad, the call goes through
    :class:`SSD`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, la, Bc, Cc, h0)):
        return SSD.apply(xh, dt, la, Bc, Cc, h0, chunk)
    return _forward(xh, dt, la, Bc, Cc, h0, chunk)
