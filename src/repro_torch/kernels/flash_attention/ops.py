"""Public flash-attention API: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors (``kernels.dispatch.on_cuda``).

Serving calls the forward kernel without its log-sum-exp store (one
tensor-core kernel a dtype serves and trains). Training differentiates it
through :class:`FlashAttention`, the port of JAX's custom VJP
``flash_attention_xla`` (``repro/kernels/flash_attention/blocked.py:46-143``):
its forward is the same kernel writing the log-sum-exp too, and its
backward the hand-written ``flash_attention_bwd`` (or,
on CPU tensors, their plain versions ``ref.flash_forward_ref`` and
``ref.flash_backward_ref``). Autograd never sees inside the kernels, so on
the card no gradient comes from autograd of a plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_cuda,
    flash_attention_fwd_lse_cuda)


class FlashAttention(torch.autograd.Function):
    """``out = flash_attention(q, k, v, causal)`` with a hand-written
    backward. Saves q, k, v, the rounded ``out`` and the fp32 ``lse``, as
    ``_fwd_vjp`` keeps them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        if on_cuda(q, k, v):
            out, lse = flash_attention_fwd_lse_cuda(q, k, v, causal)
        else:
            out, lse = ref.flash_forward_ref(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()  # autograd may hand it over strided
        if on_cuda(q, k, v, out, lse, dout):
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                             ctx.causal)
        else:
            grads = ref.flash_backward_ref(q, k, v, out, lse, dout,
                                           ctx.causal)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (None,)


def flash_attention(q, k, v, causal: bool = True):
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D). With grad
    mode on and an input that requires grad, the call goes through
    :class:`FlashAttention`; otherwise (serving, under ``inference_mode``)
    it is the serving forward, with its own counts."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if on_cuda(q, k, v):
        return flash_attention_cuda(q, k, v, causal)
    return ref.attention_ref(q, k, v, causal)
