"""Public flash-attention API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``). Forward only: the
backward (``repro/kernels/flash_attention/blocked.py``) is training work."""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda


def flash_attention(q, k, v, causal: bool = True):
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    if on_cuda(q, k, v):
        return flash_attention_cuda(q, k, v, causal)
    return ref.attention_ref(q, k, v, causal)
