"""Public flash-attention API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``). Forward only: the
backward (``repro/kernels/flash_attention/blocked.py``) is not ported, so a
call that would need one raises on either device rather than return an
output the kernel's gradient cannot reach."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda


def flash_attention(q, k, v, causal: bool = True):
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward in the port yet (training "
            "through flash: ROADMAP.md queue 1 item 12 part 4c, on queue 2 "
            "item E); the training path attends with models.attention._sdpa")
    if on_cuda(q, k, v):
        return flash_attention_cuda(q, k, v, causal)
    return ref.attention_ref(q, k, v, causal)
