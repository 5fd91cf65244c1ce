"""Public paged-attention API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``).

* ``paged_attention`` — the block-table read path of every serving step.
* ``paged_reset`` — zeroes a slot's fresh pages on admission, in place (the
  leak-freedom half of the isolation contract).
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_cuda, paged_reset_cuda)


def paged_attention(q, k_pages, v_pages, tables, q_start):
    """Attention for C new tokens per slot against the slot's paged KV.

    q (B, C, Hq, D); k_pages/v_pages (N, P, Hkv, D); tables (B, nP) int32;
    q_start (B,) int32 tokens already cached (row c reads positions
    ``<= q_start + c``). Returns fp32 (B, C, Hq, D)."""
    if on_cuda(q, k_pages, v_pages, tables, q_start):
        return paged_attention_cuda(q, k_pages, v_pages, tables, q_start)
    return ref.paged_attention_ref(q, k_pages, v_pages, tables, q_start)


def paged_reset(k_pages, v_pages, row) -> None:
    """Zero the pages named in ``row`` (nP,) int32 across the stacked
    (L, N, P, H, D) pools, in place."""
    if on_cuda(k_pages, v_pages, row):
        paged_reset_cuda(k_pages, v_pages, row)
    else:
        ref.paged_reset_ref(k_pages, v_pages, row)
