"""Public paged-attention API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``).

* ``paged_attention`` — the block-table read path of every serving step.
* ``paged_reset`` — zeroes a slot's fresh pages on admission, in place (the
  leak-freedom half of the isolation contract).
* ``paged_rollback`` — zeroes a range of a slot's logical positions, in
  place (the speculative rejected-tail eraser).
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_cuda, paged_reset_cuda, paged_rollback_cuda)


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


def paged_rollback(k_pages, v_pages, row, start: int, end: int) -> None:
    """Zero logical token positions ``[start, end)`` (host ints) of
    block-table row ``row`` (nP,) int32 across the stacked (L, N, P, H, D)
    pools, in place; a no-op when ``end <= start``.

    The CUDA kernel writes only the dead positions, so it takes the whole
    row. As in the JAX package, the plain version gets the row sliced to
    the pages that overlap the range and the bounds made relative to the
    slice (a table row pads with duplicate page ids, which the TPU kernel,
    rewriting whole pages, must not visit twice); both zero the same
    lanes."""
    start, end = int(start), int(end)
    if end <= start:
        return
    if on_cuda(k_pages, v_pages, row):
        paged_rollback_cuda(k_pages, v_pages, row, start, end)
        return
    P = k_pages.shape[2]
    sp, ep = start // P, -(-end // P)
    ref.paged_rollback_ref(k_pages, v_pages, row[sp:ep], start - sp * P,
                           end - sp * P)
