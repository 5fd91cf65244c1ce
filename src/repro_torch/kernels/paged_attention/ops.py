"""Public paged-attention API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``).

* ``paged_attention`` — the block-table read path of every serving step.
* ``pool_zero`` — zeroes a list of pages (an admission's fresh pages: the
  leak-freedom half of the isolation contract) or of pool tokens (a
  speculative tick's rejected tails) in every layer of one or two stacked
  pools, in place: the page pool's one launch an event.
* ``paged_reset`` / ``paged_rollback`` — the TPU kernels' own signatures
  (one table row, one pool, one range), held to them on the CPU; on the
  card a batch of one of ``pool_zero`` (the row comes to the host first, a
  copy that waits for the stream: ``PagePool`` keeps its rows on the host
  and calls ``pool_zero`` itself).
* ``token_indices`` — the host's resolution of a row's logical positions
  to pool token indices, for ``pool_zero``.
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_cuda, pool_zero_cuda)


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
    (L, N, P, H, D) pools, in place; on the card one launch of
    ``pool_zero`` for the row's distinct ids."""
    if on_cuda(k_pages, v_pages, row):
        pool_zero_cuda(((k_pages, v_pages),), row.tolist(), "page")
    else:
        ref.paged_reset_ref(k_pages, v_pages, row)


def paged_rollback(k_pages, v_pages, row, start: int, end: int) -> None:
    """Zero logical token positions ``[start, end)`` (host ints) of
    block-table row ``row`` (nP,) int32 across the stacked (L, N, P, H, D)
    pools, in place; a no-op when ``end <= start``.

    On the card the row's dead positions are resolved on the host to
    distinct pool tokens (``token_indices``), one launch of ``pool_zero``.
    As in the JAX package, the plain version gets the row sliced to the
    pages that overlap the range and the bounds made relative to the slice
    (a table row pads with duplicate page ids, which the TPU kernel,
    rewriting whole pages, must not visit twice); both zero the same
    lanes."""
    start, end = int(start), int(end)
    if end <= start:
        return
    if on_cuda(k_pages, v_pages, row):
        tokens = token_indices(row.tolist(), k_pages.shape[2], start, end)
        pool_zero_cuda(((k_pages, v_pages),), tokens, "token")
        return
    P = k_pages.shape[2]
    sp, ep = start // P, -(-end // P)
    ref.paged_rollback_ref(k_pages, v_pages, row[sp:ep], start - sp * P,
                           end - sp * P)


def pool_zero(pools, idx, slab: str) -> None:
    """Zero the slabs ``idx`` (host ints; repeats are dropped, indices
    outside the pool skipped) in every layer of one or two stacked pools,
    in place: ``pools`` is a sequence of ``(k_pages, v_pages)`` pairs of
    (L, N, P, H, D) sharing N, P, H and D (the target's pool and the early
    exit draft's). ``slab`` ``"page"``: page ids (the reset); ``"token"``:
    pool token indices ``page*P + t`` (the rollback, from
    ``token_indices``). One launch on the card for every 256 indices."""
    if on_cuda(*(t for kv in pools for t in kv)):
        pool_zero_cuda(pools, idx, slab)
    else:
        ref.pool_zero_ref(pools, idx, slab)


def token_indices(row, page_size: int, start: int, end: int) -> list:
    """The pool token indices ``page*P + t`` of logical positions
    ``[start, end)`` of block-table row ``row`` (host ints): page ``j`` of
    the row holds positions ``j*P .. j*P+P-1``, and positions outside
    ``[0, len(row)*P)`` name no page and are left out, as the TPU grid
    never visits them."""
    P = page_size
    lo, hi = max(int(start), 0), min(int(end), len(row) * P)
    if hi <= lo:
        return []
    first = lo // P
    pages = list(map(int, row[first:(hi - 1) // P + 1]))
    return [pages[p // P - first] * P + p % P for p in range(lo, hi)]
