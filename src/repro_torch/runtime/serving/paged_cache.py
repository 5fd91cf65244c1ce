"""Host-side page-pool bookkeeping for the continuous-batching scheduler.
Port of ``repro/runtime/serving/paged_cache.py``.

The device state is ONE shared pool per layer (``models.attention.
init_paged_pool``, in the model's compute dtype: fp32 or bf16, the draft
pool's too); this class owns the free list, per-page refcounts, the
per-slot block tables and lengths, and the admission-time zeroing. The
leak-freedom contract lives at the ``alloc`` boundary: a slot's *fresh*
pages are zeroed in-kernel (``paged_reset``) before the slot's table row is
published, so no read path ever observes a previous tenant's K/V.

Prefix sharing keeps that contract intact:

* **Per-page refcounts.** A page may sit in several slots' tables at once
  (read-only prompt-prefix pages); ``release`` returns a page to the free
  list only at refcount zero, so a shared page is never recycled (never
  re-zeroed or rewritten) while any reader still maps it.
* **A per-tenant prefix index.** Full prompt pages are keyed by a chained
  SHA-256 over their tokens *with the tenant id in the key*: a request can
  only be handed pages written under its own tenant. The index holds its
  own refcount on each entry, so prompt pages of recently finished
  requests stay shareable until pool pressure evicts them (LRU).

Copy-on-write holds by construction: sharing is page granular, a sharer's
write cursor starts at the shared-page boundary, and every page past it is
a fresh zeroed page.

Speculative decoding adds a parallel *draft* pool (same page ids, tables,
lengths and refcounts; only the K/V tensors differ, sized for the draft
model): admission zeroing and the rejected-tail rollback run on both pools,
so the draft cache keeps every isolation property of the target's.

Each event is one kernel launch for both pools (``paged_ops.pool_zero``):
an admission zeroes its distinct fresh pages, and a speculative tick erases
every slot's rejected tail at once (``rollback_many``). The tables stay in
numpy; the host resolves an event to page ids or pool token indices, which
travel in the launch's parameters, so no event copies anything to the card.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from repro_torch.kernels.paged_attention import ops as paged_ops


class PagePool:
    """Refcounted free-list allocator over a device page pool + per-slot
    block tables, with an optional same-tenant prefix index.

    ``tables`` rows are padded with the slot's own first page, so a short
    request never holds a reserved sentinel page and the table stays
    rectangular (attention masks the padding; zeroing never sees it)."""

    def __init__(self, model, *, n_slots: int, n_pages: int, page_size: int,
                 pages_per_slot: int, draft_model=None,
                 prefix_index: bool = False):
        if model.init_paged_cache is None:
            raise ValueError(
                f"{model.cfg.name} ({model.cfg.family}) has no paged serving "
                f"path; continuous batching needs a transformer-family model")
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages = model.init_paged_cache(n_pages, page_size)
        # draft pool: same page ids, draft-sized K/V. Shared prefix pages are
        # written in both pools by the original request's prefill, so a
        # later sharer finds its draft cache warm too.
        self.draft_pages = (None if draft_model is None else
                            draft_model.init_paged_cache(n_pages, page_size))
        self.free: list[int] = list(range(n_pages - 1, -1, -1))
        self.refcount = np.zeros((n_pages,), np.int32)
        self.tables = np.zeros((n_slots, pages_per_slot), np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self._owned: list[list[int]] = [[] for _ in range(n_slots)]
        self._shared: list[list[int]] = [[] for _ in range(n_slots)]
        # (tenant, chained sha256 of page tokens) -> page id, LRU-ordered.
        # The tenant id in the key IS the cross-tenant barrier.
        self.prefix_index_enabled = prefix_index
        self._prefix_index: OrderedDict[tuple, int] = OrderedDict()
        # slot -> [pages hashed so far, running digest]
        self._reg: dict[int, list] = {}
        # the (k, v) pools every zeroing event covers: target, then draft
        self._kv = [(p["k_pages"], p["v_pages"]) for p in
                    (self.pages, self.draft_pages) if p is not None]

    @property
    def free_pages(self) -> int:
        """Pages on the free list (idle prefix-index pages not counted)."""
        return len(self.free)

    def alloc(self, slot: int, n: int, shared: Sequence[int] = ()) -> bool:
        """Claim ``n`` pages for ``slot``: map the ``shared`` prefix pages
        read-only (refcount bump, NO zeroing) and zero ``n - len(shared)``
        fresh pages in-kernel. False when the pool cannot satisfy the claim
        even after LRU-evicting idle index entries (caller retries).

        ``shared`` must come from ``prefix_lookup`` in the same scheduler
        step, so its entries still hold their index refcount."""
        shared = list(shared)
        fresh_n = n - len(shared)
        if fresh_n < 1:
            raise ValueError("a slot needs at least one writable fresh page")
        if n > self.tables.shape[1]:
            return False
        if fresh_n > len(self.free) and not self._evict(fresh_n):
            return False
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        fresh = [self.free.pop() for _ in range(fresh_n)]
        pages = shared + fresh
        width = self.tables.shape[1]
        row = np.full((width,), pages[0], np.int32)
        row[:n] = pages
        # zero BEFORE publishing the table row, and only the FRESH pages
        # (shared pages carry the prefix K/V the sharer is here for): one
        # launch for both pools, no padding
        paged_ops.pool_zero(self._kv, fresh, "page")
        for p in shared:
            self.refcount[p] += 1
        self.refcount[fresh] = 1
        self.tables[slot] = row
        # the write cursor starts at the shared boundary (the COW rule)
        self.lengths[slot] = len(shared) * self.page_size
        self._owned[slot] = pages
        self._shared[slot] = shared
        return True

    def _evict(self, fresh_n: int) -> bool:
        """LRU-evict idle prefix-index entries (refcount 1 = held only by
        the index) until ``fresh_n`` pages are free. True on success."""
        for _ in range(len(self._prefix_index)):
            if fresh_n <= len(self.free):
                break
            key, page = next(iter(self._prefix_index.items()))
            if self.refcount[page] == 1:
                del self._prefix_index[key]
                self.refcount[page] = 0
                self.free.append(page)
            else:
                self._prefix_index.move_to_end(key)
        return fresh_n <= len(self.free)

    def release(self, slot: int) -> None:
        """Drop the slot's references; pages return to the free list only at
        refcount zero. Freed page *contents* stay on the device until the
        next tenant's admission zeroes them (what the recycling probe
        checks)."""
        for p in self._owned[slot]:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free.append(p)
        self._owned[slot] = []
        self._shared[slot] = []
        self._reg.pop(slot, None)
        self.tables[slot] = 0
        self.lengths[slot] = 0

    def _page_digest(self, digest: bytes, tokens) -> bytes:
        chunk = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return hashlib.sha256(digest + chunk.tobytes()).digest()

    def prefix_lookup(self, tenant: Optional[str], prompt) -> list[int]:
        """Longest run of full prompt pages already cached *for this
        tenant*, in order, capped one page short of both the prompt and the
        table width (the admitted request keeps a fresh page and a prompt
        token to prefill)."""
        if not self.prefix_index_enabled:
            return []
        P = self.page_size
        cap = min((len(prompt) - 1) // P, self.tables.shape[1] - 1)
        digest, hit = b"", []
        for j in range(cap):
            digest = self._page_digest(digest, prompt[j * P:(j + 1) * P])
            page = self._prefix_index.get((tenant, digest))
            if page is None:
                break
            self._prefix_index.move_to_end((tenant, digest))
            hit.append(page)
        return hit

    def register_prefix(self, slot: int, tenant: Optional[str], prompt,
                        n_done: int) -> None:
        """Publish the slot's fully prefilled prompt pages into the tenant's
        prefix index (incremental across chunks). Existing keys are
        refreshed to MRU but never re-pointed."""
        if not self.prefix_index_enabled:
            return
        P = self.page_size
        max_j = min(int(n_done), len(prompt)) // P
        st = self._reg.setdefault(slot, [0, b""])
        while st[0] < max_j:
            j = st[0]
            st[1] = self._page_digest(st[1], prompt[j * P:(j + 1) * P])
            key = (tenant, st[1])
            if key in self._prefix_index:
                self._prefix_index.move_to_end(key)
            else:
                page = self._owned[slot][j]
                self._prefix_index[key] = page
                self.refcount[page] += 1
            st[0] += 1

    def rollback_many(self, ranges) -> None:
        """Zero each ``(slot, start, end)`` range of logical token positions
        in-kernel, in both pools, in ONE launch (the speculative tick's
        rejected tails). A range lies past its slot's shared prefix
        (rejected speculation starts at the verified length, past the
        prompt) and inside the slot's own pages, so a shared page is never
        written; every range is checked before anything is erased. Empty
        ranges (``end <= start``) are skipped."""
        P = self.page_size
        tokens = []
        for slot, start, end in ranges:
            if end <= start:
                continue
            if start < len(self._shared[slot]) * P:
                raise ValueError(f"rollback [{start}, {end}) reaches slot "
                                 f"{slot}'s shared prefix pages")
            if end > len(self._owned[slot]) * P:
                raise ValueError(f"rollback [{start}, {end}) runs past slot "
                                 f"{slot}'s pages")
            tokens += paged_ops.token_indices(self.tables[slot], P, start,
                                              end)
        if tokens:
            paged_ops.pool_zero(self._kv, tokens, "token")

    def rollback(self, slot: int, start: int, end: int) -> None:
        """``rollback_many`` of one range."""
        self.rollback_many(((slot, start, end),))

    def slot_pages(self, slot: int) -> list[int]:
        """Physical page ids currently owned by ``slot`` (tests/probes)."""
        return list(self._owned[slot])

    def slot_shared_pages(self, slot: int) -> list[int]:
        """The read-only shared-prefix subset of ``slot_pages``."""
        return list(self._shared[slot])

    def check_invariants(self) -> None:
        """Every page's refcount equals its slot owners plus its index
        membership; the free list is exactly the refcount-zero pages."""
        expect = np.zeros((self.n_pages,), np.int32)
        for owned in self._owned:
            for p in owned:
                expect[p] += 1
        for p in self._prefix_index.values():
            expect[p] += 1
        if not np.array_equal(self.refcount, expect):
            raise AssertionError((self.refcount.tolist(), expect.tolist()))
        if len(set(self.free)) != len(self.free):
            raise AssertionError("duplicate free pages")
        if sorted(self.free) != sorted(np.flatnonzero(expect == 0).tolist()):
            raise AssertionError("free list != refcount-zero pages")
