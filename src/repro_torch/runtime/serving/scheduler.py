"""Continuous-batching scheduler over the slot-recycled paged KV cache.
Port of ``repro/runtime/serving/scheduler.py``.

Instead of draining a whole same-length wave, the scheduler revisits
admission at every step: a finished request's slot is released at once, its
pages go back to the free list, and the next queued request is admitted into
the recycled slot with its pages zeroed in-kernel (``PagePool.alloc``).
Prefill is chunked into the decode loop: an admitted request advances one
``prefill_chunk`` of its prompt per step while other slots keep decoding.

Admission is weighted deficit-round-robin over per-tenant FIFO subqueues,
with an optional per-tenant slot cap, priority preemption under page-pool
pressure (the victim restores by recompute, token-identical under greedy
decode), and optional same-tenant prefix sharing (``paged_cache``).
Speculative decoding needs the rollback kernel and is not ported yet.

Token-for-token equality with the wave baseline (greedy argmax over the same
model) is a test invariant.
"""
from __future__ import annotations

import collections
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.server import Request, ServerStats
from repro_torch.runtime.serving.paged_cache import PagePool


@dataclass
class _Slot:
    req: Request
    pos: int = 0                    # prompt tokens prefilled so far
    pending: Optional[int] = None   # next decode input (set at prefill end)
    seq: int = 0                    # original submit order (for re-queue)
    # effective prompt: the submitted prompt plus any tokens generated
    # before a preemption (restoring an evicted request is prefilling this)
    prompt: Optional[np.ndarray] = None


def _bucket_pages(tokens_needed: int, page_size: int, cap: int) -> int:
    """Pages for ``tokens_needed``, rounded up to a power of two (so freed
    allocations are exchangeable between differently sized requests)."""
    need = -(-tokens_needed // page_size)
    b = 1
    while b < need:
        b *= 2
    return min(b, cap)


class ContinuousServer:
    """Same submit/run surface as ``WaveServer``; continuous batching over a
    paged, slot-recycled KV cache."""

    def __init__(self, model, params, *, max_batch: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 prefill_chunk: int = 16, n_pages: Optional[int] = None,
                 trace_logits: bool = False,
                 max_slots_per_tenant: Optional[int] = None,
                 tenant_weights: Optional[dict] = None,
                 prefix_sharing: bool = False, speculative: bool = False):
        if speculative:
            raise NotImplementedError(
                "speculative decoding needs the paged_rollback kernel, which "
                "is not ported yet (ROADMAP.md queue 1, serving item)")
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = max_batch
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        per_slot = -(-max_len // page_size)
        self.pool = PagePool(model, n_slots=max_batch,
                             n_pages=n_pages or max_batch * per_slot,
                             page_size=page_size, pages_per_slot=per_slot,
                             prefix_index=prefix_sharing)
        self.slots: list[Optional[_Slot]] = [None] * max_batch
        # per-tenant admission cap: one tenant's burst cannot monopolize the
        # batch (and the page pool); tenant=None is exempt
        self.max_slots_per_tenant = max_slots_per_tenant
        self.tenant_weights = dict(tenant_weights or {})
        self.queues: dict[Optional[str], collections.deque] = {}
        self._deficit: dict[Optional[str], float] = {}
        self._seq = 0
        self.queued = 0
        self.stats = ServerStats()
        self.clock = 0  # scheduler steps; the latency currency
        # rid -> [logits row per generated token]; the leak-freedom probe
        # asserts these are BIT-equal between a recycled-slot run and a
        # fresh-cache run
        self.trace_logits = trace_logits
        self.logit_trace: dict[int, list[np.ndarray]] = {}

    # ------------------------------------------------------------------ queue
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid} exceeds max_len {self.max_len}")
        req.submit_step = self.clock
        self.queues.setdefault(req.tenant, collections.deque()).append(
            (self._seq, req))
        self._seq += 1
        self.queued += 1

    # ------------------------------------------------------------- lifecycle
    def _tenant_slots(self, tenant: str) -> int:
        return sum(1 for s in self.slots
                   if s is not None and s.req.tenant == tenant)

    def _tenant_ok(self, tenant: Optional[str]) -> bool:
        return (self.max_slots_per_tenant is None or tenant is None
                or self._tenant_slots(tenant) < self.max_slots_per_tenant)

    def _weight(self, tenant: Optional[str]) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    def _admit(self) -> None:
        """Weighted deficit-round-robin over per-tenant subqueues, one pick
        per free slot. Each admission pays the picked tenant one credit and
        mints one credit in total across the tenants still waiting, in
        proportion to their weights."""
        for i in range(self.n_slots):
            if self.queued == 0:
                return
            if self.slots[i] is not None:
                continue
            eligible = [t for t, q in self.queues.items()
                        if q and self._tenant_ok(t)]
            if not eligible:
                return  # every backlogged tenant capped
            t_star = max(eligible, key=lambda t: (self._deficit.get(t, 0.0),
                                                  -self.queues[t][0][0]))
            # pop BEFORE the allocation attempt: preemption may re-queue a
            # same-tenant victim at the front of this very subqueue
            seq, req = self.queues[t_star].popleft()
            self.queued -= 1
            eff = req.prompt if not req.generated else np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.generated, np.int32)])
            shared = (self.pool.prefix_lookup(req.tenant, eff)
                      if self.prefix_sharing else [])
            need = _bucket_pages(len(req.prompt) + req.max_new_tokens,
                                 self.pool.page_size,
                                 self.pool.tables.shape[1])
            if not self.pool.alloc(i, need, shared=shared):
                if not self._preempt_for(req, i, need, shared):
                    self.queues[t_star].appendleft((seq, req))
                    self.queued += 1
                    return
            backlogged = [t for t, q in self.queues.items() if q]
            if backlogged:
                W = sum(self._weight(t) for t in backlogged)
                for t in backlogged:
                    self._deficit[t] = (self._deficit.get(t, 0.0)
                                        + self._weight(t) / W)
            self._deficit[t_star] = self._deficit.get(t_star, 0.0) - 1.0
            if not self.queues[t_star]:
                del self.queues[t_star]
                self._deficit.pop(t_star, None)
            S0 = len(shared) * self.pool.page_size
            self.stats.shared_prompt_tokens += S0
            self.slots[i] = _Slot(req, pos=S0, seq=seq,
                                  prompt=np.asarray(eff, np.int32))

    def _preempt_for(self, req: Request, i: int, need: int,
                     shared: list) -> bool:
        """Evict running slots of STRICTLY lower priority (cheapest
        recompute first) until the allocation for slot ``i`` fits. Victims
        go back to the front of their tenant's subqueue under their original
        seq and restore by recompute of prompt + generated."""
        while True:
            victims = [j for j, s in enumerate(self.slots)
                       if s is not None and s.req.priority < req.priority]
            if not victims:
                return False
            j = min(victims, key=lambda j: (self.slots[j].req.priority,
                                            len(self.slots[j].req.generated)))
            s = self.slots[j]
            self.pool.release(j)
            self.slots[j] = None
            self.queues.setdefault(s.req.tenant,
                                   collections.deque()).appendleft(
                (s.seq, s.req))
            self.queued += 1
            self.stats.preemptions += 1
            if self.pool.alloc(i, need, shared=shared):
                return True

    def _finish(self, i: int, req: Request) -> None:
        req.done = True
        req.finish_step = self.clock
        self.stats.latencies.append(req.finish_step - req.submit_step)
        self.pool.release(i)
        self.slots[i] = None

    def _append(self, i: int, tok: int) -> bool:
        """Record a generated token; True when the request just finished."""
        req = self.slots[i].req
        req.generated.append(tok)
        self.stats.useful_tokens += 1
        if len(req.generated) >= req.max_new_tokens or \
                (req.eos_id is not None and tok == req.eos_id):
            self._finish(i, req)
            return True
        return False

    # ------------------------------------------------------------------ step
    def _paged_step(self, tokens: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
        """One ``paged_step`` of the model over every slot (pools updated in
        place); returns the (n_slots, V) last-token logits on the host."""
        dev = self.device
        logits, _ = self.model.paged_step(
            self.params, torch.as_tensor(tokens, dtype=torch.long, device=dev),
            self.pool.pages, torch.as_tensor(self.pool.tables, device=dev),
            torch.as_tensor(self.pool.lengths, device=dev),
            torch.as_tensor(n_valid, device=dev))
        return logits.float().cpu().numpy()

    def _run_prefill_chunks(self) -> None:
        C = self.prefill_chunk
        idx = [i for i, s in enumerate(self.slots)
               if s is not None and s.pos < len(s.prompt)]
        if not idx:
            return
        tokens = np.zeros((self.n_slots, C), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        for i in idx:
            s = self.slots[i]
            chunk = s.prompt[s.pos:s.pos + C]
            tokens[i, :len(chunk)] = chunk
            n_valid[i] = len(chunk)
        logits = self._paged_step(tokens, n_valid)
        for i in idx:
            s = self.slots[i]
            s.pos += int(n_valid[i])
            self.pool.lengths[i] += int(n_valid[i])
            if self.prefix_sharing:
                self.pool.register_prefix(i, s.req.tenant, s.prompt, s.pos)
            if s.pos == len(s.prompt):
                # prefill done: the chunk's last-valid logits give the first
                # generated token (same source as the wave's prefill logits)
                if self.trace_logits:
                    self.logit_trace.setdefault(s.req.rid, []).append(
                        logits[i].copy())
                tok = int(np.argmax(logits[i]))
                if not self._append(i, tok):
                    s.pending = tok

    def _run_decode(self) -> None:
        idx = [i for i, s in enumerate(self.slots)
               if s is not None and s.pending is not None]
        if not idx:
            return
        tokens = np.zeros((self.n_slots, 1), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        for i in idx:
            tokens[i, 0] = self.slots[i].pending
            n_valid[i] = 1
        logits = self._paged_step(tokens, n_valid)
        for i in idx:
            self.pool.lengths[i] += 1
            if self.trace_logits:
                self.logit_trace.setdefault(self.slots[i].req.rid, []).append(
                    logits[i].copy())
            tok = int(np.argmax(logits[i]))
            if not self._append(i, tok):
                self.slots[i].pending = tok

    def step(self) -> None:
        """One scheduler tick: admit into free slots, decode every ready
        slot, advance every mid-prefill slot by one chunk (so a slot that
        completes prefill starts decoding next tick). A tick that harvests
        tokens is charged a full batch of slots, as in the wave loop."""
        self.clock += 1
        before = self.stats.useful_tokens
        with torch.inference_mode():
            self._admit()
            self._run_decode()
            self._run_prefill_chunks()
        if self.stats.useful_tokens > before:
            self.stats.decode_steps += 1
            self.stats.slot_tokens += self.n_slots

    def run_until_drained(self, max_steps: int = 100_000) -> ServerStats:
        while (self.queued or any(s is not None for s in self.slots)) \
                and self.clock < max_steps:
            self.step()
        leftover = self.queued + sum(s is not None for s in self.slots)
        self.stats.drained = leftover == 0
        if leftover:
            warnings.warn(
                f"run_until_drained stopped at max_steps={max_steps} with "
                f"{leftover} requests still in flight — stats cover a "
                f"truncated trace", RuntimeWarning, stacklevel=2)
        return self.stats
