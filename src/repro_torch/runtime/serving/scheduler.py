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

Speculative decoding (``speculative=True``): a draft model, the first
``draft_layers`` layers of the target sharing its embedding, final norm and
head, proposes ``spec_k - 1`` tokens per tick from a parallel draft pool
(same page ids, same tables); the target verifies them in ONE chunk-shaped
``paged_step`` (``logits_mode="all"``); the longest matching prefix is
accepted greedily, and every slot's rejected tail is erased in-kernel from
both pools by one launch (``PagePool.rollback_many``) before the next tick.

Token-for-token equality with the wave baseline (greedy argmax over the same
model), and of the speculative with the plain scheduler, are test
invariants.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.models.registry import build_model
from repro_torch.models.transformer import early_exit
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


def _draft_of(model, params, draft_layers: Optional[int]):
    """The draft (model, params): the first ``draft_layers`` layers of the
    target with its embedding, final norm and head, as tensors of the
    target's (``models.transformer.early_exit``). ``None`` or ``n_layers``
    is the self-draft: the draft IS the target."""
    cfg = model.cfg
    Ld = cfg.n_layers if draft_layers is None else int(draft_layers)
    if not 1 <= Ld <= cfg.n_layers:
        raise ValueError(f"draft_layers={draft_layers} out of range for a "
                         f"{cfg.n_layers}-layer target")
    draft_model = build_model(dataclasses.replace(cfg, n_layers=Ld),
                              model.device, compute_dtype=model.compute_dtype)
    if Ld == cfg.n_layers:
        return draft_model, params
    return draft_model, early_exit(params, Ld)


class ContinuousServer:
    """Same submit/run surface as ``WaveServer``; continuous batching over a
    paged, slot-recycled KV cache, with optional same-tenant prefix sharing
    and speculative decoding."""

    def __init__(self, model, params, *, max_batch: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 prefill_chunk: int = 16, n_pages: Optional[int] = None,
                 trace_logits: bool = False,
                 max_slots_per_tenant: Optional[int] = None,
                 tenant_weights: Optional[dict] = None,
                 prefix_sharing: bool = False, speculative: bool = False,
                 spec_k: int = 4, draft_layers: Optional[int] = None):
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = max_batch
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.speculative = speculative
        self.spec_k = spec_k
        self.draft_model = self.draft_params = None
        if speculative:
            if spec_k < 2:
                raise ValueError("spec_k must be >= 2 (k=1 is plain decode)")
            self.draft_model, self.draft_params = _draft_of(model, params,
                                                            draft_layers)
        per_slot = -(-max_len // page_size)
        self.pool = PagePool(model, n_slots=max_batch,
                             n_pages=n_pages or max_batch * per_slot,
                             page_size=page_size, pages_per_slot=per_slot,
                             draft_model=self.draft_model,
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
    def _paged_step(self, tokens: np.ndarray, n_valid: np.ndarray,
                    draft: bool = False, q_start: Optional[np.ndarray] = None,
                    logits_mode: str = "last") -> torch.Tensor:
        """One ``paged_step`` over every slot, of the target or the draft
        (its pool updated in place), from ``q_start`` (default: the slots'
        lengths); returns the logits on the device."""
        dev = self.device
        model, params, pages = ((self.draft_model, self.draft_params,
                                 self.pool.draft_pages) if draft else
                                (self.model, self.params, self.pool.pages))
        q_start = self.pool.lengths if q_start is None else q_start
        logits, _ = model.paged_step(
            params, torch.as_tensor(tokens, dtype=torch.long, device=dev),
            pages, torch.as_tensor(self.pool.tables, device=dev),
            torch.as_tensor(q_start, device=dev),
            torch.as_tensor(n_valid, device=dev), logits_mode=logits_mode)
        return logits

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
        if self.speculative:
            # the draft pool in lockstep: the same tokens into the draft pool,
            # logits dropped (so a later sharer's draft cache is warm over
            # shared prefix pages too)
            self._paged_step(tokens, n_valid, draft=True)
        logits = self._paged_step(tokens, n_valid).float().cpu().numpy()
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
        logits = self._paged_step(tokens, n_valid).float().cpu().numpy()
        for i in idx:
            self.pool.lengths[i] += 1
            if self.trace_logits:
                self.logit_trace.setdefault(self.slots[i].req.rid, []).append(
                    logits[i].copy())
            tok = int(np.argmax(logits[i]))
            if not self._append(i, tok):
                self.slots[i].pending = tok

    def _propose(self, t0: np.ndarray, k_eff: np.ndarray) -> np.ndarray:
        """The draft's greedy proposals (n_slots, max(k_eff) - 1): one draft
        decode step per column from positions ``lengths + j``, each step's
        argmax fed to the next on the device, copied to the host once (the
        JAX package scans the steps in one device call). Slot i writes
        draft-pool positions ``lengths[i] .. lengths[i] + k_eff[i] - 2``;
        its columns from ``k_eff[i] - 1`` on are junk."""
        dev = self.device
        steps = int(k_eff.max()) - 1
        tables = torch.as_tensor(self.pool.tables, device=dev)
        base = torch.as_tensor(self.pool.lengths, device=dev)
        n_valid = torch.as_tensor(
            (np.arange(steps)[:, None] < k_eff[None, :] - 1).astype(np.int32),
            device=dev)
        cur = torch.as_tensor(t0, dtype=torch.long, device=dev)
        props = []
        for j in range(steps):
            logits, _ = self.draft_model.paged_step(
                self.draft_params, cur[:, None], self.pool.draft_pages,
                tables, base + j, n_valid[j])
            cur = logits.argmax(-1)
            props.append(cur)
        if not props:
            return np.zeros((self.n_slots, 0), np.int64)
        return torch.stack(props, 1).cpu().numpy()

    def _run_spec_decode(self) -> None:
        """One speculative tick for every decode-ready slot: ``k_eff - 1``
        draft proposals, one chunk-shaped verify, greedy accept, in-kernel
        rollback of every slot's rejected tail in both pools (one launch).

        ``k_eff = min(spec_k, remaining budget)`` per slot: the bucketed
        allocation covers prompt + max_new tokens, so speculating past the
        budget would write K/V past the slot's pages. As in the JAX package,
        a tick that accepts every proposal leaves the draft pool without
        the K/V of position ``base + k_eff - 1`` (the draft never ran that
        token), so the draft attends to a zero key there for the rest of the
        request: fewer acceptances, the same tokens."""
        k = self.spec_k
        idx = [i for i, s in enumerate(self.slots)
               if s is not None and s.pending is not None]
        if not idx:
            return
        base = self.pool.lengths.copy()
        t0 = np.zeros((self.n_slots,), np.int32)
        k_eff = np.zeros((self.n_slots,), np.int32)
        for i in idx:
            req = self.slots[i].req
            t0[i] = self.slots[i].pending
            k_eff[i] = min(k, req.max_new_tokens - len(req.generated))
        drafted = self._propose(t0, k_eff)
        tokens = np.zeros((self.n_slots, k), np.int32)
        props = {}
        for i in idx:
            props[i] = [int(t0[i])] + [int(t) for t in
                                       drafted[i, :k_eff[i] - 1]]
            tokens[i, :k_eff[i]] = props[i]
        vlogits = self._paged_step(tokens, k_eff, q_start=base,
                                   logits_mode="all")           # (B, k, V)
        # row j scores the token after p[j]: g is what plain decode emits
        greedy = vlogits.argmax(-1).cpu().numpy()
        if self.trace_logits:
            vlogits = vlogits.float().cpu().numpy()
        tails = [tail for i in idx if (tail := self._accept(
            i, int(base[i]), int(k_eff[i]), props[i], greedy[i],
            vlogits)) is not None]
        # every rejected tail of the tick in one launch for both pools, after
        # the loop: _append and _finish change host state only, and nothing
        # reads the pools before the next tick's paged steps
        self.pool.rollback_many(tails)

    def _accept(self, i: int, base: int, ke: int, p: list, g,
                vlogits) -> Optional[tuple]:
        """Greedy acceptance of slot ``i``'s proposals ``p`` against the
        verify's argmaxes ``g``: append the accepted tokens and the
        correction, then the slot's rejected tail ``(i, start, end)`` to
        erase, or None when the request finished (``_finish`` released the
        slot: no rollback, its fresh pages are zeroed by the next admission
        as usual)."""
        a = 0
        while a < ke - 1 and p[a + 1] == g[a]:
            a += 1
        self.stats.spec_proposed += ke - 1
        self.stats.spec_accepted += a
        for j in range(a + 1):
            if self.trace_logits:
                self.logit_trace.setdefault(
                    self.slots[i].req.rid, []).append(vlogits[i, j].copy())
            if self._append(i, int(g[j])):
                return None
        final = base + a + 1
        self.pool.lengths[i] = final
        self.slots[i].pending = int(g[a])
        return i, final, base + ke

    def step(self) -> None:
        """One scheduler tick: admit into free slots, decode (or
        speculatively decode) every ready slot, advance every mid-prefill
        slot by one chunk (so a slot that completes prefill starts decoding
        next tick). A tick that harvests tokens is charged a full batch of
        slots, as in the wave loop, times ``spec_k`` in speculative mode,
        where every slot had k chances."""
        self.clock += 1
        before = self.stats.useful_tokens
        with torch.inference_mode():
            self._admit()
            if self.speculative:
                self._run_spec_decode()
            else:
                self._run_decode()
            self._run_prefill_chunks()
        if self.stats.useful_tokens > before:
            self.stats.decode_steps += 1
            self.stats.slot_tokens += self.n_slots * (
                self.spec_k if self.speculative else 1)

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
