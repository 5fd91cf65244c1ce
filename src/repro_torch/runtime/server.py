"""Confidential serving runtime: length-bucketed wave batching. Port of
``repro/runtime/server.py``.

The dense KV cache advances every row in lockstep, so requests are bucketed
by prompt length and a wave of up to ``max_batch`` same-length prompts is
prefilled together, then decoded until every member finishes (early
finishers keep a dead row until the wave drains, measured by
``utilization``). Every wave gets a fresh cache, so no request ever reads
another's K/V (the serving analogue of the paper's R2 state isolation).
"""
from __future__ import annotations

import collections
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: list = field(default_factory=list)
    done: bool = False
    submit_step: int = 0   # scheduler clock at submission
    finish_step: int = -1  # scheduler clock when the last token landed
    # admission-control identity (the data owner / API key); None =
    # untenanted, exempt from per-tenant slot caps
    tenant: Optional[str] = None
    # under page-pool pressure the ContinuousServer may preempt the
    # lowest-priority running slot for a STRICTLY higher-priority request
    priority: int = 0


@dataclass
class ServerStats:
    waves: int = 0
    decode_steps: int = 0
    useful_tokens: int = 0
    slot_tokens: int = 0  # decode_steps x batch slots
    # per-request latency in scheduler steps (finish - submit)
    latencies: list = field(default_factory=list)
    # False when run_until_drained stopped on its step budget with requests
    # still queued or in flight (the percentiles then describe a truncated
    # trace)
    drained: bool = True
    # prefix sharing: prompt tokens whose prefill was skipped
    shared_prompt_tokens: int = 0
    # speculative decoding: draft proposals made / accepted by the verifier
    spec_proposed: int = 0
    spec_accepted: int = 0
    # slots evicted under pool pressure for a higher-priority request
    preemptions: int = 0

    @property
    def utilization(self) -> float:
        return self.useful_tokens / max(self.slot_tokens, 1)

    @property
    def acceptance_rate(self) -> float:
        return self.spec_accepted / max(self.spec_proposed, 1)

    def _pct(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return float(xs[min(len(xs) - 1, int(q * len(xs)))])

    @property
    def p50_latency_steps(self) -> float:
        return self._pct(0.50)

    @property
    def p99_latency_steps(self) -> float:
        return self._pct(0.99)


def greedy(logits: torch.Tensor) -> np.ndarray:
    """Greedy next tokens (B,) of logits (B, V), on the host."""
    return logits.argmax(dim=-1).cpu().numpy()


class WaveServer:
    """Batched prefill + decode waves over length-bucketed request queues."""

    def __init__(self, model, params, max_batch: int = 8, max_len: int = 512):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets: dict[int, collections.deque[Request]] = \
            collections.defaultdict(collections.deque)
        self.stats = ServerStats()

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid} exceeds max_len {self.max_len}")
        req.submit_step = self.stats.decode_steps  # queueing counts as latency
        self.buckets[len(req.prompt)].append(req)

    def _next_wave(self) -> list[Request]:
        if not self.buckets:
            return []
        plen = max(self.buckets, key=lambda k: len(self.buckets[k]))
        q = self.buckets[plen]
        wave = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        if not q:
            del self.buckets[plen]
        return wave

    def _run_wave(self, wave: list[Request]) -> None:
        B = len(wave)
        plen = len(wave[0].prompt)
        budget = max(r.max_new_tokens for r in wave)
        cache = self.model.init_cache(B, plen + budget)  # fresh: R2 isolation
        dev = self.model.device
        prompts = torch.as_tensor(np.stack([r.prompt for r in wave]),
                                  dtype=torch.long, device=dev)
        logits = self.model.prefill(self.params, prompts, cache)
        toks = greedy(logits)

        alive = np.ones(B, bool)
        for step in range(budget):
            self.stats.decode_steps += 1
            self.stats.slot_tokens += B
            for i, r in enumerate(wave):
                if not alive[i]:
                    continue
                t = int(toks[i])
                r.generated.append(t)
                self.stats.useful_tokens += 1
                if len(r.generated) >= r.max_new_tokens or \
                        (r.eos_id is not None and t == r.eos_id):
                    r.done = True
                    alive[i] = False
                    r.finish_step = self.stats.decode_steps
                    self.stats.latencies.append(r.finish_step - r.submit_step)
            if not alive.any() or step == budget - 1:
                break
            tok = torch.as_tensor(toks, dtype=torch.long, device=dev)[:, None]
            logits = self.model.decode_step(self.params, tok, cache)
            toks = greedy(logits)
        for r in wave:
            r.done = True
        self.stats.waves += 1

    def run_until_drained(self, max_waves: int = 1000) -> ServerStats:
        with torch.inference_mode():
            while self.buckets and self.stats.waves < max_waves:
                wave = self._next_wave()
                if not wave:
                    break
                self._run_wave(wave)
        self.stats.drained = not self.buckets
        if self.buckets:
            leftover = sum(len(q) for q in self.buckets.values())
            warnings.warn(
                f"run_until_drained stopped at max_waves={max_waves} with "
                f"{leftover} requests still queued — stats cover a "
                f"truncated trace", RuntimeWarning, stacklevel=2)
        return self.stats
