"""Synthetic serving workloads. Port of ``repro/runtime/serving/load.py``:
the same numpy draws, so a seed gives the same requests in both packages.

Real serving traffic is heavy-tailed (many short prompts, a few long ones),
the regime where wave batching loses; the generators rank lengths by a Zipf
law so benchmarks and tests exercise that regime deterministically.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.runtime.server import Request


def zipf_requests(n: int, vocab_size: int, *, alpha: float = 1.2,
                  min_len: int = 4, max_len: int = 64,
                  max_new_low: int = 4, max_new_high: int = 32,
                  eos_id: Optional[int] = None, seed: int = 0) -> list[Request]:
    """``n`` requests whose prompt lengths follow a bounded Zipf law:
    P(length = min_len + k) ∝ (k+1)^-alpha, plus uniform decode budgets in
    [max_new_low, max_new_high]. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    K = max_len - min_len + 1
    w = (1.0 + np.arange(K)) ** -alpha
    w /= w.sum()
    lens = min_len + rng.choice(K, size=n, p=w)
    budgets = rng.integers(max_new_low, max_new_high + 1, size=n)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab_size, lens[i]).astype(np.int32),
                    max_new_tokens=int(budgets[i]), eos_id=eos_id)
            for i in range(n)]


def shared_prefix_requests(n: int, vocab_size: int, *, n_groups: int = 4,
                           prefix_len: int = 32, alpha: float = 1.2,
                           tail_min: int = 1, tail_max: int = 32,
                           max_new_low: int = 4, max_new_high: int = 32,
                           eos_id: Optional[int] = None,
                           seed: int = 0) -> list[Request]:
    """``n_groups`` tenants, each with its own fixed ``prefix_len``-token
    system prompt; every request is its tenant's prefix plus a Zipf-length
    unique tail. Group membership is Zipf-skewed too. Deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab_size, prefix_len).astype(np.int32)
                for _ in range(n_groups)]
    gw = (1.0 + np.arange(n_groups)) ** -alpha
    gw /= gw.sum()
    groups = rng.choice(n_groups, size=n, p=gw)
    K = tail_max - tail_min + 1
    tw = (1.0 + np.arange(K)) ** -alpha
    tw /= tw.sum()
    tails = tail_min + rng.choice(K, size=n, p=tw)
    budgets = rng.integers(max_new_low, max_new_high + 1, size=n)
    return [Request(
        rid=i,
        prompt=np.concatenate([
            prefixes[groups[i]],
            rng.integers(0, vocab_size, tails[i]).astype(np.int32)]),
        max_new_tokens=int(budgets[i]), eos_id=eos_id,
        tenant=f"tenant{groups[i]}")
        for i in range(n)]
