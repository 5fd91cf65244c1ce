"""Synthetic LM token data (the container has no real corpus). The port's
copy of ``synthetic_tokens`` from ``repro/data/synthetic.py``: the same
numpy draws, so the same seed gives the JAX package's tokens."""
from __future__ import annotations

import numpy as np


def synthetic_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
                     n_chains: int = 4) -> np.ndarray:
    """(n_seqs, seq_len + 1) int32 from a mixture of order-1 Markov chains
    over a small effective vocabulary (next-token loss is learnable)."""
    rng = np.random.default_rng(seed)
    eff = min(vocab, 256)
    trans = rng.dirichlet(np.ones(eff) * 0.05, (n_chains, eff))
    out = np.zeros((n_seqs, seq_len + 1), np.int32)
    for i in range(n_seqs):
        c = rng.integers(0, n_chains)
        t = rng.integers(0, eff)
        for j in range(seq_len + 1):
            out[i, j] = t
            t = rng.choice(eff, p=trans[c, t])
    return out
