"""Per-silo data pipeline: deterministic, restart-safe batch iteration. The
port's copy of ``repro/data/pipeline.py``: the same numpy permutations, so
the same seed gives the JAX package's indices, and the same state dicts.

Each dataset owner iterates its own shard. The iterator state is just
``(seed, step)``, checkpointed with the model (the trainer's
``batch_state``), so a restarted run resumes on the exact batch it would
have seen. Batches are numpy arrays; the caller moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.synthetic import ArrayDataset


@dataclass
class SiloIterator:
    data: ArrayDataset
    batch: int
    seed: int = 0
    step: int = 0

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.data))

    def next(self) -> dict:
        per_epoch = max(len(self.data) // self.batch, 1)
        epoch, within = divmod(self.step, per_epoch)
        order = self._order(epoch)
        idx = order[(within * self.batch) % len(self.data):][: self.batch]
        if len(idx) < self.batch:  # wrap
            idx = np.concatenate([idx, order[: self.batch - len(idx)]])
        self.step += 1
        return {"x": self.data.x[idx], "y": self.data.y[idx]}

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self.step = d["step"]
        self.seed = d["seed"]


class FederatedBatcher:
    """Assembles the cross-silo global batch (leading dim = silos-flattened)
    matching the train step's ``_reshape_to_silos`` layout."""

    def __init__(self, silos: list[ArrayDataset], per_silo_batch: int, seed: int = 0):
        self.iters = [SiloIterator(d, per_silo_batch, seed + i)
                      for i, d in enumerate(silos)]

    def next(self) -> dict:
        parts = [it.next() for it in self.iters]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}

    def state_dict(self) -> dict:
        return {"iters": [it.state_dict() for it in self.iters]}

    def load_state_dict(self, d: dict) -> None:
        for it, s in zip(self.iters, d["iters"]):
            it.load_state_dict(s)
