"""Synthetic datasets (the container has no real corpus and no real
MNIST or CIFAR-10). The port's copy of ``repro/data/synthetic.py``'s
``ArrayDataset``, ``synthetic_images``, ``synthetic_mnist``,
``synthetic_cifar10`` and ``synthetic_tokens``: the
same numpy draws, so the same seed gives the JAX package's arrays bit for
bit.

The classification data are learnable mixtures of prototypes (each class
a few prototype patterns plus Gaussian pixel noise); the LM data a token
stream from a mixture of Markov chains.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ArrayDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.x)

    def split(self, n_parts: int) -> list["ArrayDataset"]:
        """Partition across dataset owners (silos)."""
        xs = np.array_split(self.x, n_parts)
        ys = np.array_split(self.y, n_parts)
        return [ArrayDataset(a, b) for a, b in zip(xs, ys)]


def synthetic_images(n: int, hw: int, channels: int, n_classes: int,
                     seed: int = 0, noise: float = 0.35,
                     prototypes_per_class: int = 3) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (n_classes, prototypes_per_class, hw, hw,
                                   channels))
    y = rng.integers(0, n_classes, n)
    pick = rng.integers(0, prototypes_per_class, n)
    x = protos[y, pick] + rng.normal(0.0, noise, (n, hw, hw, channels))
    return ArrayDataset(x.astype(np.float32), y.astype(np.int32))


def synthetic_mnist(n_train: int = 8192, n_test: int = 2048, seed: int = 0):
    """``(train, test)``: the test set is drawn from the train set's
    prototypes (same seed), as in the JAX package."""
    tr = synthetic_images(n_train, 28, 1, 10, seed)
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (10, 3, 28, 28, 1))
    rng2 = np.random.default_rng(seed + 1000)
    y = rng2.integers(0, 10, n_test)
    pick = rng2.integers(0, 3, n_test)
    te = ArrayDataset((protos[y, pick] + rng2.normal(
        0, 0.35, (n_test, 28, 28, 1))).astype(np.float32), y.astype(np.int32))
    return tr, te


def synthetic_cifar10(n_train: int = 8192, n_test: int = 2048,
                      seed: int = 7):
    """``(train, test)`` NHWC ``(n, 32, 32, 3)`` float32 images of 10
    classes, both drawn from the prototypes of ``seed``, train from
    ``seed + 1`` and test from ``seed + 2``, as in the JAX package."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (10, 3, 32, 32, 3))

    def make(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, 10, n)
        pick = r.integers(0, 3, n)
        x = protos[y, pick] + r.normal(0, 0.35, (n, 32, 32, 3))
        return ArrayDataset(x.astype(np.float32), y.astype(np.int32))

    return make(n_train, seed + 1), make(n_test, seed + 2)


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
