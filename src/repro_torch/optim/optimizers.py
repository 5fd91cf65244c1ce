"""SGD, momentum and AdamW over packed fp32 buffers. Port of
``repro/optim/optimizers.py``.

The JAX package maps each update over the parameter tree, keeps an fp32
master copy and writes ``mst.astype(p.dtype)`` back into the parameters.
Here the master is one packed fp32 buffer and the moments are packed
buffers of the same layout. fp32 parameters are views of the master itself
(``models.packing.pack_train_params``: the cast is the identity in fp32);
bf16 parameters are views of one packed bf16 buffer, ``weights``, which
each update rewrites from the master, rounding to nearest even, chunk by
chunk right after the chunk's update. In a mixed tree only ``runs``, the
bf16 leaves' ranges (``core/flatbuf.dtype_runs``), are rewritten: the
fp32 leaves are the master's own views. An update runs in place over the
buffers in chunks, so its temporaries stay a few hundred MB at any P,
with the JAX package's arithmetic element for element: AdamW is
``(m / bc1) / (sqrt(v / bc2) + eps)`` with b2 = 0.95 by default, not
``torch.optim.AdamW``'s denominator. Divisors are tensors on the buffers'
device, so CUDA divides (torch turns a division by a host scalar into a
multiplication by its reciprocal).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import OptimizerConfig

CHUNK = 1 << 26  # elements per in-place pass (256 MB of fp32)


class Optimizer(NamedTuple):
    init: Callable    # master (P,) fp32 -> state dict ("master" is the buffer)
    # (state, grad (P,), lr, weights=None, runs=None) -> state: the master
    # updated in place, and ``weights`` (the packed bf16 parameters, None
    # when they are the master) rewritten from it over ``runs``, its
    # (start, end) bf16 ranges (None: all of it)
    update: Callable


def _chunks(n: int):
    for a in range(0, n, CHUNK):
        yield slice(a, min(a + CHUNK, n))


def _write_back(weights, mst, s, runs) -> None:
    """JAX's ``mst.astype(p.dtype)`` over one chunk: the bf16 parameters
    rounded from the updated master (``copy_`` rounds to nearest even),
    over the chunk's part of each bf16 range."""
    if weights is None:
        return
    for a, z in runs or ((0, mst.numel()),):
        lo, hi = max(a, s.start), min(z, s.stop)
        if lo < hi:
            weights[lo:hi].copy_(mst[lo:hi])


def _zeros_like(buf: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(buf, dtype=torch.float32)


def sgd() -> Optimizer:
    def init(master):
        return {"master": master}

    @torch.no_grad()
    def update(state, grads, lr, weights=None, runs=None):
        mst = state["master"]
        for c in _chunks(mst.numel()):
            mst[c] = mst[c] - lr * grads[c]
            _write_back(weights, mst, c, runs)
        return state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(master):
        return {"master": master, "mu": _zeros_like(master)}

    @torch.no_grad()
    def update(state, grads, lr, weights=None, runs=None):
        mst, mu = state["master"], state["mu"]
        for c in _chunks(mst.numel()):
            mu[c] = beta * mu[c] + grads[c]
            mst[c] = mst[c] - lr * mu[c]
            _write_back(weights, mst, c, runs)
        return state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(master):
        return {"master": master, "m": _zeros_like(master),
                "v": _zeros_like(master), "count": 0}

    @torch.no_grad()
    def update(state, grads, lr, weights=None, runs=None):
        mst, m, v = state["master"], state["m"], state["v"]
        c = state["count"] + 1
        f32 = dict(dtype=torch.float32)
        cf = torch.tensor(float(c), **f32)
        bc1 = (1 - torch.tensor(b1, **f32) ** cf).to(mst.device)
        bc2 = (1 - torch.tensor(b2, **f32) ** cf).to(mst.device)
        for s in _chunks(mst.numel()):
            g = grads[s]
            m[s] = b1 * m[s] + (1 - b1) * g
            v[s] = b2 * v[s] + (1 - b2) * g * g
            upd = (m[s] / bc1) / (torch.sqrt(v[s] / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * mst[s]
            mst[s] = mst[s] - lr * upd
            _write_back(weights, mst, s, runs)
        state["count"] = c
        return state

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "sgd":
        return sgd()
    if cfg.name == "momentum":
        return momentum(cfg.beta1)
    if cfg.name == "adamw":
        return adamw(cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    raise ValueError(cfg.name)
