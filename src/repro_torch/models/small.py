"""The paper's evaluation models (section 8, Appendix B). Port of
``repro/models/small.py``: MNIST-MLP3.

The wire tier ships a parameter tree, not a module, so the model is
functional: :func:`mlp3_apply` over a flat dict keyed by the JAX paths
(``"l0.w"``, ``"l0.b"``, ...; matrices ``(d_in, d_out)`` as in JAX).
:class:`MLP3` wraps the same tree in an ``nn.Module`` for the user.
``SmallModel.loss`` takes ``{'x': (B, ...), 'y': (B,) int}``.

CIFAR10-CNN6 and CIFAR10-WRN28 are not ported yet (``ROADMAP.md`` queue 1,
item 12): :func:`build_small_model` raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.configs.paper_models import CNNConfig, MLPConfig, WRNConfig
from repro_torch.models.layers import cross_entropy


def _dims(cfg: MLPConfig) -> tuple:
    return (cfg.input_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)


def mlp3_init(gen: torch.Generator, cfg: MLPConfig,
              dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on its device: each matrix a standard
    normal times ``d_in ** -0.5`` (JAX's ``dense_init``), biases zero."""
    dims = _dims(cfg)
    dev = gen.device
    params = {}
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=gen, device=dev,
                        dtype=torch.float32) * (1.0 / dims[i]) ** 0.5
        params[f"l{i}.w"] = w.to(dtype)
        params[f"l{i}.b"] = torch.zeros(dims[i + 1], dtype=dtype, device=dev)
    return params


def mlp3_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"l{i}.w"] + params[f"l{i}.b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


class MLP3(nn.Module):
    """MNIST-MLP3 as a module: one weight and one bias per layer, named and
    shaped as the functional tree (:meth:`params` gives that tree)."""

    def __init__(self, cfg: MLPConfig, gen: torch.Generator):
        super().__init__()
        tree = mlp3_init(gen, cfg)
        self.layers = nn.ModuleList()
        for i in range(len(tree) // 2):
            layer = nn.Module()
            layer.w = nn.Parameter(tree[f"l{i}.w"])
            layer.b = nn.Parameter(tree[f"l{i}.b"])
            self.layers.append(layer)

    def params(self) -> dict:
        return {f"l{i}.{k}": getattr(layer, k)
                for i, layer in enumerate(self.layers) for k in ("w", "b")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp3_apply(self.params(), x)


@dataclass(frozen=True)
class SmallModel:
    name: str
    init: Callable[[torch.Generator], dict]
    apply: Callable[..., Any]

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        return cross_entropy(self.apply(params, batch["x"]), batch["y"])

    def accuracy(self, params: dict, batch: dict) -> torch.Tensor:
        logits = self.apply(params, batch["x"])
        return torch.mean((logits.argmax(-1) == batch["y"].long()).float())


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``, the twin of
    ``jax.value_and_grad``: the gradient of ``loss_fn`` with respect to every
    tensor of the flat ``params`` dict, by autograd on detached leaves (the
    caller's tensors are not touched)."""
    def grad_fn(params: dict, batch: dict):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))
    return grad_fn


def build_small_model(cfg) -> SmallModel:
    if isinstance(cfg, MLPConfig):
        return SmallModel(cfg.name, lambda gen: mlp3_init(gen, cfg),
                          mlp3_apply)
    if isinstance(cfg, (CNNConfig, WRNConfig)):
        raise NotImplementedError(
            f"{cfg.name} is not ported to repro_torch yet (ROADMAP.md queue "
            f"1, item 12: other model families)")
    raise TypeError(cfg)
