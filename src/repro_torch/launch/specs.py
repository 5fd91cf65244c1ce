"""Stand-ins for every input of a cell's step, on the ``meta`` device:
the PyTorch counterpart of ``repro/launch/specs.py``'s
``jax.ShapeDtypeStruct``s. A meta tensor has a shape and a dtype and no
storage, so nothing here allocates, at any cell's size.

``batch_specs`` and ``cache_specs`` give JAX's shapes and dtypes leaf by
leaf (the cache's ``len`` is a host int in the port, so it has no spec);
``params_specs`` gives the weights as JAX's tree names them (a stacked
leaf leads with its layer count), in the dtypes ``build_model`` gives
them. ``nbytes`` sums a tree of specs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

META = torch.device("meta")


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The step's batch (``specs.py:17-33``): ``tokens`` (B, S_in) int32,
    or ``embeds`` (B, S_in, d_model) bf16 behind a modality frontend;
    ``labels`` for a train cell; ``positions`` (3, B, S_in) under M-RoPE.
    A decode cell feeds one token against a seq_len-deep cache."""
    B = shape.global_batch
    S_in = 1 if shape.kind == "decode" else shape.seq_len
    out: dict = {}
    if cfg.frontend != "none":
        out["embeds"] = _spec((B, S_in, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _spec((B, S_in), torch.int32)
    if shape.kind == "train":
        out["labels"] = _spec((B, S_in), torch.int32)
    if cfg.mrope:
        out["positions"] = _spec((3, B, S_in), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, model) -> dict:
    """The serving state ``model.init_cache(B, seq_len)`` makes, made on
    the meta device (``model`` is a ``registry.Model`` of any device; only
    its config and dtypes are read): the dense KV cache ``{'k', 'v': (L,
    B, S, Hkv, D)}``, rwkv6's ``{'S', 'x_prev', 'x_prev_cm'}`` or the
    hybrid's ``{'h', 'conv', 'attn_cache'}``. Host ints (``len``) are left
    out."""
    from repro_torch.models.registry import build_model

    meta = build_model(cfg, META, param_dtype=model.param_dtype,
                       compute_dtype=model.compute_dtype)
    return _drop_ints(meta.init_cache(shape.global_batch, shape.seq_len))


def _drop_ints(tree: dict) -> dict:
    return {k: _drop_ints(v) if isinstance(v, dict) else v
            for k, v in tree.items() if isinstance(v, (dict, torch.Tensor))}


def params_specs(model) -> dict:
    """The weights of ``model``'s config and dtypes as JAX's flat tree of
    paths (``models/packing.param_tree``), stacked leaves as one (L, ...)
    spec each."""
    from repro_torch.models.convert import FAMILIES
    from repro_torch.models.packing import param_tree

    mod = FAMILIES[model.cfg.family](model.cfg, META, model.param_dtype)
    out = {}
    for path, leaf in param_tree(mod).items():
        if isinstance(leaf, list):
            out[path] = _spec((len(leaf),) + tuple(leaf[0].shape),
                              leaf[0].dtype)
        else:
            out[path] = _spec(tuple(leaf.shape), leaf.dtype)
    return out


def nbytes(tree) -> int:
    """The bytes of every spec (or tensor) in a nested dict or list."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return math.prod(tree.shape) * tree.element_size()
    return 0
