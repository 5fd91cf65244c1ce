"""Carry weights across from the JAX package, and back.

``params_from_jax`` takes the JAX dense-transformer parameter tree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and fills the
port's ``Transformer``; ``params_to_numpy`` gives the port's weights as that
same tree. The JAX tree stacks every layer on a leading axis
(its init vmaps over layer keys, ``transformer.py:65``); the port keeps one
``Block`` per layer, so layer ``i`` takes slice ``[i]`` of every stacked
leaf. Matrices are ``(d_in, d_out)`` in both packages: no transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer, param_tree


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {src.shape}, port shape "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src, copy=True)))


def params_from_jax(np_tree: dict, cfg: ModelConfig, device,
                    dtype=torch.float32) -> Transformer:
    """The port's ``Transformer`` holding the JAX tree's weights."""
    model = Transformer(cfg, device, dtype)
    with torch.no_grad():
        _copy(model.embed, np_tree["embed"], "embed")
        _copy(model.ln_f.scale, np_tree["ln_f"]["scale"], "ln_f.scale")
        if not cfg.tie_embeddings:
            _copy(model.lm_head, np_tree["lm_head"], "lm_head")
        L = np_tree["layers"]
        for i, blk in enumerate(model.layers):
            _copy(blk.ln1.scale, L["ln1"]["scale"][i], f"layers.{i}.ln1")
            _copy(blk.ln2.scale, L["ln2"]["scale"][i], f"layers.{i}.ln2")
            names = ["wq", "wk", "wv", "wo"]
            if cfg.qkv_bias:
                names += ["bq", "bk", "bv"]
            for n in names:
                _copy(getattr(blk.attn, n), L["attn"][n][i],
                      f"layers.{i}.attn.{n}")
            for n in ("w_gate", "w_up", "w_down"):
                _copy(getattr(blk.ffn, n), L["ffn"][n][i],
                      f"layers.{i}.ffn.{n}")
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The JAX package's nested parameter tree of ``model``'s weights, as
    numpy copies (every ``layers.*`` leaf stacked on a leading axis)."""
    tree: dict = {}
    for path, leaf in param_tree(model).items():
        *parents, name = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = (np.stack([t.detach().cpu().numpy() for t in leaf])
                      if isinstance(leaf, list)
                      else leaf.detach().cpu().numpy().copy())
    return tree
