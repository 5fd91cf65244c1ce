"""Carry weights across from the JAX package, and back.

``params_from_jax`` takes a JAX parameter tree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``) and fills the port's module
of the config's family: ``Transformer`` (dense, moe, vlm, encoder),
``RWKVStack`` (ssm) or ``Hybrid`` (hybrid). Every port parameter is named
by its JAX path (``layers.3.attn.wq`` is ``tree['layers']['attn']['wq'][3]``,
``layers.3.moe.we_gate`` slice 3 of the (L, E, d, f) leaf): the JAX tree
stacks every layer on a leading axis (its inits vmap over layer keys), the
port keeps one module per layer in a ``ModuleList`` (``layers``,
``mamba_layers``), so layer ``i`` takes slice ``[i]`` of every stacked
leaf. ``params_to_numpy`` gives any family's weights as the JAX tree
(``models/packing.param_tree``), bf16 weights as exact fp32 arrays.
Matrices are ``(d_in, d_out)`` in both packages: no transpose.
``small_params_from_jax`` takes the paper's small models' nested tree
(MNIST-MLP3's ``{'l0': {'w', 'b'}, ...}``) to the port's flat dict of
tensors keyed by the dotted JAX paths (``models/small.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.rwkv_stack import RWKVStack
from repro_torch.models.packing import param_tree
from repro_torch.models.transformer import Transformer

FAMILIES = {"dense": Transformer, "moe": Transformer, "vlm": Transformer,
            "encoder": Transformer, "ssm": RWKVStack, "hybrid": Hybrid}


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src)
    if src.dtype.kind not in "biuf":
        raise ValueError(f"{name}: numpy dtype {src.dtype} (numpy has no "
                         f"bf16); pass bf16 leaves as fp32 arrays, "
                         f"np.asarray(leaf, np.float32), which is exact")
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {src.shape}, port shape "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src, copy=True)))


def _jax_leaf(np_tree: dict, name: str):
    """The JAX leaf of a port parameter name; a stacked leaf's slice for a
    ``ModuleList`` entry (a numeric path part)."""
    node, index = np_tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            node = node[part]
    return node if index is None else node[index]


def params_from_jax(np_tree: dict, cfg: ModelConfig, device,
                    dtype=torch.float32):
    """The port's module of ``cfg.family`` holding the JAX tree's weights,
    in ``dtype`` (fp32, or bf16 as JAX's ``build_model(param_dtype=
    jnp.bfloat16)`` holds them: its bf16 leaves cross as fp32 arrays, exact
    both ways, and are rounded back here; the port imports no
    ``ml_dtypes``). The leaves JAX keeps fp32 under bf16 weights (the MoE
    router, rwkv6's ``w_base`` and ``u_bonus``, mamba2's ``A_log``, ``D``
    and ``dt_bias``) are fp32 in the port's module too, and take the fp32
    arrays as they are: the same mixed tree."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    model = FAMILIES[cfg.family](cfg, device, dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            _copy(p, _jax_leaf(np_tree, name), name)
    n_jax = sum(_numels(np_tree))
    n_port = sum(p.numel() for p in model.parameters())
    if n_jax != n_port:
        raise ValueError(f"the JAX tree holds {n_jax} weights, the port's "
                         f"{type(model).__name__} {n_port}")
    return model


def _numels(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _numels(v)
    else:
        yield int(np.size(node))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A weight on the host: fp32 as it is, bf16 widened to fp32 (exact;
    numpy has no bf16 and the port imports no ``ml_dtypes``)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_to_numpy(model) -> dict:
    """The JAX package's nested parameter tree of ``model``'s weights, as
    numpy copies (every ``layers.*`` leaf stacked on a leading axis). bf16
    weights come back as fp32 arrays of the same values, which
    ``jnp.asarray(leaf, jnp.bfloat16)`` rounds back bit for bit: the bf16
    tree JAX's ``build_model(param_dtype=jnp.bfloat16)`` holds, and
    ``params_from_jax(..., dtype=torch.bfloat16)`` takes them back."""
    tree: dict = {}
    for path, leaf in param_tree(model).items():
        *parents, name = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = (np.stack([_numpy(t) for t in leaf])
                      if isinstance(leaf, list) else _numpy(leaf).copy())
    return tree


def small_params_from_jax(np_tree: dict, device,
                          dtype=torch.float32) -> dict:
    """A small model's nested JAX tree (numpy leaves) -> the port's flat
    ``{"l0.w": tensor, ...}`` dict on ``device``, every leaf copied."""
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            path = f"{prefix}{k}"
            if isinstance(node[k], dict):
                walk(node[k], path + ".")
            else:
                out[path] = torch.tensor(np.asarray(node[k]), dtype=dtype,
                                         device=device)

    walk(np_tree, "")
    return out
