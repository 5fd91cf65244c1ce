"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP): the port's copy
of ``repro/distributed/sharding_rules.py``.

Models name a tensor's dims with *logical* axes; the rules map them to
mesh axes:

  batch    -> ("pod", "data")     data parallel over silos
  seq      -> ("pod", "data")     sequence parallel (where batch is 1)
  heads    -> "model"             tensor parallel (attention heads)
  kv_heads -> "model"             (replicated where it does not divide)
  ff       -> "model"             tensor parallel (FFN hidden)
  vocab    -> "model"             tensor parallel (embedding / logits)
  experts  -> "model"             expert parallel
  fsdp     -> "data"              parameter and optimizer sharding
  (anything else) -> replicated

An axis that does not divide its dim is dropped (the dim is replicated),
and an axis absent from the mesh or of size 1 is dropped too, as JAX's
rules degrade. torch has no ambient mesh, so every function takes the
mesh as an argument, a ``configs.base.MeshConfig``; a spec is a tuple
with one entry a dim: ``None`` (replicated), an axis name, or a tuple of
axis names. On the one-card mesh (``launch/mesh.mesh_config``) every spec
is all ``None`` and :func:`constrain` returns its input. The four-card
tiers (``ROADMAP.md`` queue 1 item 14) read these specs; nothing here
places a tensor or runs a collective.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Union

import torch

from repro_torch.configs.base import MeshConfig

Axis = Union[None, str, tuple]
Spec = tuple

RULES: dict = {
    "batch": ("pod", "data"),
    "seq": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "seq_tp": "model",  # Megatron sequence parallelism (residuals)
    "fsdp": "data",
    "dhead": None,
    "dmodel": None,
    "layers": None,
    None: None,
}


def _sizes(mesh: MeshConfig) -> dict:
    return dict(zip(mesh.axes, mesh.shape))


def _present_axes(mesh: MeshConfig, axis: Axis) -> Axis:
    """The axes of ``axis`` that the mesh has at a size above 1; ``None``
    when none is left, a name when one is."""
    if axis is None:
        return None
    names = (axis,) if isinstance(axis, str) else axis
    sizes = _sizes(mesh)
    kept = tuple(a for a in names if sizes.get(a, 1) > 1)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def _axis_size(mesh: MeshConfig, axis: Axis) -> int:
    if axis is None:
        return 1
    names = (axis,) if isinstance(axis, str) else axis
    sizes = _sizes(mesh)
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def spec_for(logical: Sequence[Optional[str]],
             dims: Optional[Sequence[int]] = None,
             mesh: Optional[MeshConfig] = None) -> Spec:
    """The spec of a tensor whose dims are named ``logical``, on ``mesh``
    (``None``: no mesh, every dim replicated), an axis that does not
    divide its dim in ``dims`` dropped."""
    out = []
    for i, name in enumerate(logical):
        axis = RULES.get(name, None)
        if axis is None or mesh is None:
            out.append(None)
            continue
        axis = _present_axes(mesh, axis)
        size = _axis_size(mesh, axis)
        if axis is None or size <= 1 or (dims is not None
                                         and dims[i] % size != 0):
            out.append(None)
            continue
        out.append(axis)
    return tuple(out)


def constrain(x: torch.Tensor, *logical: Optional[str],
              mesh: Optional[MeshConfig] = None) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` by logical names. The port's
    mesh is one card, or silos run one after another on it: no tensor is
    placed, so ``x`` comes back as it is, after its spec is checked to
    name one entry a dim."""
    if len(logical) != x.dim():
        raise ValueError(f"constrain: {len(logical)} names for a "
                         f"{x.dim()}-d tensor")
    spec_for(logical, tuple(x.shape), mesh)
    return x


# ---------------------------------------------------------------------------
# parameter specs by the parameters' names

# (a path's last key) -> logical names of the tensor's *trailing* dims; the
# leading stacked-layer dims are replicated
_PARAM_RULES: list = [
    ("embed", ("vocab", "fsdp")),
    ("lm_head", ("fsdp", "vocab")),
    ("wq", ("fsdp", "heads")),
    ("wk", ("fsdp", "kv_heads")),
    ("wv", ("fsdp", "kv_heads")),
    ("wo", ("heads", "fsdp")),
    ("bq", ("heads",)),
    ("bk", ("kv_heads",)),
    ("bv", ("kv_heads",)),
    ("w_gate", ("fsdp", "ff")),
    ("w_up", ("fsdp", "ff")),
    ("w_down", ("ff", "fsdp")),
    ("router", ("fsdp", "experts")),
    # expert weights: EP over the model axis on dim E; the per-expert
    # matmul dims get FSDP (EP and TP on one mesh axis would repeat it)
    ("we_gate", ("experts", "fsdp", None)),
    ("we_up", ("experts", "fsdp", None)),
    ("we_down", ("experts", None, "fsdp")),
    # rwkv6 / mamba2
    ("w_in", ("fsdp", "ff")),
    ("w_out", ("ff", "fsdp")),
    ("in_proj", ("fsdp", "ff")),
    ("out_proj", ("ff", "fsdp")),
    ("wr", ("fsdp", "heads")),  # rwkv time-mix receptance (head-TP)
    ("wg", ("fsdp", "heads")),  # rwkv time-mix gate
    ("w_recept", ("fsdp", "ff")),  # rwkv channel-mix receptance
    ("scale", ("fsdp",)),
]


def _match(path: str) -> Optional[tuple]:
    """The rule of a path's last key (``/`` or ``.`` separated, JAX's
    and ``launch/specs.params_specs``'s spellings)."""
    last = re.split(r"[./]", path)[-1]
    for key, names in _PARAM_RULES:
        if last == key:
            return names
    return None


def param_spec(path: str, shape: Sequence[int],
               mesh: Optional[MeshConfig]) -> Spec:
    """One parameter's spec: its rule's names right-aligned to its
    trailing dims (leading dims replicated; a rule longer than the rank
    keeps its last names), or all ``None`` without a rule."""
    names = _match(path)
    nd = len(shape)
    if names is None or mesh is None:
        return (None,) * nd
    logical = [None] * (nd - len(names)) + list(names)
    logical = logical if nd >= len(names) else logical[-nd:]
    return spec_for(logical, tuple(shape), mesh)


def params_pspecs(params: dict, mesh: Optional[MeshConfig],
                  prefix: str = "") -> dict:
    """The spec of every leaf of ``params`` (nested dicts of tensors or
    meta specs, as ``launch/specs.params_specs`` gives them), in the same
    structure."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = params_pspecs(v, mesh, path + "/")
        else:
            out[k] = param_spec(path, tuple(v.shape), mesh)
    return out
