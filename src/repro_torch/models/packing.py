"""The training layout of any family's weights: the JAX parameter tree and
the packed fp32 master buffer.

The JAX package stacks every layer of a ``ModuleList`` (``layers`` of the
dense and ssm families, ``mamba_layers`` of the hybrid) on a leading axis
and names each leaf by its path without the layer index
(``layers.attn.wq``, ``mamba_layers.mamba.A_log``); a module used once
(``embed``, ``ln_f``, the hybrid's ``shared`` block) keeps its own path.
The port's parameter names are those paths with the layer index inserted
(``layers.3.attn.wq``), so :func:`param_slots` reads the tree off
``named_parameters``, for every family alike.

``param_tree`` is the flat tree ``core/flatbuf.py`` packs in the JAX
package's leaf order; ``pack_params`` moves the weights into one packed
buffer of their dtype, the parameters becoming views of it: fp32 weights
view the buffer that is the optimizer's master copy itself, bf16 weights
(``build_model(param_dtype=torch.bfloat16)``) one packed bf16 buffer of
the same layout, which the optimizer rewrites from its fp32 master after
every update (``optim/optimizers.py``).

A small model (``models/small.py``) has no module: its weights are a flat
dict keyed by JAX path already. Both functions take such a dict too; it is
its own tree, and ``pack_params`` rebinds its values to views of the buffer
in place, so the caller's dict is the train state's ``params``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import flatbuf
from repro_torch.models.layers import _param


def param_slots(params: nn.Module) -> dict:
    """JAX path -> where its tensors live: ``(module, attribute)``, or a
    list of them, one per layer in layer order, for a stacked leaf."""
    slots: dict = {}
    for name, _ in params.named_parameters():
        *mods, attr = name.split(".")
        module = params.get_submodule(".".join(mods)) if mods else params
        if any(m.isdigit() for m in mods):
            path = ".".join([m for m in mods if not m.isdigit()] + [attr])
            slots.setdefault(path, []).append((module, attr))
        else:
            slots[name] = (module, attr)
    return slots


def param_tree(params) -> dict:
    """The weights as a flat tree keyed by JAX path (``core/flatbuf.py``):
    a small model's flat dict is that tree itself."""
    if isinstance(params, dict):
        return params
    return {path: [getattr(m, a) for m, a in slot] if isinstance(slot, list)
            else getattr(*slot) for path, slot in param_slots(params).items()}


def pack_params(params):
    """Move every weight of a module or a small model's flat dict into one
    packed buffer of the weights' dtype (fp32 or bf16, one for all), in
    place: each parameter becomes a trainable view of the buffer. Returns
    ``(layout, buffer)``, the layout recording the weights' dtype."""
    weights = params.values() if isinstance(params, dict) \
        else params.parameters()
    dtypes = {p.dtype for p in weights}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise NotImplementedError(
            f"pack_params takes weights of one dtype, fp32 or bf16; got "
            f"{sorted(str(d) for d in dtypes)}")
    tree = param_tree(params)
    layout = flatbuf.layout_of(tree)
    with torch.no_grad():
        buf = flatbuf.pack(layout, tree, dtype=dtypes.pop())
    del tree
    views = flatbuf.unpack(layout, buf)
    if isinstance(params, dict):
        params.update({path: _param(views[path], trainable=True)
                       for path in layout.paths})
        return layout, buf
    for path, slot in param_slots(params).items():
        pairs = slot if isinstance(slot, list) else [slot]
        parts = views[path] if isinstance(slot, list) else [views[path]]
        for (m, a), v in zip(pairs, parts):
            setattr(m, a, _param(v, trainable=True))
    return layout, buf
