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
package's leaf order; :func:`pack_train_params` moves the weights into
packed buffers, the parameters becoming views of them: fp32 weights view
the fp32 buffer that is the optimizer's master copy itself, bf16 weights
(``build_model(param_dtype=torch.bfloat16)``) one packed bf16 buffer of
the same layout, which the optimizer rewrites from its fp32 master after
every update (``optim/optimizers.py``). A tree may mix the two, as JAX's
does under ``param_dtype=bf16``: the MoE router, rwkv6's ``w_base`` and
``u_bonus`` and mamba2's ``A_log``, ``D`` and ``dt_bias`` stay fp32. The
bf16 buffer then spans the whole layout and its fp32 leaves' ranges go
unused (zero): the fp32 leaves view the master, which holds every leaf
(JAX's ``flatbuf.pack``, one fp32 buffer whatever the leaf dtypes), and
only the bf16 ranges (:func:`core.flatbuf.dtype_runs`) are rewritten.

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


def pack_train_params(params) -> tuple:
    """Move every weight of a module or a small model's flat dict into
    packed buffers, in place: each parameter becomes a trainable view.
    Returns ``(layout, master, weights)``: ``master`` the fp32 buffer
    holding every leaf (bf16 leaves widened exactly), which the fp32
    weights view; ``weights`` the bf16 buffer the bf16 weights view (None
    when there are none), its fp32 leaves' ranges zero and unused."""
    return _pack(params, True)


def pack_params(params):
    """:func:`pack_train_params` returning ``(layout, buffer)``: the bf16
    buffer when a weight is bf16 (with only bf16 weights no fp32 master is
    made), the fp32 master otherwise."""
    layout, master, weights = _pack(params, False)
    return layout, master if weights is None else weights


def _pack(params, want_master: bool) -> tuple:
    weights = params.values() if isinstance(params, dict) \
        else params.parameters()
    dtypes = {p.dtype for p in weights}
    if not dtypes or not dtypes <= {torch.float32, torch.bfloat16}:
        raise NotImplementedError(
            f"pack_params takes fp32 and bf16 weights; got "
            f"{sorted(str(d) for d in dtypes)}")
    tree = param_tree(params)
    layout = flatbuf.layout_of(tree)
    with torch.no_grad():
        if torch.bfloat16 not in dtypes:
            master, bf16 = flatbuf.pack(layout, tree), None
        elif torch.float32 not in dtypes:
            bf16 = flatbuf.pack(layout, tree, dtype=torch.bfloat16)
            master = bf16.to(torch.float32) if want_master else None
        else:
            master = flatbuf.pack(layout, tree)
            bf16 = torch.zeros(layout.total, dtype=torch.bfloat16,
                               device=master.device)
            for a, z in flatbuf.dtype_runs(layout, "bfloat16"):
                bf16[a:z].copy_(master[a:z])  # exact: bf16 values
    del tree
    views = flatbuf.unpack(layout, master, dtype=torch.float32) \
        if torch.float32 in dtypes else {}
    if bf16 is not None:
        halves = flatbuf.unpack(layout, bf16, dtype=torch.bfloat16)
        views.update({path: halves[path] for path, dt in
                      zip(layout.paths, layout.dtypes) if dt == "bfloat16"})
    if isinstance(params, dict):
        params.update({path: _param(views[path], trainable=True)
                       for path in layout.paths})
        return layout, master, bf16
    for path, slot in param_slots(params).items():
        pairs = slot if isinstance(slot, list) else [slot]
        parts = views[path] if isinstance(slot, list) else [views[path]]
        for (m, a), v in zip(pairs, parts):
            setattr(m, a, _param(v, trainable=True))
    return layout, master, bf16
