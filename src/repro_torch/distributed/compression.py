"""Gradient compression with error feedback: the port's copy of
``repro/distributed/compression.py``. int8 quantisation at a shared scale,
with each silo's residual carried to its next step so the compression
error does not bias the trajectory (error-feedback SGD).

JAX reduces inside ``shard_map`` over the silo axes: a ``pmax`` of each
silo's largest magnitude gives the shared scale, and the int8 values are
all-gathered and summed on every device. The port's silos are virtual (the
barrier tier runs them one after another on one card), so
:func:`reduce_compressed` takes each leaf stacked over the silo axis,
``(n, ...)``, and computes the same numbers: the scale from every silo's
largest magnitude, each silo's int8 values and residual, and the
dequantised sum of the silos in order. No kernel is involved: plain
torch, as JAX's is plain jnp.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
# JAX's floor under the shared scale (an all-zero leaf)
SCALE_FLOOR = 1e-12


def init_error_feedback(tree: dict) -> dict:
    """An fp32 zero residual for every leaf of ``tree`` (nested dicts)."""
    return {k: init_error_feedback(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in tree.items()}


def compress_leaf(g: torch.Tensor, ef: torch.Tensor, scale):
    """Quantise ``g + ef`` at ``scale``: ``(int8 values, fp32 residual)``.
    ``scale`` is a number or an fp32 tensor that broadcasts against ``g``;
    the division and the product run in fp32, as JAX's weakly typed
    scalar does."""
    x = g.float() + ef
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / s), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, x - q.float() * s


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def reduce_compressed(grads: dict, ef: dict):
    """The int8-compressed sum over the silo axis of stacked ``(n, ...)``
    leaves (JAX's ``reduce_compressed`` inside ``shard_map`` over ``n``
    devices). Per leaf: the shared scale ``max(max_i |g_i + ef_i|,
    1e-12) / 127``, each silo's int8 values and residual
    (:func:`compress_leaf`, its residual rounded once as JAX's jitted
    multiply-add rounds it), then the int8 values widened and summed in
    silo order, times the scale. Returns ``(aggregate, new error
    feedback)``: the aggregate's leaves drop the silo axis, the residuals
    keep it."""
    efs = dict(_leaves(ef))
    agg, new_ef = {}, {}
    for path, g in _leaves(grads):
        e = efs[path]
        n = g.shape[0]
        x = g.float() + e
        local_max = x.abs().reshape(n, -1).amax(dim=1)
        scale = torch.clamp(local_max.max(), min=SCALE_FLOOR) / INT8_MAX
        q, _ = compress_leaf(g, e, scale)
        # inside JAX's jit the residual's product and difference fuse into
        # one multiply-add, rounded once: q * scale is exact in fp64 (8
        # and 24 significant bits), and so is x less it, rounded once here
        r = (x.double() - q.double() * scale.double()).float()
        total = q[0].float()
        for i in range(1, n):
            total = total + q[i].float()
        agg[path] = total * scale
        new_ef[path] = r
    return _unflatten(agg), _unflatten(new_ef)
