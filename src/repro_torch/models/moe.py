"""Top-k MoE FFN with capacity-based dispatch (GShard-style). Port of
``repro/models/moe.py``.

Each token picks its ``top_k`` experts by router probability; each expert
takes at most ``capacity`` tokens, assigned slot by slot (k outer, tokens in
order), and a token past an expert's capacity is dropped from that expert
(its gate zeroed). The kept tokens are scattered into one ``(E * C, D)``
dispatch buffer, the experts run as batched SwiGLU products, and the
outputs are gathered back and combined with the renormalized gates.

The JAX package splits the dispatch into groups aligned with the data
shards of its mesh (``_dispatch_groups``); the port runs on one card, where
that count is 1, so the bookkeeping runs over all tokens at once. The
expert products are large matrix products that the JAX package computes
outside any Pallas kernel, so they are ``torch.bmm`` here.

On CUDA the scatter (``index_add_``) and the gather's backward add with
atomics; every destination gets one real row plus exact zeros (a dropped
token's row is multiplied by 0 and lands on slot ``C - 1``), so the sums
do not depend on the order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _param, dense_init, xla_silu


class MoE(nn.Module):
    """The router ``(d, E)``, always fp32, and the experts' SwiGLU weights
    ``we_gate`` / ``we_up`` ``(E, d, f)`` and ``we_down`` ``(E, f, d)``.
    ``gen=None`` allocates the shapes only (for ``models.convert``)."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

        def normal(*shape, scale):
            if gen is None:
                return torch.empty(*shape, device=device, dtype=dtype)
            return (torch.randn(*shape, generator=gen, device=device,
                                dtype=torch.float32) * scale).to(dtype)

        self.router = _param(
            torch.empty(d, E, device=device, dtype=torch.float32)
            if gen is None else dense_init(gen, d, E, device, torch.float32))
        self.we_gate = _param(normal(E, d, f, scale=(1.0 / d) ** 0.5))
        self.we_up = _param(normal(E, d, f, scale=(1.0 / d) ** 0.5))
        self.we_down = _param(normal(E, f, d, scale=(1.0 / f) ** 0.5))


def _topk_gates(logits: torch.Tensor, k: int):
    """Renormalized top-k gates: logits (T, E) fp32 -> gates (T, K), idx
    (T, K). ``jax.lax.top_k`` puts the lower index first among equal
    probabilities and ``torch.topk`` promises no order, so the pick is a
    stable descending sort's first K."""
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    gates = torch.gather(probs, 1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def _positions_in_expert(idx: torch.Tensor, E: int, capacity: int):
    """Slot assignment per (token, k): idx (T, K) -> pos (T, K) int64 and
    keep (T, K) bool. Sequential over the K slots: slot k's picks rank
    after every earlier slot's picks of the same expert."""
    T, K = idx.shape
    counts = torch.zeros(E, dtype=torch.long, device=idx.device)
    pos, keep = [], []
    for k in range(K):
        onehot = F.one_hot(idx[:, k], E)                   # (T, E)
        ranks = torch.cumsum(onehot, 0) - onehot           # rank among picks
        p = (ranks * onehot).sum(1) + counts[idx[:, k]]
        counts = counts + onehot.sum(0)
        pos.append(p)
        keep.append(p < capacity)
    return torch.stack(pos, 1), torch.stack(keep, 1)


def capacity_of(T: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Tokens each expert takes: ``int(max(K, T * K / E * cf))``."""
    K = cfg.top_k
    return int(max(K, T * K / cfg.n_experts * capacity_factor))


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          capacity: int):
    """The routing of flat tokens xt (T, D): ``(logits, gates, idx, pos,
    keep)``, the gates of dropped picks zeroed."""
    logits = xt.float() @ router                           # (T, E)
    gates, idx = _topk_gates(logits, cfg.top_k)
    pos, keep = _positions_in_expert(idx, cfg.n_experts, capacity)
    return logits, gates * keep.to(gates.dtype), idx, pos, keep


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25, train: bool = False):
    """Top-k MoE. x (B, S, D) -> (B, S, D), plus the aux load-balance
    loss. ``train``: the training forward, whose bf16 SiLU follows XLA's
    order (``layers.XlaSilu``), as the dense FFN's."""
    B, S, D = x.shape
    out, aux = _moe_tokens(p, x.reshape(B * S, D), cfg, capacity_factor,
                           train)
    return out.reshape(B, S, D), aux


def _moe_tokens(p: MoE, xt: torch.Tensor, cfg: ModelConfig,
                capacity_factor: float = 1.25, train: bool = False):
    """xt (T, D) flat tokens -> (T, D), plus the aux load-balance loss."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    capacity = capacity_of(T, cfg, capacity_factor)
    logits, gates, idx, pos, keep = route(xt, p.router, cfg, capacity)

    # aux loss (Switch): E * sum(fraction routed x mean router probability)
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(frac * probs.mean(0))

    # scatter into the (E * C, D) dispatch buffer; dropped picks carry zero
    # rows to slot C - 1
    flat_idx = (idx * capacity + torch.clamp(pos, max=capacity - 1)).reshape(-1)
    keep_x = keep.reshape(-1, 1).to(xt.dtype)
    src = xt.repeat_interleave(K, 0) * keep_x
    buf = torch.zeros(E * capacity, D, dtype=xt.dtype, device=xt.device)
    buf = buf.index_add(0, flat_idx, src).reshape(E, capacity, D)

    # grouped expert FFN (SwiGLU)
    g = torch.bmm(buf, p.we_gate.to(xt.dtype))
    u = torch.bmm(buf, p.we_up.to(xt.dtype))
    out_e = torch.bmm(xla_silu(g, train) * u, p.we_down.to(xt.dtype))

    # combine: gather the expert outputs back to tokens, weight by gates
    gathered = out_e.reshape(E * capacity, D)[flat_idx]     # (T*K, D)
    gathered = gathered * (gates.reshape(-1, 1).to(xt.dtype) * keep_x)
    return gathered.reshape(T, K, D).sum(1), aux


def moe_apply_dense_ref(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The plain check: every expert run densely, combined with the top-k
    gates (O(E) products; no capacity, so it equals the dispatch path only
    where no token drops)."""
    B, S, D = x.shape
    E = cfg.n_experts
    xt = x.reshape(-1, D)
    gates, idx = _topk_gates(xt.float() @ p.router, cfg.top_k)
    g = torch.einsum("td,edf->tef", xt, p.we_gate.to(x.dtype))
    u = torch.einsum("td,edf->tef", xt, p.we_up.to(x.dtype))
    out_e = torch.einsum("tef,efd->ted", F.silu(g) * u, p.we_down.to(x.dtype))
    mask = (F.one_hot(idx, E).to(gates.dtype) * gates[..., None]).sum(1)
    out = torch.einsum("ted,te->td", out_e.float(), mask)
    return out.reshape(B, S, D).to(x.dtype)
