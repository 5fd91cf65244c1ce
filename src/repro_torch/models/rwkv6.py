"""RWKV-6 "Finch" block: data-dependent per-channel decay linear attention.
Port of ``repro/models/rwkv6.py``.

Recurrence per head (head size N):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T                (S: N x N)
    o_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t^T        (bonus on current token)

A multi-token step runs the WKV scan (``kernels/rwkv6/ops.wkv_chunked``:
the CUDA kernel on the card); a one-token decode step runs the recurrence
in plain torch, as the JAX package does. Training differentiates the scan
through ``ops.WKV`` (on the card its backward is the ``wkv_bwd`` kernel).
With a state, the state's tensors (``S``, ``x_prev``, ``x_prev_cm``: one
layer's views of the stack's state) are updated in place.
[arXiv:2404.05892]
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.models.layers import (_param, dense_init, xla_sigmoid,
                                       xla_silu)

LORA_RANK = 64
CHUNK = 32


class RWKV6Mix(nn.Module):
    """Time-mix and channel-mix weights of one block, named as the JAX
    package's ``rwkv6_init`` tree. ``gen=None`` allocates the shapes only
    (for ``models.convert``)."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, H, N, R = cfg.d_model, cfg.n_heads, cfg.rwkv_head_size, LORA_RANK
        empty = lambda *s: torch.empty(*s, device=device, dtype=dtype)
        full = lambda s, v: torch.full(s, v, device=device, dtype=dtype)

        def dense(i, o, scale=None):
            return empty(i, o) if gen is None else \
                dense_init(gen, i, o, device, dtype, scale)

        # token-mix projections
        self.wr, self.wk, self.wv = (_param(dense(d, d)) for _ in range(3))
        self.wg, self.wo = _param(dense(d, d)), _param(dense(d, d))
        # ddlerp mix coefficients (5: r, k, v, g, w) + lora
        self.mu = _param(full((5, d), 0.5))
        self.mu_x = _param(full((d,), 0.5))
        self.lora_a = _param(dense(d, 5 * R, 0.01))
        self.lora_b = _param(empty(5, R, d) if gen is None else (
            torch.randn(5, R, d, generator=gen, device=device) * 0.01
        ).to(dtype))
        # data-dependent decay (fp32, as in the JAX package)
        self.w_base = _param(torch.full((d,), -0.6, device=device))
        self.w_lora_a = _param(dense(d, R, 0.01))
        self.w_lora_b = _param(dense(R, d, 0.01))
        self.u_bonus = _param(torch.zeros(H, N, device=device))
        # group norm per head
        self.gn_scale = _param(full((d,), 1.0))
        # channel mix
        self.mu_cm_k = _param(full((d,), 0.5))
        self.mu_cm_r = _param(full((d,), 0.5))
        self.w_in = _param(dense(d, cfg.d_ff))
        self.w_out = _param(dense(cfg.d_ff, d))
        self.w_recept = _param(dense(d, d))


def _token_shift(x, x_prev_last=None):
    """x (B, S, D) -> the previous token's activation; position 0 takes
    ``x_prev_last`` (B, D), zero at the sequence start."""
    first = torch.zeros_like(x[:, :1]) if x_prev_last is None \
        else x_prev_last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix_inputs(p: RWKV6Mix, x, x_prev):
    """ddlerp: 5 per-token mix coefficients -> mixed inputs (r, k, v, g, w)."""
    dx = x_prev - x
    tmp = x + dx * p.mu_x.to(x.dtype)
    a = torch.tanh(tmp @ p.lora_a.to(x.dtype))                    # (B, S, 5R)
    B, S, _ = a.shape
    a = a.reshape(B, S, 5, LORA_RANK)
    adj = torch.einsum("bsir,ird->bsid", a, p.lora_b.to(x.dtype))  # (B,S,5,D)
    mix = p.mu.to(x.dtype)[None, None] + adj
    return x[:, :, None] + dx[:, :, None] * mix                   # (B,S,5,D)


def _decay(p: RWKV6Mix, xw):
    ww = p.w_base + (torch.tanh(xw.float() @ p.w_lora_a.float())
                     @ p.w_lora_b.float())
    return torch.exp(-torch.exp(ww))  # (B, S, D) in (0, 1)


def _group_norm(x, scale, H: int, N: int, eps: float = 1e-5):
    B, S, _ = x.shape
    xh = x.reshape(B, S, H, N).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, H * N) * scale.float()).to(x.dtype)


def time_mix(p: RWKV6Mix, x, cfg: ModelConfig, state: Optional[dict] = None,
             train: bool = False):
    """x (B, S, D) -> (B, S, D). ``state``: ``{'S': (B, H, N, N),
    'x_prev': (B, D)}``, updated in place; None (training) starts from
    zeros. ``train``: the training forward, whose bf16 SiLU follows XLA's
    order (``layers.XlaSilu``)."""
    B, S, D = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_size
    x_prev = _token_shift(x, None if state is None else state["x_prev"])
    mixed = _mix_inputs(p, x, x_prev)
    xr, xk, xv, xg, xw = mixed.unbind(2)
    r = (xr @ p.wr.to(x.dtype)).reshape(B, S, H, N).float()
    k = (xk @ p.wk.to(x.dtype)).reshape(B, S, H, N).float()
    v = (xv @ p.wv.to(x.dtype)).reshape(B, S, H, N).float()
    g = xg @ p.wg.to(x.dtype)
    w = _decay(p, xw).reshape(B, S, H, N)                         # fp32
    S0 = torch.zeros(B, H, N, N, device=x.device) if state is None \
        else state["S"]
    if S == 1:  # decode fast path, plain torch as in the JAX package
        r0, k0, v0 = r[:, 0], k[:, 0], v[:, 0]
        o = torch.einsum("bhn,bhnm->bhm", r0, S0) + \
            torch.einsum("bhn,hn,bhn,bhm->bhm", r0, p.u_bonus, k0, v0)
        S1 = w[:, 0][..., None] * S0 + torch.einsum("bhn,bhm->bhnm", k0, v0)
        o = o[:, None]                                            # (B,1,H,N)
    else:
        o, S1 = rwkv_ops.wkv_chunked(r, k, v, w, p.u_bonus, S0, chunk=CHUNK)
    out = _group_norm(o.reshape(B, S, H * N).to(x.dtype), p.gn_scale, H, N)
    out = out * xla_silu(g, train)
    if state is not None:
        state["S"].copy_(S1)
        state["x_prev"].copy_(x[:, -1])
    return out @ p.wo.to(x.dtype)


def channel_mix(p: RWKV6Mix, x, state: Optional[dict] = None,
                train: bool = False):
    """x (B, S, D) -> (B, S, D); ``state['x_prev_cm']`` (B, D) updated in
    place when given. ``train``: the bf16 logistic in XLA's order
    (``layers.XlaSigmoid``)."""
    x_prev = _token_shift(x, None if state is None else state["x_prev_cm"])
    dx = x_prev - x
    xk = x + dx * p.mu_cm_k.to(x.dtype)
    xr = x + dx * p.mu_cm_r.to(x.dtype)
    kk = torch.square(torch.relu(xk @ p.w_in.to(x.dtype)))
    rr = xla_sigmoid(xr @ p.w_recept.to(x.dtype), train)
    if state is not None:
        state["x_prev_cm"].copy_(x[:, -1])
    return rr * (kk @ p.w_out.to(x.dtype))
