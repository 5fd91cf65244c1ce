"""Mamba-2 (SSD) block, used by zamba2-7b. Port of
``repro/models/mamba2.py``.

Per head (head dim P, state N), scalar decay per head:
    h_t = a_t h_{t-1} + (dt_t x_t) outer B_t        h: (P, N)
    y_t = h_t C_t + D x_t
with a_t = exp(A * dt_t), A < 0 learned per head, dt via softplus. A
multi-token step runs the SSD scan (``kernels/mamba2/ops.ssd_chunked``: the
CUDA kernel on the card); a one-token decode step runs the recurrence in
plain torch, as the JAX package does. Training differentiates the scan
through ``ops.SSD`` (on the card its backward is the ``ssd_bwd`` kernel).
With a state (``{'h': (B, nh, P, N), 'conv': (B, K-1, conv_dim)}``, one
layer's views of the stack's state), the state is updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.models.layers import _param, dense_init, xla_silu

CHUNK = 64


def dims(cfg: ModelConfig) -> tuple:
    """(d_inner, heads, head dim P, state N, conv channels)."""
    d_in = cfg.mamba_expand * cfg.d_model
    return (d_in, d_in // cfg.mamba_headdim, cfg.mamba_headdim,
            cfg.ssm_state, d_in + 2 * cfg.ssm_state)


class Mamba2(nn.Module):
    """One Mamba-2 block's weights, named as the JAX package's
    ``mamba2_init`` tree. ``gen=None`` allocates the shapes only."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, _, N, conv_dim = dims(cfg)
        empty = lambda *s: torch.empty(*s, device=device, dtype=dtype)

        def dense(i, o):
            return empty(i, o) if gen is None else \
                dense_init(gen, i, o, device, dtype)

        self.in_proj = _param(dense(d, 2 * d_in + 2 * N + nh))  # z,x,B,C,dt
        self.conv_w = _param(empty(cfg.mamba_conv, conv_dim) if gen is None
                             else (torch.randn(cfg.mamba_conv, conv_dim,
                                               generator=gen, device=device)
                                   * 0.2).to(dtype))
        self.conv_b = _param(torch.zeros(conv_dim, device=device, dtype=dtype))
        self.A_log = _param(torch.log(torch.linspace(1.0, 16.0, nh,
                                                     device=device)))
        self.D = _param(torch.ones(nh, device=device))
        self.dt_bias = _param(torch.zeros(nh, device=device))
        self.gn_scale = _param(torch.ones(d_in, device=device, dtype=dtype))
        self.out_proj = _param(dense(d_in, d))


def _causal_conv(x, w, b, conv_state=None, train: bool = False):
    """Depthwise causal conv. x (B, S, C); w (K, C); conv_state (B, K-1, C)
    or None (zeros). Returns (silu(conv + b), the new conv state);
    ``train``: the bf16 SiLU in XLA's order (``layers.XlaSilu``)."""
    K = w.shape[0]
    pad = torch.zeros_like(x[:, :1]).expand(-1, K - 1, -1) \
        if conv_state is None else conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return xla_silu(out + b.to(x.dtype), train), xp[:, -(K - 1):]


def mamba2_apply(p: Mamba2, x, cfg: ModelConfig,
                 state: Optional[dict] = None, train: bool = False):
    """x (B, S, D) -> (B, S, D); ``state`` updated in place when given.
    ``train``: the training forward's bf16 SiLUs in XLA's order."""
    B, S, D = x.shape
    d_in, nh, P, N, _ = dims(cfg)
    zxbcdt = x @ p.in_proj.to(x.dtype)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * N, nh], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b,
                                 None if state is None else state["conv"],
                                 train)
    xs, Bc, Cc = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)                   # (B, S, nh)
    A = -torch.exp(p.A_log)                                       # (nh,) < 0
    la = A * dt                                                   # log decay
    xh = xs.reshape(B, S, nh, P).float()
    h0 = torch.zeros(B, nh, P, N, device=x.device) if state is None \
        else state["h"]
    if S == 1:  # decode fast path, plain torch as in the JAX package
        a = torch.exp(la[:, 0])
        upd = torch.einsum("bhp,bn->bhpn", xh[:, 0] * dt[:, 0][..., None],
                           Bc[:, 0].float())
        h1 = a[..., None, None] * h0 + upd
        y = torch.einsum("bhpn,bn->bhp", h1, Cc[:, 0].float())[:, None]
    else:
        # xh, Bc and Cc are column slices of the conv output: the kernel
        # takes them contiguous
        y, h1 = ssd_ops.ssd_chunked(xh.contiguous(), dt, la,
                                    Bc.float().contiguous(),
                                    Cc.float().contiguous(), h0, chunk=CHUNK)
    y = y + p.D[None, None, :, None] * xh
    y = y.reshape(B, S, d_in).to(x.dtype)
    # gated RMS norm (Mamba-2 normalizes before out_proj)
    if train and x.dtype == torch.bfloat16:
        y32 = y.float() * xla_silu(z, train).float()
    else:
        y32 = (y * F.silu(z)).float()
    y = (y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True) + 1e-6)
         * p.gn_scale.float()).to(x.dtype)
    if state is not None:
        state["h"].copy_(h1)
        state["conv"].copy_(new_conv)
    return y @ p.out_proj.to(x.dtype)
