"""RWKV-6 full LM stack (attention-free): layernorms as in the reference
implementation, and a recurrent state for serving. Port of
``repro/models/rwkv_stack.py``.

The JAX package stacks the blocks' weights and scans over them; the port
keeps one ``RWKVBlock`` per layer in an ``nn.ModuleList`` and loops in
Python. The serving state ``{'S': (L, B, H, N, N), 'x_prev', 'x_prev_cm':
(L, B, D), 'len': int}`` is updated in place, layer ``l`` through its
``[l]`` views. A multi-token step (the wave scheduler's prefill, and
training) runs the WKV scan; a one-token step the plain recurrence.

``loss_fn`` trains the family: the forward without a state, then the
chunked LM loss, as the JAX package's; with ``remat`` each block is
recomputed in the backward (``repro/models/rwkv_stack.py:66-72``). Its WKV
scan goes through
``kernels/rwkv6/ops.WKV`` (the ``wkv`` kernel forward, the ``wkv_bwd``
reverse scan backward on the card). The JAX tree stacks every
``layers.*`` leaf; ``models/packing.py`` reads it off the modules.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6
from repro_torch.models.layers import (LayerNorm, _param, chunked_lm_loss,
                                       dense_init, embed_init, layernorm)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device, dtype)
        self.mix = rwkv6.RWKV6Mix(cfg, device, dtype, gen)
        self.ln2 = LayerNorm(cfg.d_model, device, dtype)


class RWKVStack(nn.Module):
    """The ssm family's weights. ``gen=None`` allocates the shapes only
    (for ``models.convert``); otherwise they are drawn from ``gen``."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_size, cfg.d_model
        empty = lambda *s: torch.empty(*s, device=device, dtype=dtype)
        self.embed = _param(empty(V, d) if gen is None
                            else embed_init(gen, V, d, device, dtype))
        self.ln_in = LayerNorm(d, device, dtype)
        self.layers = nn.ModuleList(RWKVBlock(cfg, device, dtype, gen)
                                    for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, device, dtype)
        self.lm_head = _param(empty(d, V) if gen is None
                              else dense_init(gen, d, V, device, dtype))


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=torch.float32) -> RWKVStack:
    """Random weights drawn from ``gen`` (a generator on ``device``); the
    draws do not reproduce ``jax.random``."""
    return RWKVStack(cfg, device, dtype, gen)


def init_state(cfg: ModelConfig, batch: int, device,
               dtype=torch.float32) -> dict:
    H, N, D, L = cfg.n_heads, cfg.rwkv_head_size, cfg.d_model, cfg.n_layers
    z = lambda *s, dt=dtype: torch.zeros(*s, device=device, dtype=dt)
    return {"S": z(L, batch, H, N, N, dt=torch.float32),
            "x_prev": z(L, batch, D), "x_prev_cm": z(L, batch, D),
            "len": 0}  # a host int, as the dense cache's


def block_apply(blk: RWKVBlock, x, cfg: ModelConfig,
                state: Optional[dict] = None, train: bool = False):
    """``train`` in bf16: XLA's order, as the dense family's
    (``transformer._layer_apply``): the second norm widens the unrounded
    fp32 residual sum."""
    h = rwkv6.time_mix(blk.mix, layernorm(blk.ln1, x), cfg, state, train)
    if train and x.dtype == torch.bfloat16:
        y = layernorm(blk.ln2, x.float() + h.float()).to(x.dtype)
        x = x + h
    else:
        x = x + h
        y = layernorm(blk.ln2, x)
    return x + rwkv6.channel_mix(blk.mix, y, state, train)


def forward(params: RWKVStack, cfg: ModelConfig, tokens,
            state: Optional[dict] = None, compute_dtype=torch.float32,
            logits_mode: str = "all", remat: bool = False,
            train: bool = False):
    """Tokens (B, S) through the stack: from zeros (training) or from
    ``state``, updated in place (``state['len']`` advances by S). Returns
    logits (B, S, V), (B, 1, V) for ``"last"``, or the final-norm hidden
    states for ``"hidden"``. ``remat`` (without a state): each block
    recomputed in the backward. ``train``: the training forward's bf16
    order (``rwkv6.time_mix``)."""
    x = layernorm(params.ln_in, params.embed.to(compute_dtype)[tokens])
    remat = remat and state is None and torch.is_grad_enabled()
    for layer, blk in enumerate(params.layers):
        if remat:  # no block draws random numbers: no RNG state to carry
            x = checkpoint(block_apply, blk, x, cfg, None, train,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        st = None if state is None else {
            k: state[k][layer] for k in ("S", "x_prev", "x_prev_cm")}
        x = block_apply(blk, x, cfg, st, train)
    if state is not None:
        state["len"] += tokens.shape[1]
    x = layernorm(params.ln_f, x)
    if logits_mode == "hidden":
        return x
    if logits_mode == "last":
        x = x[:, -1:]
    return x @ params.lm_head.to(x.dtype)


def loss_fn(params: RWKVStack, cfg: ModelConfig, batch: dict,
            compute_dtype=torch.float32, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``{'tokens', 'labels': (B, S)}``
    (``repro/models/rwkv_stack.py:96-99``)."""
    hidden = forward(params, cfg, batch["tokens"], None, compute_dtype,
                     logits_mode="hidden", remat=remat, train=True)
    return chunked_lm_loss(hidden, params.lm_head, batch["labels"])


def decode_step(params: RWKVStack, cfg: ModelConfig, tokens, state,
                compute_dtype=torch.float32):
    """Logits (B, V) at the last of ``tokens`` (B, S); S > 1 is a prefill
    over the whole prompt (the WKV scan), S == 1 a decode step."""
    return forward(params, cfg, tokens, state, compute_dtype, "last")[:, 0]
