"""Zamba2-style hybrid stack: a Mamba-2 backbone and one *shared*
(parameter-tied) attention + SwiGLU block run every ``attn_every`` layers.
Port of ``repro/models/hybrid.py``.

Layer layout for n_layers=81, attn_every=6: 13 groups of [6 Mamba-2 layers
+ the shared block], then 3 trailing Mamba-2 layers. Each invocation of the
shared block has its own KV cache entry (the parameters are tied, the
activations are not). The serving state ``{'h': (L, B, nh, P, N), 'conv':
(L, B, K-1, conv_dim), 'attn_cache': the dense KV cache of n_groups
entries}`` is updated in place. A multi-token step (the prefill) runs the
SSD scan in every Mamba-2 layer and flash attention in every shared block;
it needs an empty cache, as the JAX package assumes.

``loss_fn`` trains the family: the forward without a state, then the
chunked LM loss, as the JAX package's. The shared block attends through
the plain ``attention._sdpa``, or through the flash kernels with
``use_flash``; with ``remat`` each group (its ``attn_every`` Mamba-2
layers and the shared block, not the tail) is recomputed in the backward,
JAX's remat unit (``repro/models/hybrid.py:87-99``). Each Mamba-2 layer's
SSD scan goes through
``kernels/mamba2/ops.SSD`` (the ``ssd`` kernel forward, the ``ssd_bwd``
reverse scan backward on the card). The shared block's weights take
gradient from every call. The JAX tree stacks every ``mamba_layers.*``
leaf and keeps one ``shared.*``; ``models/packing.py`` reads it off the
modules.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (RMSNorm, SwiGLU, _param,
                                       chunked_lm_loss, dense_init,
                                       embed_init, rmsnorm, swiglu_apply)


def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups of ``attn_every`` Mamba-2 layers, trailing layers)."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device, dtype)
        self.mamba = mamba2.Mamba2(cfg, device, dtype, gen)


class SharedBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device, dtype)
        self.attn = attn.Attention(cfg, device, dtype, gen)
        self.ln2 = RMSNorm(cfg.d_model, device, dtype)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device, dtype, gen)


class Hybrid(nn.Module):
    """The hybrid family's weights. ``gen=None`` allocates the shapes only
    (for ``models.convert``); otherwise they are drawn from ``gen``."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_size, cfg.d_model
        empty = lambda *s: torch.empty(*s, device=device, dtype=dtype)
        self.embed = _param(empty(V, d) if gen is None
                            else embed_init(gen, V, d, device, dtype))
        self.mamba_layers = nn.ModuleList(MambaLayer(cfg, device, dtype, gen)
                                          for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device, dtype, gen)
        self.ln_f = RMSNorm(d, device, dtype)
        self.lm_head = _param(empty(d, V) if gen is None
                              else dense_init(gen, d, V, device, dtype))


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=torch.float32) -> Hybrid:
    """Random weights drawn from ``gen`` (a generator on ``device``); the
    draws do not reproduce ``jax.random``."""
    return Hybrid(cfg, device, dtype, gen)


def init_state(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.float32) -> dict:
    g, _ = n_groups(cfg)
    _, nh, P, N, conv_dim = mamba2.dims(cfg)
    L = cfg.n_layers
    return {
        "h": torch.zeros(L, batch, nh, P, N, device=device),
        "conv": torch.zeros(L, batch, cfg.mamba_conv - 1, conv_dim,
                            device=device, dtype=dtype),
        "attn_cache": attn.init_kv_cache(cfg, batch, max_len, g, device,
                                         dtype),
    }


def _shared_apply(p: SharedBlock, x, cfg: ModelConfig, positions,
                  cache=None, entry: int = 0, use_flash: bool = False,
                  train: bool = False):
    """``train`` in bf16: the dense family's XLA order
    (``transformer._layer_apply``): the second norm widens the unrounded
    fp32 residual sum, the FFN's SiLU is ``layers.XlaSilu``."""
    h = attn.attn_apply(p.attn, rmsnorm(p.ln1.scale, x), cfg, positions,
                        cache, entry, use_flash)
    if train and x.dtype == torch.bfloat16:
        y = rmsnorm(p.ln2.scale, x.float() + h.float()).to(x.dtype)
        x = x + h
    else:
        x = x + h
        y = rmsnorm(p.ln2.scale, x)
    return x + swiglu_apply(p.ffn, y, train)


def _mamba_apply(lay: MambaLayer, x, cfg: ModelConfig, st=None,
                 train: bool = False):
    return x + mamba2.mamba2_apply(lay.mamba, rmsnorm(lay.ln.scale, x), cfg,
                                   st, train)


def _group_apply(params: Hybrid, x, cfg: ModelConfig, positions, group: int,
                 use_flash: bool, train: bool = False):
    """One group of the training forward: its ``attn_every`` Mamba-2
    layers, then the shared block (JAX's remat unit)."""
    ae = cfg.attn_every
    for lay in params.mamba_layers[group * ae:(group + 1) * ae]:
        x = _mamba_apply(lay, x, cfg, train=train)
    return _shared_apply(params.shared, x, cfg, positions,
                         use_flash=use_flash, train=train)


def forward(params: Hybrid, cfg: ModelConfig, tokens,
            state: Optional[dict] = None, compute_dtype=torch.float32,
            logits_mode: str = "all", remat: bool = False,
            use_flash: bool = False, train: bool = False):
    """Tokens (B, S) through the stack: without a state (training) or over
    ``state``, updated in place (the KV cache's ``len`` advances by S; the
    positions start there, ``hybrid.py:84-85``). Returns logits as
    ``transformer.forward`` does. Without a state, ``use_flash`` attends
    through the flash kernels and ``remat`` recomputes each group in the
    backward; ``train``: the training forward's bf16 order
    (:func:`_shared_apply`, ``mamba2.mamba2_apply``)."""
    x = params.embed.to(compute_dtype)[tokens]
    B, S, _ = x.shape
    ae = cfg.attn_every
    g, _ = n_groups(cfg)
    cache = None if state is None else state["attn_cache"]
    offset = 0 if cache is None else cache["len"]
    positions = (offset + torch.arange(S, device=x.device))[None].expand(B, S)
    if state is None:
        remat = remat and torch.is_grad_enabled()
        for group in range(g):
            args = (params, x, cfg, positions, group, use_flash, train)
            # no layer draws random numbers: no RNG state to carry
            x = (checkpoint(_group_apply, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else _group_apply(*args))
        for lay in params.mamba_layers[g * ae:]:  # the tail, as JAX: no remat
            x = _mamba_apply(lay, x, cfg, train=train)
    else:
        for i, lay in enumerate(params.mamba_layers):
            x = _mamba_apply(lay, x, cfg, {"h": state["h"][i],
                                           "conv": state["conv"][i]})
            if (i + 1) % ae == 0:  # the end of a group (never in the tail)
                x = _shared_apply(params.shared, x, cfg, positions, cache,
                                  (i + 1) // ae - 1)
        cache["len"] = offset + S
    x = rmsnorm(params.ln_f.scale, x)
    if logits_mode == "hidden":
        return x
    if logits_mode == "last":
        x = x[:, -1:]
    return x @ params.lm_head.to(x.dtype)


def loss_fn(params: Hybrid, cfg: ModelConfig, batch: dict,
            compute_dtype=torch.float32, remat: bool = False,
            use_flash: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``{'tokens', 'labels': (B, S)}``
    (``repro/models/hybrid.py:149-152``)."""
    hidden = forward(params, cfg, batch["tokens"], None, compute_dtype,
                     logits_mode="hidden", remat=remat, use_flash=use_flash,
                     train=True)
    return chunked_lm_loss(hidden, params.lm_head, batch["labels"])


def decode_step(params: Hybrid, cfg: ModelConfig, tokens, state,
                compute_dtype=torch.float32):
    """Logits (B, V) at the last of ``tokens`` (B, S); S > 1 is the
    prefill (an empty cache), S == 1 a decode step."""
    return forward(params, cfg, tokens, state, compute_dtype, "last")[:, 0]
