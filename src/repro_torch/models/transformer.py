"""Decoder transformer stack, dense family: init, the training forward and
loss, forward over a dense KV cache (prefill / decode) and the paged serving
step. Port of ``repro/models/transformer.py``.

The JAX package stacks every layer's weights on a leading axis and scans
over it, returning new caches and pools. The port keeps one ``Block`` per
layer in an ``nn.ModuleList``, loops over layers in Python, and writes the
caches and the ``(L, N, P, Hkv, D)`` page pools IN PLACE (where the JAX
scheduler donates its pools to the jitted step, ``scheduler.py:168``).

``models/packing.py`` names every weight by its JAX path
(``layers.attn.wq`` is the list of the layers' ``wq``) and moves the weights
into one packed fp32 buffer, for this family as for the others.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (RMSNorm, SwiGLU, _param,
                                       chunked_lm_loss, dense_init,
                                       embed_init, rmsnorm, swiglu_apply)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device, dtype)
        self.attn = attn.Attention(cfg, device, dtype, gen)
        self.ln2 = RMSNorm(cfg.d_model, device, dtype)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device, dtype, gen)


class Transformer(nn.Module):
    """The dense decoder's weights. ``gen=None`` allocates the shapes only
    (for ``models.convert``); otherwise they are drawn from ``gen``."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only); see "
                f"ROADMAP.md queue 1, 'Other model families'")
        self.cfg = cfg
        V, d = cfg.vocab_size, cfg.d_model
        empty = lambda *s: torch.empty(*s, device=device, dtype=dtype)
        self.embed = _param(empty(V, d) if gen is None
                            else embed_init(gen, V, d, device, dtype))
        self.layers = nn.ModuleList(Block(cfg, device, dtype, gen)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(d, device, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param(empty(d, V) if gen is None
                                  else dense_init(gen, d, V, device, dtype))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


@dataclass(frozen=True)
class EarlyExit:
    """The weights of an early-exit draft: the first layers of a
    ``Transformer`` with its embedding, final norm and head. Every tensor is
    the target's own, so the draft costs no memory, and the target keeps
    all its layers (assigning ``layers`` on a ``copy.copy`` of the module
    would truncate the target through the shared ``_modules`` dict)."""

    embed: torch.Tensor
    layers: tuple
    ln_f: RMSNorm
    head: Callable[[], torch.Tensor]


def early_exit(params: Transformer, n_layers: int) -> EarlyExit:
    """The draft weights of ``params``' first ``n_layers`` layers."""
    return EarlyExit(params.embed, tuple(params.layers)[:n_layers],
                     params.ln_f, params.head)


def init(gen: torch.Generator, cfg: ModelConfig, device,
         dtype=torch.float32) -> Transformer:
    """Random weights drawn from ``gen`` (a generator on ``device``). The
    draws do not reproduce ``jax.random``: weights cross from JAX through
    ``models.convert.params_from_jax``."""
    return Transformer(cfg, device, dtype, gen)


def _layer_apply(blk: Block, x, cfg: ModelConfig, positions, cache, layer):
    x = x + attn.attn_apply(blk.attn, rmsnorm(blk.ln1.scale, x), cfg,
                            positions, cache, layer)
    return x + swiglu_apply(blk.ffn, rmsnorm(blk.ln2.scale, x))


def forward(params: Transformer, cfg: ModelConfig, tokens,
            cache: Optional[dict] = None, compute_dtype=torch.float32,
            logits_mode: str = "all"):
    """Tokens (B, S) through the stack: without a cache (training), or over
    the dense cache, which is updated in place (``cache['len']`` advances by
    S). Returns logits (B, S, V) for ``logits_mode="all"``, (B, 1, V) for
    ``"last"``, and the final-norm hidden states (B, S, D) for
    ``"hidden"``."""
    x = params.embed.to(compute_dtype)[tokens]
    B, S, _ = x.shape
    offset = 0 if cache is None else cache["len"]
    positions = (offset + torch.arange(S, device=x.device))[None].expand(B, S)
    for layer, blk in enumerate(params.layers):
        x = _layer_apply(blk, x, cfg, positions, cache, layer)
    if cache is not None:
        cache["len"] = offset + S
    x = rmsnorm(params.ln_f.scale, x)
    if logits_mode == "hidden":
        return x
    if logits_mode == "last":
        x = x[:, -1:]
    return x @ params.head().to(x.dtype)


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Mean next-token cross-entropy of ``{'tokens', 'labels': (B, S)}``."""
    hidden = forward(params, cfg, batch["tokens"], None, compute_dtype,
                     logits_mode="hidden")
    return chunked_lm_loss(hidden, params.head(), batch["labels"])


def prefill(params, cfg: ModelConfig, tokens, cache, compute_dtype=torch.float32):
    """Last-position logits (B, V) of a prompt (B, S) run on an empty cache."""
    return forward(params, cfg, tokens, cache, compute_dtype, "last")[:, 0]


def decode_step(params, cfg: ModelConfig, tokens, cache,
                compute_dtype=torch.float32):
    """Logits (B, V) of one new token per row, tokens (B, 1)."""
    return forward(params, cfg, tokens, cache, compute_dtype, "last")[:, 0]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.float32) -> dict:
    return attn.init_kv_cache(cfg, batch, max_len, cfg.n_layers, device, dtype)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, device,
                     dtype=torch.float32) -> dict:
    return attn.init_paged_pool(cfg, n_pages, page_size, cfg.n_layers, device,
                                dtype)


def layer_apply_paged(blk: Block, x, cfg: ModelConfig, positions, k_pages,
                      v_pages, tables, q_start, rows):
    """One layer of a paged step; this layer's pools are written in place."""
    x = x + attn.attn_apply_paged(blk.attn, rmsnorm(blk.ln1.scale, x), cfg,
                                  positions, k_pages, v_pages, tables,
                                  q_start, rows)
    return x + swiglu_apply(blk.ffn, rmsnorm(blk.ln2.scale, x))


def forward_paged(params, cfg: ModelConfig, tokens, pages: dict,
                  tables, q_start, n_valid, compute_dtype=torch.float32,
                  logits_mode: str = "last"):
    """One serving step over the paged pool: C new tokens per slot (C > 1 is
    a prefill chunk, C == 1 decode). ``params`` is a ``Transformer`` or an
    ``EarlyExit`` draft of one.

    tokens (B, C) int; tables (B, nP) int32; q_start (B,) int32 tokens
    already cached per slot; n_valid (B,) how many of the C are real (0 =
    inactive slot: its row computes a finite average of its pages and
    writes nothing). The pools in ``pages`` are updated in place.

    ``"last"`` returns (B, V) logits of each slot's last valid token;
    ``"all"`` returns (B, C, V) logits at every chunk position."""
    x = params.embed.to(compute_dtype)[tokens]
    B, C = tokens.shape
    positions = q_start.long()[:, None] + torch.arange(C, device=x.device)[None]
    P = pages["k_pages"].shape[2]
    rows = attn.paged_write_rows(tables, q_start, n_valid, C, P)
    for layer, blk in enumerate(params.layers):
        x = layer_apply_paged(blk, x, cfg, positions, pages["k_pages"][layer],
                              pages["v_pages"][layer], tables, q_start, rows)
    x = rmsnorm(params.ln_f.scale, x)
    head = params.head().to(x.dtype)
    if logits_mode == "all":
        return x @ head                                          # (B, C, V)
    last = torch.clamp(n_valid.long() - 1, 0, C - 1)             # (B,)
    x = x[torch.arange(B, device=x.device), last]                # (B, D)
    return x @ head
