"""Decoder / encoder transformer stack of the dense, MoE, VLM and audio
encoder families: init, the training forward and loss, forward over a dense
KV cache (prefill / decode) and the paged serving step. Port of
``repro/models/transformer.py``.

The JAX package stacks every layer's weights on a leading axis and scans
over it, returning new caches and pools. The port keeps one ``Block`` per
layer in an ``nn.ModuleList``, loops over layers in Python, and writes the
caches and the ``(L, N, P, Hkv, D)`` page pools IN PLACE (where the JAX
scheduler donates its pools to the jitted step, ``scheduler.py:168``).

``models/packing.py`` names every weight by its JAX path
(``layers.attn.wq`` is the list of the layers' ``wq``) and moves the weights
into one packed fp32 buffer, for this family as for the others.

A layer holds a SwiGLU ``ffn``, or an ``moe`` in the MoE family, whose
load-balance term the loss adds at ``AUX_LOSS_WEIGHT``.

The training forward (``loss_fn``) in bf16 rounds where XLA rounds on the
JAX package's jitted training step, which is not everywhere torch does:
the second norm of a layer reads the residual sum ``x + h`` in fp32,
unrounded (XLA fuses the add into the norm's widening, while the residual
stream itself is rounded to bf16), and the SiLU rounds after each of its
ops (``layers.XlaSilu``). Embeddings are cast, then gathered, as in JAX,
so the embedding gradient adds repeated tokens in bf16. Serving keeps the
plain order (one add, ``F.silu``). ``loss_fn`` takes JAX's two training
switches (``repro/models/transformer.py:87-131``): ``use_flash`` attends
through the flash kernels (``attention.attn_apply``), and ``remat``
recomputes each layer in the backward (``torch.utils.checkpoint``, as
``jax.checkpoint`` wraps the scanned layer), keeping only the layers'
inputs. The VLM and the
encoder read the JAX package's batch keys: ``embeds`` (B, S, D), the
precomputed output of the modality frontend it stubs, in place of
``tokens``, and ``positions``, (B, S) or M-RoPE's (3, B, S).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (RMSNorm, SwiGLU, _param,
                                       chunked_lm_loss, dense_init,
                                       embed_init, rmsnorm, swiglu_apply)

FAMILIES = ("dense", "moe", "vlm", "encoder")
AUX_LOSS_WEIGHT = 0.01


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device, dtype)
        self.attn = attn.Attention(cfg, device, dtype, gen)
        self.ln2 = RMSNorm(cfg.d_model, device, dtype)
        if cfg.is_moe():
            self.moe = moe_mod.MoE(cfg, device, dtype, gen)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, device, dtype, gen)


def _ffn_apply(blk: Block, y, cfg: ModelConfig, train: bool = False):
    """The layer's FFN on y: (output, aux), aux the MoE load-balance term
    (0 for a SwiGLU layer, with no launch: the dense serving step is
    host-bound). ``train``: the training forward's SiLU order."""
    if cfg.is_moe():
        return moe_mod.moe_apply(blk.moe, y, cfg, cfg.moe_capacity_factor,
                                 train)
    return swiglu_apply(blk.ffn, y, train), 0.0


class Transformer(nn.Module):
    """The weights of a transformer family (dense, moe, vlm, encoder).
    ``gen=None`` allocates the shapes only (for ``models.convert``);
    otherwise they are drawn from ``gen``."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
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


def _layer_apply(blk: Block, x, cfg: ModelConfig, positions, cache, layer,
                 train: bool = False, use_flash: bool = False):
    h = attn.attn_apply(blk.attn, rmsnorm(blk.ln1.scale, x), cfg, positions,
                        cache, layer, use_flash)
    if train and x.dtype == torch.bfloat16:
        # XLA's order: the norm widens the unrounded fp32 sum
        y = rmsnorm(blk.ln2.scale, x.float() + h.float()).to(x.dtype)
        x = x + h
    else:
        x = x + h
        y = rmsnorm(blk.ln2.scale, x)
    f, aux = _ffn_apply(blk, y, cfg, train)
    return x + f, aux


def _embed_inputs(params: Transformer, tokens, embeds, compute_dtype):
    if embeds is not None:  # modality frontend stub (vlm / audio)
        return embeds.to(compute_dtype)
    return params.embed.to(compute_dtype)[tokens]


def _forward(params: Transformer, cfg: ModelConfig, tokens, cache,
             compute_dtype, embeds=None, positions=None, train=False,
             use_flash=False, remat=False):
    """The final-norm hidden states (B, S, D) and the summed aux term.
    ``train``: the training forward's bf16 order (the module docstring);
    ``use_flash`` and ``remat`` as ``loss_fn``'s (which passes no
    cache)."""
    x = _embed_inputs(params, tokens, embeds, compute_dtype)
    B, S, _ = x.shape
    offset = 0 if cache is None else cache["len"]
    if positions is None:
        positions = (offset + torch.arange(S, device=x.device))[None] \
            .expand(B, S)
    aux = 0.0
    remat = remat and torch.is_grad_enabled()
    for layer, blk in enumerate(params.layers):
        args = (blk, x, cfg, positions, cache, layer, train, use_flash)
        # no layer draws random numbers: no RNG state to carry
        x, a = (checkpoint(_layer_apply, *args, use_reentrant=False,
                           preserve_rng_state=False) if remat
                else _layer_apply(*args))
        aux = aux + a
    if cache is not None:
        cache["len"] = offset + S
    return rmsnorm(params.ln_f.scale, x), aux


def forward(params: Transformer, cfg: ModelConfig, tokens,
            cache: Optional[dict] = None, compute_dtype=torch.float32,
            logits_mode: str = "all", *, embeds=None, positions=None):
    """Tokens (B, S), or ``embeds`` (B, S, D) with ``tokens=None``, through
    the stack: without a cache (training), or over the dense cache, which is
    updated in place (``cache['len']`` advances by S). ``positions`` (B, S)
    or (3, B, S) default to ``len + arange(S)``. Returns logits (B, S, V)
    for ``logits_mode="all"``, (B, 1, V) for ``"last"``, and the final-norm
    hidden states (B, S, D) for ``"hidden"``."""
    x, _ = _forward(params, cfg, tokens, cache, compute_dtype, embeds,
                    positions)
    if logits_mode == "hidden":
        return x
    if logits_mode == "last":
        x = x[:, -1:]
    return x @ params.head().to(x.dtype)


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict,
            compute_dtype=torch.float32, use_flash: bool = False,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``{'tokens' or 'embeds', 'labels'
    (B, S), 'positions'?}``, plus ``AUX_LOSS_WEIGHT`` times the summed
    load-balance term in the MoE family. ``use_flash``: attention through
    the flash kernels; ``remat``: each layer recomputed in the backward."""
    hidden, aux = _forward(params, cfg, batch.get("tokens"), None,
                           compute_dtype, batch.get("embeds"),
                           batch.get("positions"), train=True,
                           use_flash=use_flash, remat=remat)
    loss = chunked_lm_loss(hidden, params.head(), batch["labels"])
    if cfg.is_moe():
        loss = loss + AUX_LOSS_WEIGHT * aux
    return loss


def prefill(params, cfg: ModelConfig, tokens, cache, compute_dtype=torch.float32,
            *, embeds=None, positions=None):
    """Last-position logits (B, V) of a prompt run on an empty cache: tokens
    (B, S), or ``embeds`` (B, S, D) and ``positions`` (B, S) or (3, B, S)
    as in ``forward``."""
    return forward(params, cfg, tokens, cache, compute_dtype, "last",
                   embeds=embeds, positions=positions)[:, 0]


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
    return x + _ffn_apply(blk, rmsnorm(blk.ln2.scale, x), cfg)[0]


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
    ``"all"`` returns (B, C, V) logits at every chunk position.

    An MoE layer routes all B * C rows, inactive slots and padding
    included, as the JAX package does: they count against the experts'
    capacity."""
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
