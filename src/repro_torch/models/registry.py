"""``build_model(cfg)`` returns a ``Model`` whose functions close over the
config, the device and the compute dtype. Port of ``repro/models/registry.py``
for every family: the transformer families (dense, moe, vlm, encoder), ssm
(RWKV-6) and hybrid (zamba2).

  loss(params, {'tokens', 'labels'})       -> mean next-token loss (scalar)
       (vlm / encoder: {'embeds' (B, S, D), 'labels', 'positions'?})
  prefill(params, tokens (B, S), cache)    -> logits (B, V); cache in place
       (transformer families: embeds= / positions= keywords, as forward)
  decode_step(params, tokens (B, 1), cache) -> logits (B, V); cache in place
  paged_step(params, tokens (B, C), pool, tables, q_start, n_valid,
             logits_mode="last") -> (logits, pool); pool in place

The ssm and hybrid families serve over a recurrent state (their ``cache``):
``prefill`` is ``decode_step`` over the whole prompt, as in the JAX
package, which runs the WKV or SSD scan. They have no paged path
(``init_paged_cache`` and ``paged_step`` are None, so continuous batching
refuses them). They train as the dense family does: ``loss`` runs the
scan through its ``autograd.Function`` (``kernels/rwkv6/ops.WKV``,
``kernels/mamba2/ops.SSD``), whose backward is a hand-written reverse scan
on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, rwkv_stack, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_paged_cache: Optional[Callable[..., Any]] = None
    paged_step: Optional[Callable[..., Any]] = None
    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


def build_model(cfg: ModelConfig, device, param_dtype=torch.float32,
                compute_dtype=torch.float32, remat: bool = False,
                use_flash: bool = False) -> Model:
    """JAX's ``build_model`` (``repro/models/registry.py:41-77``) on
    ``device``. ``remat`` and ``use_flash`` reach ``loss`` family by family
    as JAX's do: the ssm family takes ``remat`` only (it has no
    attention); the hybrid's shared block and every transformer layer
    attend through the flash kernels under ``use_flash``."""
    device = torch.device(device)
    cd = compute_dtype
    if cfg.family in ("ssm", "hybrid"):
        mod = rwkv_stack if cfg.family == "ssm" else hybrid

        def init_cache(batch, max_len):
            if cfg.family == "ssm":
                return rwkv_stack.init_state(cfg, batch, device, param_dtype)
            return hybrid.init_state(cfg, batch, max_len, device, cd)

        if cfg.family == "ssm":
            loss = lambda p, batch: rwkv_stack.loss_fn(  # noqa: E731
                p, cfg, batch, cd, remat=remat)
        else:
            loss = lambda p, batch: hybrid.loss_fn(  # noqa: E731
                p, cfg, batch, cd, remat=remat, use_flash=use_flash)
        step = lambda p, toks, c: mod.decode_step(p, cfg, toks, c, cd)
        return Model(cfg=cfg, device=device,
                     init=lambda gen: mod.init(gen, cfg, device, param_dtype),
                     loss=loss,
                     init_cache=init_cache, prefill=step,
                     decode_step=step, compute_dtype=cd,
                     param_dtype=param_dtype)
    if cfg.family not in transformer.FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")

    def paged_step(p, tokens, pool, tables, q_start, n_valid,
                   logits_mode="last"):
        logits = transformer.forward_paged(p, cfg, tokens, pool, tables,
                                           q_start, n_valid, cd, logits_mode)
        return logits, pool

    return Model(
        cfg=cfg, device=device,
        init=lambda gen: transformer.init(gen, cfg, device, param_dtype),
        loss=lambda p, batch: transformer.loss_fn(p, cfg, batch, cd,
                                                  use_flash, remat),
        init_cache=lambda batch, max_len: transformer.init_cache(
            cfg, batch, max_len, device, cd),
        prefill=lambda p, toks, c, **kw: transformer.prefill(p, cfg, toks, c,
                                                             cd, **kw),
        decode_step=lambda p, toks, c: transformer.decode_step(p, cfg, toks,
                                                               c, cd),
        init_paged_cache=lambda n_pages, page_size: transformer.init_paged_cache(
            cfg, n_pages, page_size, device, cd),
        paged_step=paged_step,
        compute_dtype=cd,
        param_dtype=param_dtype,
    )
