"""``build_model(cfg)`` returns a ``Model`` whose functions close over the
config, the device and the compute dtype. Port of ``repro/models/registry.py``
for the dense family; other families raise.

  loss(params, {'tokens', 'labels'})       -> mean next-token loss (scalar)
  prefill(params, tokens (B, S), cache)    -> logits (B, V); cache in place
  decode_step(params, tokens (B, 1), cache) -> logits (B, V); cache in place
  paged_step(params, tokens (B, C), pool, tables, q_start, n_valid,
             logits_mode="last") -> (logits, pool); pool in place
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_paged_cache: Callable[..., Any]
    paged_step: Callable[..., Any]
    compute_dtype: torch.dtype = torch.float32


def build_model(cfg: ModelConfig, device, param_dtype=torch.float32,
                compute_dtype=torch.float32) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only); see "
            f"ROADMAP.md queue 1, 'Other model families'")
    device = torch.device(device)
    cd = compute_dtype

    def paged_step(p, tokens, pool, tables, q_start, n_valid,
                   logits_mode="last"):
        logits = transformer.forward_paged(p, cfg, tokens, pool, tables,
                                           q_start, n_valid, cd, logits_mode)
        return logits, pool

    return Model(
        cfg=cfg, device=device,
        init=lambda gen: transformer.init(gen, cfg, device, param_dtype),
        loss=lambda p, batch: transformer.loss_fn(p, cfg, batch, cd),
        init_cache=lambda batch, max_len: transformer.init_cache(
            cfg, batch, max_len, device, cd),
        prefill=lambda p, toks, c: transformer.prefill(p, cfg, toks, c, cd),
        decode_step=lambda p, toks, c: transformer.decode_step(p, cfg, toks,
                                                               c, cd),
        init_paged_cache=lambda n_pages, page_size: transformer.init_paged_cache(
            cfg, n_pages, page_size, device, cd),
        paged_step=paged_step,
        compute_dtype=cd,
    )
