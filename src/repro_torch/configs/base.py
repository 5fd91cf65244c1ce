"""Model config dataclass, the port's own copy of ``repro.configs.base``.

Only what the ported (dense) family reads: ``ModelConfig`` and
``reduce_for_smoke``. The fields of the MoE, SSM and hybrid families, and
the shape, mesh, privacy and run configs, come with the slices that use
them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention / embedding options
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 1_000_000.0
    rope_pct: float = 1.0  # fraction of d_head that rotates
    mrope: bool = False  # qwen2-vl multi-axis RoPE (not ported yet)
    causal: bool = True  # False => encoder-only
    tie_embeddings: bool = False
    # MoE (not ported yet; is_moe() reads it)
    n_experts: int = 0
    top_k: int = 0
    citation: str = ""

    @property
    def attn_inner(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_inner(self) -> int:
        return self.n_kv_heads * self.d_head

    def is_moe(self) -> bool:
        return self.n_experts > 0


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family: few layers, tiny width, small vocab."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
