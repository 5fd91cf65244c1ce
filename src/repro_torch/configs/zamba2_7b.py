"""zamba2-7b — hybrid 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

Modeled as 81 Mamba2 layers with one *shared* (parameter-tied) attention+MLP
block invoked every ``attn_every`` layers (Zamba2's shared transformer block).
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    mamba_expand=2,
    mamba_headdim=64,
    attn_every=6,
    rope=True,
    rope_theta=10_000.0,
    citation="arXiv:2411.15242",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=4, attn_every=2)
