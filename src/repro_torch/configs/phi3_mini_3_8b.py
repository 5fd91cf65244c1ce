"""phi3-mini-3.8b — dense 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    rope=True,
    rope_theta=10_000.0,
    citation="arXiv:2404.14219",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=4)
