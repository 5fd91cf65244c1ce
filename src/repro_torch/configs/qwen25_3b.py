"""qwen2.5-3b — dense 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias, untied head. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_head=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=2)
