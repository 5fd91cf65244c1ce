"""qwen3-moe-235b-a22b — moe 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    rope=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=2, n_experts=8, top_k=2)
