"""phi3.5-moe-42b-a6.6b — moe 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    rope=True,
    rope_theta=10_000.0,
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=2)
