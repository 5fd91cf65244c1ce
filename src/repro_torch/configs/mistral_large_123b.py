"""mistral-large-123b — dense 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    rope=True,
    rope_theta=1_000_000.0,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=2)
