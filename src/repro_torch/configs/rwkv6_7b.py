"""rwkv6-7b — ssm (attention-free) 32L d_model=4096 d_ff=14336 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / rwkv_head_size
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab_size=65536,
    rope=False,
    rwkv_head_size=64,
    citation="arXiv:2404.05892",
)

SMOKE = reduce_for_smoke(CONFIG, n_heads=4, n_kv_heads=4, d_head=16)
