"""hubert-xlarge — audio encoder-only 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (target codebook).  [arXiv:2106.07447; unverified]

Backbone only; the waveform conv frontend is a stub: a batch carries
precomputed frame embeddings (``embeds``). Encoder-only: no decode step.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    rope=False,
    causal=False,
    frontend="frames",
    citation="arXiv:2106.07447",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=4)
