"""qwen2-vl-72b — vlm 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only; the vision frontend is a stub: a batch carries precomputed
patch embeddings (``embeds``) in place of text tokens, and the 3-axis M-RoPE
position ids (``positions``, (3, B, S)) are supplied as inputs.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
    mrope=True,
    frontend="patches",
    citation="arXiv:2409.12191",
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=2)
