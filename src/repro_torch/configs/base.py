"""Config dataclasses, the port's own copy of ``repro.configs.base``.

Only what the ported paths read: ``ModelConfig`` and ``reduce_for_smoke``
(every family of the JAX package), and the privacy, mesh, optimizer and
run configs of the training path. The shape configs come with the slice
that uses them.
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
    mrope: bool = False  # qwen2-vl multi-axis RoPE (position ids supplied)
    causal: bool = True  # False => encoder-only (hubert)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25  # smoke configs use dropless (=E)
    # SSM / RWKV / Mamba2
    ssm_state: int = 0
    rwkv_head_size: int = 64
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_headdim: int = 64
    # hybrid (zamba2): one *shared* attention block applied every
    # `attn_every` mamba layers
    attn_every: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: str = "none"  # none | patches | frames
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
    if cfg.is_moe():
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  moe_capacity_factor=4.0)  # dropless: exact-match tests
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, rwkv_head_size=16, mamba_headdim=16)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Privacy (the paper's knobs), mesh, optimizer, run


@dataclass(frozen=True)
class PrivacyConfig:
    enabled: bool = True
    sigma: float = 1.0  # noise multiplier (of C)
    clip_bound: float = 1.0  # C; initial bound when dynamic
    clip_mode: str = "per_silo"  # the fused tier clips per silo
    dynamic_clip: bool = False
    clip_percentile: float = 0.5  # r, paper section 4.3
    clip_percentile_max: float = 4.0  # fixed upper bound on C
    noise_lambda: float = 0.0  # lambda, section 4.4 noise correction ([0,1))
    delta: float = 1e-5
    mask_mode: str = "pairwise"  # admin | pairwise | none
    mask_scale: float = 8.0  # B/(sigma C): spread of the zero-sum r-terms
    mask_ring: bool = False  # read by neither package's step
    sync_path: str = "fused"  # fused | barrier
    silo_mode: str = "vmap"  # vmap | scan (silo-serial, one accumulator)
    n_silos: int = 0  # 0 = auto (vmap: mesh silo count; scan: 4 data owners)


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh, as far as the silo count reads it. The port runs on
    one card, so the default mesh is one data slot; the barrier tier runs a
    mesh's silos one after another on that card (``MeshConfig((4,),
    ("data",))`` is four silos, as on a 4-device JAX mesh)."""

    shape: tuple = (1,)
    axes: tuple = ("data",)

    @property
    def silo_axes(self) -> tuple:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def n_silos(self) -> int:
        n = 1
        for a, s in zip(self.axes, self.shape):
            if a in self.silo_axes:
                n *= s
        return n


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # sgd | momentum | adamw
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_accum: int = 1


@dataclass(frozen=True)
class RunConfig:
    """What the training path reads of the JAX package's ``RunConfig``."""

    model: ModelConfig
    mesh: MeshConfig = MeshConfig()
    privacy: PrivacyConfig = PrivacyConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
