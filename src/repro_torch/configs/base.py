"""Config dataclasses, the port's own copy of ``repro.configs.base``.

``ModelConfig`` and ``reduce_for_smoke`` (every family of the JAX
package), JAX's parameter counts (``param_count``, ``active_param_count``:
its formulas, which the dry run's records report as ``params_B``), the
input-shape cells (``ShapeConfig``, ``SHAPES``, ``shape_applicability``,
``applicable_shapes``), and the privacy, mesh, optimizer and run configs of
the training path.
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

    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "encoder", "hybrid")

    def subquadratic(self) -> bool:
        """True if the arch supports O(S) decode state growth *and* the
        long-context shape (SSM / linear-attn / hybrid)."""
        return self.family in ("ssm", "hybrid")


def _per_layer_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter count of one block (no embeddings): JAX's
    formula (``repro/configs/base.py:82-119``), an estimate for the ssm and
    hybrid families (their modules hold other counts: the dry run's bytes
    come from the weights' shapes, never from this)."""
    d = cfg.d_model
    if cfg.family == "ssm":  # RWKV6
        tm = 5 * d * d + 4 * d  # r,k,v,g,output + per-channel decay/first
        lora = 6 * (d * 64 + 64 * d)  # data-dependent w/x lora (rank 64)
        cm = d * cfg.d_ff + cfg.d_ff * d
        p = tm + lora + cm + 4 * d  # + norms
        return p, p
    attn = d * cfg.attn_inner + 2 * d * cfg.kv_inner + cfg.attn_inner * d
    if cfg.qkv_bias:
        attn += cfg.attn_inner + 2 * cfg.kv_inner
    norms = 2 * d
    if cfg.family == "hybrid":
        d_in = cfg.mamba_expand * d
        nh = d_in // cfg.mamba_headdim
        mamba = (
            d * (2 * d_in + 2 * cfg.ssm_state + nh)  # in_proj -> x,z,B,C,dt
            + cfg.mamba_conv * (d_in + 2 * cfg.ssm_state)  # conv1d
            + nh * 2  # A_log, D
            + d_in * d  # out_proj
            + 2 * d
        )
        # the shared attention block amortized over attn_every layers
        shared = attn + 3 * d * cfg.d_ff + norms
        p = mamba + shared // max(cfg.attn_every, 1) if cfg.attn_every \
            else mamba
        return p, p
    if cfg.is_moe():
        ffn_tot = cfg.n_experts * 3 * d * cfg.d_ff + d * cfg.n_experts
        ffn_act = cfg.top_k * 3 * d * cfg.d_ff + d * cfg.n_experts
    else:
        ffn_tot = ffn_act = 3 * d * cfg.d_ff  # SwiGLU: gate, up, down
    return attn + ffn_tot + norms, attn + ffn_act + norms


def param_count(cfg: ModelConfig) -> int:
    per, _ = _per_layer_params(cfg)
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return cfg.n_layers * per + emb + head + cfg.d_model  # + final norm


def active_param_count(cfg: ModelConfig) -> int:
    _, act = _per_layer_params(cfg)
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return cfg.n_layers * act + emb + head + cfg.d_model


# ---------------------------------------------------------------------------
# Shapes (JAX's input-shape cells: seq_len x global_batch)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicability(cfg: ModelConfig,
                        shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason if not), with JAX's reasons."""
    if not cfg.causal and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, ("long_500k needs sub-quadratic attention "
                       "(pure full-attention arch)")
    return True, ""


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    return [s for s in SHAPES.values() if shape_applicability(cfg, s)[0]]


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
    """What the training path reads of the JAX package's ``RunConfig``;
    ``shape`` is stored as JAX's ``Session`` stores it, and read by
    neither train nor serve (nor JAX's)."""

    model: ModelConfig
    shape: ShapeConfig = SHAPES["train_4k"]
    mesh: MeshConfig = MeshConfig()
    privacy: PrivacyConfig = PrivacyConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
