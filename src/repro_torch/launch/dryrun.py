"""The one-card twin of JAX's dry run (``repro/launch/dryrun.py``): every
(arch x shape) cell built as JAX builds it, planned against one H100's
memory, and, with ``--run``, allocated and stepped once on the card.

    python -m repro_torch.launch.dryrun --all                  # the plan
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape long_500k --run

JAX lowers and compiles each cell on a 256- or 512-chip TPU mesh and reads
``compiled.memory_analysis()`` to prove the cell fits. The port runs on one
card, so its dry run plans: the argument bytes (weights, cache or train
state, batch) come exactly from the meta-device specs of ``launch/specs.py``,
the temporary bytes from the formulas below, and the plan is the largest
batch up to JAX's ``global_batch`` whose total fits the card's 80 GB
(``launch/mesh.HBM_BYTES``). ``seq_len`` is never changed. A cell that fits
at no batch is ``"status": "does_not_fit"``, with the bytes that decided
it. ``--run`` is the port's counterpart of ``memory_analysis()``: it builds
the cell at the planned batch on the card, runs its step once and records
the step's ms and ``torch.cuda.max_memory_allocated`` beside the plan.
``--run`` without a card raises; the plan alone runs anywhere (its specs
allocate nothing).

JAX's record takes its FLOPs and bytes from the compiled step
(``analysis/hlo_cost.py``). The port's takes them from the step counted on
the meta device at the planned batch (``analysis/op_cost.py``: the
products' FLOPs, every op's bytes, each kernel by its own work formula,
one unit of depth times its count; a cell that does not fit is not
counted, its ``hlo_cost`` and ``roofline`` None), under JAX's keys:
``hlo_cost`` and the roofline's ``t_compute_s``, ``t_memory_s``,
``hlo_flops_global``, ``useful_flops_ratio`` and ``roofline_fraction``,
at the card's constants. ``model_flops_global`` stays JAX's ``2 or 6 x
active params x tokens``.

Importing this module does nothing: no device is touched until a cell is
run.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.analysis import op_cost
from repro_torch.configs import (SHAPES, active_param_count, get_config,
                                 param_count, runnable_cells,
                                 shape_applicability)
from repro_torch.configs.base import (MeshConfig, ModelConfig,
                                      OptimizerConfig, PrivacyConfig,
                                      ShapeConfig)
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     mesh_config)

DRYRUN_OUT = BUILD_DIR / "dryrun"
BF16 = torch.bfloat16
# tokens a call of the long prefill that brings rwkv6's state to long_500k's
# depth: one call of 524,288 tokens would make each (1, S, H, 64) scan input
# 2**31 elements
LONG_CHUNK = 32_768
# JAX's dry-run training cell (``dryrun.py:99-105``): the silo-serial scan
# tier over 8 data owners
TRAIN_SILOS = 8
TRAIN_OPTIMIZER = OptimizerConfig(name="adamw")
# what the step's temporaries hold on the card beyond its tensors: cuBLAS's
# workspace, allocated through the caching allocator, and the allocator's
# rounding of each live block (to 2 MiB past 1 MiB); qwen2.5-3b's
# prefill_32k measured 29.3 MB past its tensors on an H100 80GB HBM3
WORKSPACE = 1 << 26


def train_privacy(sync_path: str = "fused") -> PrivacyConfig:
    """JAX's dry-run privacy: sigma 1, per-silo clipping, the scan tier over
    8 silos (``repro/launch/dryrun.py:103-104``)."""
    return PrivacyConfig(enabled=True, sigma=1.0, clip_mode="per_silo",
                         sync_path=sync_path, silo_mode="scan",
                         n_silos=TRAIN_SILOS)


def cell_model(cfg: ModelConfig, device):
    """The model as JAX's dry run builds it (``dryrun.py:91-92``): bf16
    weights and compute, remat and flash attention."""
    from repro_torch.models.registry import build_model

    return build_model(cfg, device, param_dtype=BF16, compute_dtype=BF16,
                       remat=True, use_flash=True)


# ---------------------------------------------------------------------------
# the temporary bytes: what one layer of the serving forward holds at its
# peak, a token, as the port's code allocates it (e: the compute dtype's
# bytes; fp32 intermediates 4). Each term names the tensors it counts.


def _dense_bytes(cfg: ModelConfig, e: int) -> int:
    """A transformer layer (``transformer._layer_apply``; the hybrid's
    shared block, ``hybrid._shared_apply``), the larger of its phases."""
    d, F = cfg.d_model, cfg.d_ff
    A, kv = cfg.attn_inner, cfg.kv_inner
    a_rot = cfg.n_heads * (int(cfg.d_head * cfg.rope_pct) // 2 * 2)
    # attention: the layer's input and its norm, q, k and v, then RoPE on
    # q: x1*cos and x2*sin in fp32 (r1, r2), their stack, its cast and the
    # concatenation; the angles, cos and sin in fp32
    attention = e * (2 * d + A + 2 * kv) + (8 + e) * a_rot + e * A \
        + 8 * (a_rot // cfg.n_heads) if cfg.rope else \
        e * (2 * d + A + 2 * kv) + e * A
    # the second norm: the input, the attention's output, their sum, and
    # the norm's fp32 widening, scaled and multiplied copies and its output
    norm = e * 4 * d + 12 * d
    if cfg.is_moe():
        # the routed FFN at top_k experts a token (gate, up, the SiLU and
        # the product each), beside the same four residual-sized tensors
        ffn = e * 4 * d + cfg.top_k * e * 4 * F
    else:
        # the input, the attention's output, their sum and its norm; the
        # FFN's gate, up, SiLU(gate) and their product
        ffn = e * 4 * d + e * 4 * F
    return max(attention, norm, ffn)


def _mamba2_bytes(cfg: ModelConfig, e: int) -> int:
    """A Mamba-2 layer (``mamba2.mamba2_apply``) at its peak, the gated
    norm: the layer's input and norm, the in-projection, the padded conv
    input (its last K-1 rows are the new conv state, a view) and the conv's
    output, dt and the log decay, xh in fp32 and Bc, Cc in fp32; y in the
    compute dtype, and the gated norm's fp32 product, scaled and multiplied
    copies."""
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    N = cfg.ssm_state
    nh = d_in // cfg.mamba_headdim
    conv_dim = d_in + 2 * N
    return (e * 2 * d + e * (2 * d_in + 2 * N + nh) + 2 * e * conv_dim
            + 8 * nh + 8 * N + 4 * d_in + e * d_in + 12 * d_in)


def _rwkv6_bytes(cfg: ModelConfig, e: int) -> int:
    """An RWKV-6 block (``rwkv_stack.block_apply``) at its peak, the time
    mix's group norm: the block's input and norm, the shifted input, the
    five mixed inputs, r, k, v in fp32, g, the decay w in fp32, the scan's
    output in fp32 and its cast, and the group norm's fp32 widening,
    centred and scaled copies, its head means and variances and its
    output. The channel mix's peak (the residual tensors and two (d_ff)
    products) is the other candidate."""
    d, F = cfg.d_model, cfg.d_ff
    time_mix = e * 11 * d + 32 * d + 8 * cfg.n_heads
    channel_mix = e * 8 * d + e * 2 * F
    return max(time_mix, channel_mix)


def activation_bytes(cfg: ModelConfig, e: int = 2) -> int:
    """The bytes a token that one layer of the serving forward holds at
    its peak (the largest layer kind of the family)."""
    if cfg.family == "ssm":
        return _rwkv6_bytes(cfg, e)
    if cfg.family == "hybrid":
        return max(_mamba2_bytes(cfg, e), _dense_bytes(cfg, e))
    return _dense_bytes(cfg, e)


def state_bytes(cfg: ModelConfig) -> int:
    """The bytes a sequence of one layer's recurrent state in fp32, which
    a scan call writes anew (the WKV state (H, N, N) of rwkv6, the SSD
    state (nh, P, N) of a Mamba-2 layer); 0 without a scan."""
    if cfg.family == "ssm":
        return 4 * cfg.n_heads * cfg.rwkv_head_size ** 2
    if cfg.family == "hybrid":
        nh = cfg.mamba_expand * cfg.d_model // cfg.mamba_headdim
        return 4 * nh * cfg.mamba_headdim * cfg.ssm_state
    return 0


def decode_read_bytes(cfg: ModelConfig, seq_len: int, e: int = 2) -> int:
    """The bytes a sequence that one decode step holds beside its token's
    activations, the larger of: the attention over a ``seq_len``-deep
    dense cache (``attention._sdpa_masked``: the einsum's copy of one
    layer's V in its (b, h) batch layout beside the fp32 scores and their
    bf16 softmax, the same for K beside the einsum's output; or the fp32
    scores, their fill and the masked result), and the recurrence's
    three state-sized fp32 terms (the decayed state, the update, their
    sum)."""
    attention = 0
    if cfg.has_attention():
        attention = max(seq_len * cfg.kv_inner * e
                        + (4 + e) * cfg.n_heads * seq_len,
                        12 * cfg.n_heads * seq_len)
    return max(attention, 3 * state_bytes(cfg))


def _attention_base(cfg: ModelConfig, e: int) -> int:
    """The bytes a token of an attention layer's inputs beside the
    attention: the layer's input and norm, q, k and v."""
    return e * (2 * cfg.d_model + cfg.attn_inner + 2 * cfg.kv_inner)


def serving_temp_bytes(cfg: ModelConfig, shape: ShapeConfig, batch: int,
                       e: int = 2) -> dict:
    """The plan's temporary bytes of a serving step at ``batch``: the
    layer's peak activations over the step's tokens (a decode's the larger
    of those and its cache read, :func:`decode_read_bytes`, beside the
    attention's inputs, and the masks' positions over the cache), a
    prefill's new scan state and its positions (int64), and the last
    position's logits."""
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    act = activation_bytes(cfg, e)
    if shape.kind == "decode":
        read = decode_read_bytes(cfg, shape.seq_len, e)
        base = _attention_base(cfg, e) if read > 3 * state_bytes(cfg) \
            else act
        parts = {"activations_or_read": batch * max(act, base + read),
                 # the masks' key positions (int64) and booleans
                 "cache_positions": 18 * shape.seq_len
                 if cfg.has_attention() else 0}
    else:
        parts = {"activations": batch * s_in * act,
                 "scan_state": batch * state_bytes(cfg),
                 "positions": 8 * s_in}
    parts["logits"] = batch * e * cfg.vocab_size
    return parts


def _layout(params_specs: dict):
    from repro_torch.core import flatbuf

    return flatbuf.layout_of(params_specs)


def train_state_bytes(params_specs: dict) -> dict:
    """The port's train state over ``params_specs`` (``steps.TrainState``):
    the fp32 master, AdamW's m and v, each over the packed layout, and the
    packed bf16 weights (when a leaf is bf16) the parameters view."""
    total = _layout(params_specs).total
    bf16 = any(t.dtype == BF16 for t in params_specs.values())
    return {"master": 4 * total, "adamw_m": 4 * total, "adamw_v": 4 * total,
            "bf16_weights": 2 * total if bf16 else 0}


def train_temp_bytes(cfg: ModelConfig, shape: ShapeConfig, batch: int,
                     params_specs: dict, e: int = 2) -> dict:
    """The scan tier's temporaries at ``batch`` (``steps._fused_grads_scan``
    over ``TRAIN_SILOS`` silos): the fp32 accumulator, one silo's gradient
    tree in the weights' dtypes, and the larger of a leaf's fp32 widening
    as it is added in and the silo's activations under remat: every
    layer's input, beside the larger of the LM loss's saved fp32 logits
    (``chunked_lm_loss``: every 512-token chunk's (V) logits are kept for
    the backward) with two chunks' fp32 temporaries of its backward, and
    one layer recomputed forward and backward (twice the serving peak)."""
    total = _layout(params_specs).total
    grads = specs_mod.nbytes(params_specs)
    widen = 4 * max(math.prod(t.shape) for t in params_specs.values())
    seqs = batch // TRAIN_SILOS
    tokens = seqs * shape.seq_len
    V = cfg.vocab_size
    acts = tokens * cfg.n_layers * e * cfg.d_model + max(
        tokens * 4 * V + seqs * 512 * V * 4 * 2,
        tokens * 2 * activation_bytes(cfg, e))
    return {"accumulator": 4 * total, "silo_grads": grads,
            "activations_or_widen": max(widen, acts)}


# ---------------------------------------------------------------------------
# the plan


def _at_batch(shape: ShapeConfig, batch: int) -> ShapeConfig:
    return dataclasses.replace(shape, global_batch=batch)


@functools.lru_cache(maxsize=None)
def _cell_params(cfg: ModelConfig) -> dict:
    """The cell model's weight specs (built once a config: the plan
    evaluates a cell at several batches)."""
    return specs_mod.params_specs(cell_model(cfg, specs_mod.META))


def cell_bytes(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> dict:
    """Argument and temporary bytes of the cell at ``batch``, part by
    part. Serving: the weights, the cache (``init_cache(batch,
    seq_len)``) and the batch, exactly from their specs. Training: the
    train state and the batch; the temporaries by the formulas above."""
    model = cell_model(cfg, specs_mod.META)
    at = _at_batch(shape, batch)
    params = _cell_params(cfg)
    batch_b = specs_mod.nbytes(specs_mod.batch_specs(cfg, at))
    if shape.kind == "train":
        args = dict(train_state_bytes(params), batch=batch_b)
        temp = train_temp_bytes(cfg, at, batch, params)
    else:
        args = {"params": specs_mod.nbytes(params),
                "cache": specs_mod.nbytes(specs_mod.cache_specs(cfg, at,
                                                                model)),
                "batch": batch_b}
        temp = serving_temp_bytes(cfg, at, batch)
    temp["workspace"] = WORKSPACE
    return {"argument": args, "temp": temp,
            "argument_bytes": sum(args.values()),
            "temp_bytes": sum(temp.values())}


def _step_of(shape: ShapeConfig) -> int:
    return TRAIN_SILOS if shape.kind == "train" else 1


def plan_cell(arch: str, shape_name: str) -> dict:
    """The largest batch up to JAX's ``global_batch`` (a multiple of the
    silo count for a train cell) whose argument and temporary bytes fit
    the card's HBM_BYTES, with those bytes; ``batch`` 0 and the bytes at
    the least batch when none does."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    step = _step_of(shape)

    def fits(b: dict) -> bool:
        return b["argument_bytes"] + b["temp_bytes"] <= HBM_BYTES

    least = cell_bytes(cfg, shape, step)
    if not fits(least):
        return {"batch": 0, "fits": False, **least}
    lo, hi = 1, shape.global_batch // step   # in units of `step`
    while lo < hi:  # the total grows with the batch
        mid = (lo + hi + 1) // 2
        if fits(cell_bytes(cfg, shape, mid * step)):
            lo = mid
        else:
            hi = mid - 1
    return {"batch": lo * step, "fits": True,
            **cell_bytes(cfg, shape, lo * step)}


def counted_cost(cfg: ModelConfig, shape: ShapeConfig,
                 batch: int) -> op_cost.CostSummary:
    """The cell's step counted at ``batch`` (``op_cost.step_cost``; a train
    cell over JAX's ``TRAIN_SILOS`` silos)."""
    return op_cost.step_cost(cfg, shape, batch)


def _roofline(cfg: ModelConfig, shape: ShapeConfig, batch: int,
              cost: op_cost.CostSummary) -> dict:
    """JAX's roofline terms (``repro/launch/dryrun.py:176-216``) from the
    counted step at the card's bf16 peak and HBM rate, on one device: no
    collective."""
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    tokens = batch * s_in
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * active_param_count(cfg) * tokens
    t_compute = cost.flops / PEAK_FLOPS_BF16
    t_memory = cost.hbm_bytes / HBM_BW
    t_coll = 0.0
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "model_flops_global": model_flops,
            "hlo_flops_global": cost.flops,
            "useful_flops_ratio": model_flops / max(cost.flops, 1.0),
            "roofline_fraction": (model_flops / PEAK_FLOPS_BF16)
            / max(t_compute, t_memory, t_coll, 1e-30)}


def plan_record(arch: str, shape_name: str, sync_path: str = "fused") -> dict:
    """The dry run's record of one cell without running it: JAX's keys where
    they apply (``dryrun.py:187-219``), at the planned batch."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = mesh_config()
    ok, reason = shape_applicability(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": list(mesh.shape),
                "status": "skipped", "reason": reason}
    plan = plan_cell(arch, shape_name)
    batch = plan["batch"]
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    rec = {
        "arch": arch, "shape": shape_name, "mesh": list(mesh.shape),
        "axes": list(mesh.axes),
        "status": "ok" if plan["fits"] else "does_not_fit",
        "sync_path": sync_path,
        "params_B": param_count(cfg) / 1e9,
        "active_params_B": active_param_count(cfg) / 1e9,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "batch": batch, "tokens": batch * s_in,
        "memory": {
            "argument_bytes_per_dev": plan["argument_bytes"],
            "temp_bytes_per_dev": plan["temp_bytes"],
            "total_bytes_per_dev": plan["argument_bytes"]
            + plan["temp_bytes"],
            "card_bytes": HBM_BYTES,
            "argument_parts": plan["argument"], "temp_parts": plan["temp"],
        },
    }
    if not plan["fits"]:
        # no step of it runs on the card: nothing to count
        rec["hlo_cost"] = rec["roofline"] = None
        rec["reason"] = (f"does not fit one card at batch "
                         f"{_step_of(shape)}: "
                         f"{rec['memory']['total_bytes_per_dev'] / 1e9:.2f}"
                         f" GB against {HBM_BYTES / 1e9:.0f}; not counted")
        return rec
    cost = counted_cost(cfg, shape, batch)
    rec["hlo_cost"] = op_cost.hlo_cost_record(cost)
    rec["roofline"] = _roofline(cfg, shape, batch, cost)
    return rec


# ---------------------------------------------------------------------------
# the cell on the card


@dataclasses.dataclass
class Cell:
    """A serving cell built as JAX's ``build_cell`` builds it, at ``batch``:
    ``step(params, batch, cache)`` -> last logits (B, V), the cache updated
    in place, as JAX's ``model.prefill`` / ``model.decode_step``."""

    cfg: ModelConfig
    shape: ShapeConfig
    batch: int
    model: object
    step: Callable


def build_cell(arch: str, shape_name: str, batch: Optional[int] = None,
               device="cuda", cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """The serving cell (prefill on an empty dense cache, or one decode
    step against a ``seq_len``-deep one) at ``batch`` (default: the
    plan's) on ``device``. ``cfg`` and ``shape`` stand in for the arch's
    config and the named shape (a narrow config, a shorter sequence)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if shape.kind == "train":
        raise ValueError("build_cell builds serving cells; a train cell is "
                         "a Session (train_session)")
    if batch is None:
        batch = plan_cell(arch, shape_name)["batch"]
    model = cell_model(cfg, torch.device(device))
    if cfg.family in ("ssm", "hybrid"):
        def step(params, b, cache):
            return model.prefill(params, b["tokens"], cache)
    else:
        def step(params, b, cache):
            return model.prefill(params, b.get("tokens"), cache,
                                 embeds=b.get("embeds"),
                                 positions=b.get("positions"))
    return Cell(cfg, shape, batch, model, step)


def train_session(arch: str, sync_path: str = "fused", device="cuda",
                  cfg: Optional[ModelConfig] = None):
    """The train cell: JAX's production cell, the scan tier over 8 silos
    with its dry-run privacy, over ``cell_model`` (a ``Session`` whose
    ``train(steps=1, batch_size=, seq_len=)`` is the step)."""
    from repro_torch.api import Session

    cfg = cfg or get_config(arch)
    mesh = MeshConfig((TRAIN_SILOS,), ("data",)) \
        if sync_path == "barrier" else None
    sess = Session.from_config(cfg, privacy=train_privacy(sync_path),
                               optimizer=TRAIN_OPTIMIZER,
                               mesh=mesh, shape="train_4k", device=device)
    return dataclasses.replace(sess, model=cell_model(cfg, sess.device))


def seeded_batch(cell: Cell, gen: torch.Generator) -> dict:
    """The step's inputs, drawn from ``gen``: the spec's shapes and dtypes
    (tokens below the vocabulary, embeddings as normals, M-RoPE positions
    at the cache's depth)."""
    at = _at_batch(cell.shape, cell.batch)
    device = cell.model.device
    out = {}
    for name, spec in specs_mod.batch_specs(cell.cfg, at).items():
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, cell.cfg.vocab_size,
                                      tuple(spec.shape), generator=gen,
                                      device=device, dtype=torch.int32)
        elif name == "embeds":
            out[name] = torch.randn(tuple(spec.shape), generator=gen,
                                    device=device).to(spec.dtype)
        else:  # positions
            s_in = spec.shape[-1]
            start = cell.shape.seq_len - 1 if cell.shape.kind == "decode" \
                else 0
            pos = start + torch.arange(s_in, device=device, dtype=torch.int32)
            out[name] = pos.expand(tuple(spec.shape)).contiguous()
    return out


def fill_cache(cache: dict, depth: int, gen: torch.Generator) -> None:
    """A decode cell's cache at ``depth`` (``seq_len - 1``): every float
    tensor of it (K/V, Mamba-2 and RWKV states) drawn in place as seeded
    normals, every ``len`` set to ``depth``."""
    for key, val in cache.items():
        if isinstance(val, dict):
            fill_cache(val, depth, gen)
        elif isinstance(val, torch.Tensor):
            val.normal_(generator=gen)
        elif key == "len":
            cache[key] = depth


def long_prefill(cell: Cell, params, cache: dict, gen: torch.Generator,
                 chunk: int = LONG_CHUNK) -> dict:
    """rwkv6's state at ``seq_len`` seeded tokens: the prompt prefilled
    ``chunk`` tokens a call through ``rwkv_stack.forward`` with the state
    carried (``decode_step``, in place). Returns the calls' ms, the
    kernels they launched and (on the card) the peak bytes, and the last
    call's logits under ``"logits"``."""
    from repro_torch.kernels import dispatch

    dev = cache["S"].device
    cuda = dev.type == "cuda"
    B, S = cell.batch, cell.shape.seq_len
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    for start in range(0, S, chunk):
        toks = torch.randint(0, cell.cfg.vocab_size,
                             (B, min(chunk, S - start)), generator=gen,
                             device=dev, dtype=torch.int32)
        logits = cell.model.decode_step(params, toks, cache)
    if cuda:
        torch.cuda.synchronize(dev)
    return {"tokens": S, "chunk": chunk, "calls": -(-S // chunk),
            "ms": 1e3 * (time.perf_counter() - t0),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None,
            "launches": _launches(), "logits": logits}


def _launches() -> dict:
    """The kernels launched since the counts were zeroed, by
    instantiation where a kernel counts its variants apart."""
    from repro_torch.kernels import dispatch

    variants = dispatch.variant_counts()
    return {k: {n: c for n, c in variants[k].items() if c}
            if k in variants else v
            for k, v in dispatch.launch_counts().items() if v}


def run_cell(cell: Cell) -> dict:
    """``cell`` allocated on its card at its batch, its step run once: the
    weights drawn from seed 0, an empty cache for a prefill, a decode
    cell's cache filled at its depth (rwkv6 at ``long_500k`` prefilled in
    chunks), then the step timed with CUDA events, the peak bytes
    allocated since the inputs were in place and the kernels the step
    launched. Returns the record's ``run`` entry and the logits."""
    from repro_torch.kernels import dispatch

    dev = cell.model.device
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("--run allocates the cell on a CUDA card and "
                           "none is available; the plan alone runs on the "
                           "CPU")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = cell.model.init(gen)
        cache = cell.model.init_cache(cell.batch, cell.shape.seq_len)
        out: dict = {}
        if cell.shape.kind == "decode":
            if cell.cfg.family == "ssm" and cell.shape.name == "long_500k":
                out["prefill"] = long_prefill(cell, params, cache, gen)
                del out["prefill"]["logits"]
            else:
                fill_cache(cache, cell.shape.seq_len - 1, gen)
        batch = seeded_batch(cell, gen)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        dispatch.reset_launches()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        logits = cell.step(params, batch, cache)
        t1.record()
        torch.cuda.synchronize(dev)
        out.update(step_ms=t0.elapsed_time(t1),
                   inputs_bytes=base,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   launches=_launches(),
                   logits_shape=list(logits.shape),
                   logits_finite=bool(torch.isfinite(logits).all()))
    return out, logits


def run_train(arch: str, batch: int, sync_path: str = "fused") -> dict:
    """The train cell at ``batch`` on the card: the state built, then one
    step of :func:`train_session` at ``train_4k``'s length (the kernels
    built and warm first, by a step at one sequence a silo), its host ms
    and the peak bytes allocated over it."""
    dev = torch.device("cuda")
    sess = train_session(arch, sync_path, dev)
    state = sess.init_state()
    seq = SHAPES["train_4k"].seq_len
    warm = sess.train(steps=1, batch_size=TRAIN_SILOS, seq_len=seq,
                      log_every=0, state=state).state
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = sess.train(steps=2, batch_size=batch, seq_len=seq, log_every=0,
                     state=warm)  # the state's step count is 1
    torch.cuda.synchronize(dev)
    return {"step_ms": 1e3 * (time.perf_counter() - t0),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "loss": float(res.final["loss"])}


def record(arch: str, shape_name: str, sync_path: str = "fused",
           run: bool = False) -> dict:
    """:func:`plan_record`, and with ``run`` the cell on the card beside
    it (``"run"``: step ms, measured peak, the plan's share of it)."""
    rec = plan_record(arch, shape_name, sync_path)
    if not run or rec["status"] != "ok":
        return rec
    if SHAPES[shape_name].kind == "train":
        out = run_train(arch, rec["batch"], sync_path)
    else:
        out, _ = run_cell(build_cell(arch, shape_name, rec["batch"]))
    plan = rec["memory"]["total_bytes_per_dev"]
    out["plan_over_peak"] = plan / out["peak_bytes"]
    rec["run"] = out
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every runnable cell (configs.runnable_cells)")
    ap.add_argument("--sync-path", default="fused",
                    choices=("fused", "barrier"))
    ap.add_argument("--run", action="store_true",
                    help="allocate each cell that fits on the card and run "
                         "its step once (needs CUDA)")
    ap.add_argument("--out", default=str(DRYRUN_OUT),
                    help="directory of the records (default: build/dryrun)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.run and not torch.cuda.is_available():
        raise RuntimeError("--run needs a CUDA card and none is available; "
                           "the plan alone runs without --run")
    if args.run:
        # cells fill the card to its 80 GB: growable segments keep the
        # caching allocator's free blocks from splitting the rest (read at
        # the allocator's first use, below)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    n = {"ok": 0, "does_not_fit": 0, "skipped": 0, "failed": 0}
    for arch, shape_name in cells:
        print(f"=== {arch} x {shape_name} ===", flush=True)
        try:
            rec = record(arch, shape_name, args.sync_path, args.run)
            m = rec.get("memory", {})
            if m:
                print(f"  {rec['status']}: batch {rec['batch']} of "
                      f"{rec['global_batch']}, arguments "
                      f"{m['argument_bytes_per_dev'] / 1e9:.2f} GB + temp "
                      f"{m['temp_bytes_per_dev'] / 1e9:.2f} GB", flush=True)
            if "run" in rec:
                r = rec["run"]
                print(f"  run: {r['step_ms']:.1f} ms, peak "
                      f"{r['peak_bytes'] / 1e9:.2f} GB (plan / peak "
                      f"{r['plan_over_peak']:.3f})", flush=True)
        except Exception as e:  # noqa: BLE001 - the record keeps the error
            rec = {"arch": arch, "shape": shape_name, "status": "failed",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAILED: {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
        n[rec["status"]] += 1
        (out_dir / f"{arch}__{shape_name}.json").write_text(
            json.dumps(rec, indent=2))
    print(f"done: {n} into {out_dir}")
    return 1 if n["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
