#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100):
builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version at its path's full-width shapes, serves qwen2.5-3b at its
published width through ``repro_torch.api.Session`` (direct, wave,
continuous and speculative continuous modes), trains it on the fused and on
the barrier DP tier at full width and 12 layers (the barrier tier also
under the per-leaf policy), clips its per-example gradients on both routes,
serves rwkv6-7b and zamba2-7b at published width and full depth (direct
and wave), runs the wire tier's protocol rounds on MNIST-MLP3 at its
published width (serial and pipelined), and checks a serving slice of each
family (plain and speculative for the dense one), a training step of each
tier (packed and perleaf), per-example clipping and the wire tier's rounds
against the host CPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --scans [--src DIR]   # phase 11's scans alone
    python3 chip_smoke.py --pool [--src DIR]    # phase 3's page pool alone
    python3 chip_smoke.py --wire [--src DIR]    # phase 16's wire tier alone

``--scans`` runs only the card line, the build and phase 11's scans (their
checks and times, no launch configuration), from the ``repro_torch`` under
DIR (default: this checkout's ``src``), and prints their JSON record as its
last line. It is the standing tool for a change to a scan kernel: two trees
(an unpacked parent and this one) are timed in one call by running it once
for each, since it uses only the wrappers every tree has. ``--pool`` does
the same for phase 3's page-pool events, on trees that have
``PagePool.rollback_many`` and ``ops.pool_zero``; ``--wire`` for phase 16
(with ``clip_mask``'s SASS read for its bound), on trees that have
``repro_torch.core.tee``.

Phases (any failed check raises, and the script exits non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the kernel build (nvcc, sm_90a) into ``build/``, with its time;
  3. each kernel against its plain version on the card at the main path's
     shapes, timed beside the plain version and one PyTorch call for the
     same function (a yardstick only: the port never calls it); paged
     attention at C 1 (decode), 4 (a speculative verify) and 16 (a prefill
     chunk) from q_starts {0, S/3, S - C, -1}, with the wrapper's split
     plan logged (read from its plan(), not measured); every attention row
     and its SDPA yardstick timed both as calls (``ms``, host-clocked:
     back-to-back calls between CUDA events, so the longer of the host's
     enqueue and the card's work) and on the card alone (``device_ms``: 50
     calls in one CUDA graph); the page pools' zeroing kernel bit-equal to
     its plain version over both whole pools (36 + 4 layers), then each
     event as ``PagePool`` runs it, one launch each: an admission's reset
     (4 fresh pages; target alone, and with the draft), a speculative
     tick's rollback (4 tails of 3 tokens, both pools) and two single
     ranges, beside ``index_fill_`` and the launch floor (an empty kernel
     of the library in the same 50-launch graph); for the single ranges,
     where a call's host time goes (the wrapper's Python, its C entry);
  4. qwen2.5-3b, all 36 layers, fp32, random weights from a seed: direct
     serve (batch 4, prompt 32, 16 new tokens), then 8 Zipf requests through
     4 slots in wave and continuous mode (page 16, chunk 16), and twice more
     in continuous mode with speculative decoding at spec_k 4: a self-draft,
     and a 4-layer early-exit draft over prefix sharing (rejected almost
     every tick with random weights, so its rollbacks run); continuous must
     equal wave, and each speculative run continuous, token for token, and
     every kernel's launch counter, zeroed just before each path, must show
     the path went through it: ``paged_reset`` once an admission and
     ``paged_rollback`` once a tick that rolled back (a spy on
     ``PagePool.rollback_many`` counts those ticks);
  5. the same weights cut to 2 layers, run on the card with the kernels and
     on the host CPU with the plain versions: the logits must agree, and a
     speculative serve with a 1-layer draft must give the same tokens,
     proposals and acceptances; then ``python -m repro_torch.launch.serve
     --scheduler continuous --speculative`` on the card in a subprocess;
  6. the DP kernels at the training paths' shapes (4 silos, P =
     1,547,255,808, the packed length of qwen2.5-3b at 12 layers): each
     bit-equal to its plain version over all P columns (the plain version
     run on windows of 2**22 columns; ``clip_mask`` at the barrier tier's
     flags and a partial ring, its other three flag combinations on one
     window each; ``zsmask`` over each of the 146 leaf tensors at its
     counter offset), timed beside the plain version on a window and, for
     the aggregate, cuBLAS's ``s @ g``; the stream kernels' bounds read off
     their SASS; on the same (4, P) buffer, as 4 examples,
     ``per_example_sumsq`` on every leaf's columns and ``clip_sum``, within
     SUMSQ_RTOL of their plain versions, bit-identical across launches, the
     clipped sum bit-equal to the plain fold at the kernel's norms;
  7. qwen2.5-3b at full width, 12 of 36 layers, trained 3 steps through
     ``Session.train`` with the quickstart privacy settings (4 silos, sigma
     0.3, dynamic clipping, lambda 0.7) and AdamW lr 1e-3, batch 16 x 64:
     finite loss, rising epsilon, each DP kernel launched once per step;
     step and per-stage times and peak memory;
 7b. ``per_example_clipped_grad`` at the same width and depth, 4 examples
     of 64 tokens, on the packed route (``clip_sum`` once) and the perleaf
     route (``per_example_sumsq`` and ``clip_accumulate`` once per leaf):
     the two agree within ROUTES_RTOL; times and peak memory;
  8. one training step of a narrow config (P of a few million) on the card
     (kernels) and on the host CPU (plain versions) from the same weights:
     loss, bound (below its cap, so the percentile protocol ran), noisy
     gradient and parameters agree, and the carried noise key is bit-equal;
  9. the barrier tier at the same width and depth: from one set of weights
     and one batch, ``_fused_grads`` and ``_barrier_grads`` (no optimizer
     state) give the same aggregate within the masks' fp32 residue, and one
     silo's contribution minus its clipped gradient shows the mask (std
     about B*sqrt(2)); then 3 steps through ``Session.train`` on a
     ``(4,)`` data mesh: finite loss, rising epsilon, ``clip_mask`` 4 times a
     step and the fused tier's kernels never; step and stage times, peak
     memory;
 9b. the barrier tier under ``force_impl("perleaf", kernel="dp_noise_tree")``:
     one primed step, whose aggregate minus sum_i clip(g_i) must have the
     std of sigma_c (xi_t - lam xi_{t-1}) (the +-b r terms cancel), then 3
     steps of ``Session.train``: ``zsmask`` 2 x 4 x 146 times a step and no
     other kernel; step and stage times, peak memory;
 10. one barrier step of the narrow config on the card and on the host CPU
     from the same weights, silo 1 dropped and the noise state primed with
     silo 2 absent at t-1: loss, bound, every silo's contribution, the
     aggregate and the carried key agree (the key bit-equal); then
     ``python -m repro_torch.launch.train --sync-path barrier`` on the card
     in a subprocess;
10b. the narrow config's ``per_example_clipped_grad`` on both routes, one
     fused step and one barrier step under the perleaf policy, card vs CPU
     from the same weights; then the training CLI under
     ``REPRO_KERNEL_IMPL=dp_noise_tree=perleaf``;
 11. the scans of the ssm and hybrid families at their main path's shapes:
     ``wkv`` at (4, 32, 64, 64) and ``ssd`` at (4, 32, 112, 64), N 64, each
     with an incoming state, against their plain chunked versions within
     the JAX package's own bounds (also at S 512, at a ragged length past
     two staged passes, and ``wkv`` under strong decay), timed at the main
     shape and at S 512, each with its bound; each kernel's launch
     configuration (blocks, threads, tokens a pass, shared bytes, blocks an
     SM) logged as the built library reports it (not a measurement: it is
     not in the ``kernels`` line); and flash attention at zamba2's d_head
     112;
12-13. rwkv6-7b (32 layers) and zamba2-7b (81 layers) at published width,
     fp32, random weights from a seed: direct serve (batch 4, prompt 32, 16
     new; rwkv6 prefills recurrently there and launches no ``wkv``), a
     timed whole-prompt prefill (4 x 32), and the 8 Zipf requests through
     4 wave slots: ``wkv`` 32 and ``ssd`` 81 launches a prefill (flash 13),
     counts zeroed just before each run; continuous batching must refuse;
 14. narrow configs of both families at the kernels' widths (N = 64, P =
     64, d_head 112), card vs CPU from the same weights: logits after a
     prefill and 3 decode steps within CROSS_ATOL / CROSS_RTOL, and equal
     wave tokens;
 15. ``python -m repro_torch.launch.serve --arch rwkv6-7b|zamba2-7b
     --scheduler wave`` on the card in a subprocess;
 16. the wire tier: ``clip_mask`` at MNIST-MLP3's packed length (P =
     235,520) bit-equal to its plain version (both ``use_prev`` settings, a
     partial ring), timed as a call and on the card beside the launch floor
     and its SASS bound; the speculative rounds' two port kernels there:
     ``noise_stream`` bit-equal to its plain version (at P and a ragged P),
     the external-stream ``clip_mask`` given its buffers bit-equal to its
     plain version and to ``clip_mask``'s in-kernel draw, both timed
     likewise; MNIST-MLP3 at its published width over 4 silos of synthetic
     MNIST (4096 examples, sigma 0.5, C 1, lambda 0.7) through
     ``CollaborativeSession``: 10 serial, 10 pipelined and 10 speculative
     rounds from three sessions with the same seeds, bit-equal (params,
     losses, bytes on the wire), the launch counts zeroed before each run
     (``clip_mask`` once per silo per round; speculative: the variant once
     per silo per round, ``noise_stream`` 11 times a silo, 18 cache hits a
     silo), the loss falling, the median round and each party's share of
     it (admin plane, broadcast, each handler's round trip, its compute on
     the card between CUDA events and its seal, the updater's ingest and
     close; read by wrapping the components' methods on their instances);
     then 3 rounds with silo 1 out in round 1 and resynced in round 2, on
     the card and on the host CPU from the same weights (losses
     WIRE_LOSS_RTOL, params WIRE_PARAM_ATOL, epsilon and participation
     equal); ``python -m repro_torch.launch.train --wire-rounds 4`` on the
     card in a subprocess; then the fault-tolerant rounds: 5 fault-free
     tolerant rounds of 6 silos (worker threads, a CUDA stream a handler)
     bit-equal to the serial loop, whose warm median round sets the
     deadline (4x); a chaos run (seed 6: an updater crash, a hang, a dropped
     and a corrupted blob, KDS denials; 6 silos, quorum 4, 12 rounds) bit-equal
     to its elastic oracle; a journal resumed after a driver restart
     bit-equal to an uninterrupted run; and the CLI's chaos rounds with a
     journal (``--wire-rounds 6 --chaos-seed 1 --round-timeout <deadline>
     --journal``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the fp32 rate outside the tensor cores (the path holds fp32 without TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# per-SM issue rates of Hopper in thread-operations per clock (H100
# architecture white paper: 4 sub-partitions, each dispatching one warp
# instruction a clock to 32 FP32 lanes, 16 INT32 lanes and 4 SFU lanes; the
# integer multiply-add IMAD runs on the FP32 pipe's heavy half, 16 lanes),
# 132 SMs, at the 1.98 GHz boost clock behind the 67 TFLOP/s above
SM_OPS_PER_S = 132 * 1.98e9
LANES = {"alu": 64, "imad": 64, "fp32+imad": 128, "mufu": 16, "issue": 128}
# SASS opcodes of arithmetic by the pipe that runs them; OTHER_OPS issue on
# a pipe not bounded here. Moves (MOV, IMAD.MOV), branches, barriers and
# loads are not counted: they are how this build schedules the work, not
# the work, so the bound from these counts stays a lower bound.
ALU_OPS = {"IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "IMNMX", "SEL",
           "FSETP", "FSEL", "FMNMX", "PLOP3", "IABS", "BMSK", "SGXT"}
IMAD_OPS = {"IMAD", "IMUL"}
OTHER_OPS = {"VIADD", "I2FP", "I2F", "F2I", "F2F", "POPC", "FLO"}
FP32_OPS = {"FFMA", "FMUL", "FADD"}
# kernel vs plain version on the same inputs, fp32 on the card: the two sum
# in different orders, so they agree to fp32 rounding (about 1e-6 here)
KERNEL_ATOL = KERNEL_RTOL = 1e-5
SERVING_KERNELS = ("flash_attention", "paged_attention", "paged_reset",
                   "paged_rollback")
# per_example_sumsq and clip_sum's norms (fp64 sums rounded once) against
# the plain version's chunked fp32 dot products (cuBLAS, about 1e-7
# relative at any length); clip_sum's sum against the plain version's, whose
# clip factors move with its norms, to the same share of its largest value
SUMSQ_RTOL = 1e-6
# the two per-example routes (sums of squares over the whole row, or per
# leaf and then added in fp32) and the per-example gradients recomputed for
# each: fp32 rounding of the norms and the clip factors
ROUTES_RTOL = 1e-5
# the DP kernels keep the plain versions' operations and order (no FMA, the
# same libm log and sqrt): bit-equal, a max |difference| of 0 over the
# whole buffer, the plain version run on DP_WINDOW columns at a time
DP_WINDOW = 1 << 22
# training step of the narrow config, card vs CPU: fp32 products in other
# orders move the loss, norms and bound in the 6th digit and the noisy
# gradient (noise std about 0.3) by about 1e-6
TRAIN_RTOL = 1e-5
NOISY_ATOL = 1e-5
# AdamW's first step moves each weight by lr * g / (|g| + eps): equal to
# ~1e-9 unless g is within rounding of 0 and flips sign between devices
# (2 * lr); a handful of such elements is allowed in a few million
PARAM_ATOL, PARAM_FLIPS = 1e-6, 8
# clip_percentile_max of the narrow step: above its noisy median norm
NARROW_CAP = 8.0
# barrier vs fused aggregate at P = 1.5e9: each contribution carries
# +-b * r terms up to 10 B (|r_i - r_nxt| reaches 9.5 over 1.5e9 draws),
# which cancel only in the sum, in another order than the fused tier's
# noise; each contribution rounds at 10 B and each of the 3 adds at up to
# 20 B: 8 ulps of 20 B bound the residue
MASK_ATOL_PER_B = 8 * 2.0 ** -23 * 20
# barrier step card vs CPU: every contribution scales b by the bound, which
# the two devices agree on to TRAIN_RTOL, so contributions (up to 10 B) and
# the aggregate are held to TRAIN_RTOL * 10 B plus the masks' residue
BARRIER_ATOL_PER_B = TRAIN_RTOL * 10 + 8 * 2.0 ** -23 * 10
# the 2-layer full-width slice, card (kernels, cuBLAS) vs host CPU (plain
# versions, CPU BLAS): fp32 products over d_model 2048 and d_ff 11008 in
# different orders; the same bound holds the narrow SSM and hybrid slices
CROSS_ATOL, CROSS_RTOL = 2e-3, 1e-3
# the scans against their plain chunked versions: the JAX package's own
# bounds for its kernels against the recurrence (tests/test_kernels.py:
# 66-96, 164-180); the per-token recurrence rounds differently from the
# chunked exp(L_t - L_s) form
WKV_ATOL, WKV_STRONG_ATOL, SSD_ATOL = 2e-5, 1e-4, 5e-5


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, n: int = 50) -> float:
    """Device time of one ``fn()`` without the host's share: ``n`` calls
    captured into one CUDA graph, the graph replayed under ``cuda_ms``."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay) / n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3

def paged_case(cfg, dev, gen, B, C, nP, P, q_start):
    """Main-path paged attention inputs: B slots, each with its own nP
    distinct pages of a pool of B*nP pages."""
    N = B * nP
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, C, Hq, D, device=dev, generator=gen)
    kp = torch.randn(N, P, Hkv, D, device=dev, generator=gen)
    vp = torch.randn(N, P, Hkv, D, device=dev, generator=gen)
    perm = torch.randperm(N, device=dev, generator=gen)
    tables = perm.reshape(B, nP).to(torch.int32).contiguous()
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, qs


def paged_work(q, tables, q_start, P, Hkv):
    """(bytes, flops) the call needs for these inputs: q read and the
    output written once, the K/V of every page holding a visible position
    read once, and 2 products of D per visible (query head, key) pair."""
    B, C, Hq, D = q.shape
    S = tables.shape[1] * P
    pages, flops = set(), 0
    for b in range(B):
        qs = int(q_start[b])
        last = min(max(qs + C, 0), S)  # visible positions of the last row
        pages.update(tables[b, :-(-last // P)].tolist())
        for c in range(C):
            flops += 4 * D * Hq * min(max(qs + c + 1, 0), S)
    nbytes = (2 * q.numel() * 4 + len(pages) * P * Hkv * D * 4 * 2
              + tables.numel() * 4 + B * 4)
    return nbytes, flops


def check_paged_attention(cfg, dev, gen, B, nP, P, C, ops, ref, F):
    """Paged attention at C new tokens a slot (1: decode, 4: a speculative
    verify at spec_k 4, 16: a prefill chunk) from q_starts {0, S/3, S - C,
    -1} (the slots' lengths): held to the plain version, timed as calls
    (``ms``, host-clocked: the wrapper's enqueue when it is the longer) and
    on the card alone (``device_ms``), beside SDPA timed both ways."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.paged_attention import plan
    S = nP * P
    # one inactive slot (q_start -1) and one full slot (ends at S - 1)
    q_start = [0, S // 3, S - C, -1][:B]
    q, kp, vp, tables, qs = paged_case(cfg, dev, gen, B, C, nP, P, q_start)
    got = ops.paged_attention(q, kp, vp, tables, qs)
    want = ref.paged_attention_ref(q, kp, vp, tables, qs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "paged_attention: non-finite")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          f"paged_attention C={C} disagrees with its plain version ({err})")
    # yardstick: SDPA over the gathered K/V with the same causal+length mask
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kg = kp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    qpos = qs.long()[:, None] + torch.arange(C, device=dev)[None]
    mask = (torch.arange(S, device=dev)[None, None] <= qpos[:, :, None])[:, None]
    nbytes, flops = paged_work(q, tables.cpu(), qs.cpu(), P, Hkv)
    bms, by = bound(nbytes, flops)
    GC = Hq // Hkv * C
    rows, splits = plan(B, Hkv, GC, nP, P, _build.sm_count(dev))
    blocks = B * Hkv * -(-GC // rows) * splits
    call = lambda: ops.paged_attention(q, kp, vp, tables, qs)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kg, vg, attn_mask=mask, enable_gqa=True)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(call),
        "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_ref(q, kp, vp, tables,
                                                            qs)),
        "library_ms": cuda_ms(sdpa),
        "library_device_ms": graph_ms(sdpa),
        "bound_ms": bms, "bound_by": by,
        # the wrapper's own plan for this call, read from plan(), not
        # measured: the log line carries it, the kernels line does not
        "plan": {"splits": splits, "row_tile": rows, "blocks": blocks},
        "at": f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} P={P} nP={nP} "
              f"q_start={q_start} fp32",
    }


def log_attention(name, r) -> None:
    """One attention row: the kernel and SDPA, each timed as calls
    (host-clocked: back-to-back calls between CUDA events, so the longer of
    the host's enqueue and the card's work) and on the card alone (50
    calls in one CUDA graph); compare like with like."""
    pl = r.get("plan")
    grid = (f" | the wrapper's plan: {pl['splits']} splits, {pl['blocks']} "
            f"blocks of {pl['row_tile']} rows" if pl else "")
    log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} | kernel "
        f"{r['ms']:.4f} ms (on the card {r['device_ms']:.4f}) | SDPA "
        f"{r['library_ms']:.4f} ms (on the card "
        f"{r['library_device_ms']:.4f}) | plain {r['plain_ms']:.4f} ms | "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){grid} | {r['at']}")


def bits(t):
    """The fp32 tensor's bit patterns: +0.0 and -0.0 differ, NaN == NaN."""
    return t.view(torch.int32)


# the page pools at the serving shape (Session.serve's defaults): 4 slots of
# 32 pages of 16 tokens, 128 pages; an admission's 4 fresh pages; one
# speculative tick's 4 rejected tails of 3 tokens (spec_k 4 rejects at most
# 3), each across a page boundary; the draft an early exit of 4 layers
POOL_SLOTS, POOL_PAGE, POOL_WIDTH, POOL_FRESH, POOL_DRAFT = 4, 16, 32, 4, 4
TICK_TAILS = ((0, 47, 50), (1, 15, 18), (2, 95, 98), (3, 63, 66))
SINGLE_RANGES = ((47, 50), (14, 40))


def stub_model(cfg, dev, gen, layers: int):
    """What ``PagePool`` reads of a model: a stacked pool of ``layers``
    layers at ``cfg``'s kv heads and head dim on ``dev``, filled with
    negative values and NaNs (a zeroed lane must be +0.0)."""
    def init_paged_cache(n_pages, page_size):
        shape = (layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
        pool = {}
        for name in ("k_pages", "v_pages"):
            t = -torch.rand(shape, device=dev, generator=gen)
            t[:, ::7, :, 0, :3] = float("nan")
            pool[name] = t
        return pool

    return types.SimpleNamespace(cfg=cfg, init_paged_cache=init_paged_cache)


def launch_floor() -> dict:
    """An empty kernel of the port's library launched through the same
    ctypes path, as a call (``cuda_ms``) and on the card (``graph_ms``, 50
    launches in a CUDA graph)."""
    import ctypes

    from repro_torch.kernels import _build
    entry = _build.Entry("repro_empty_launch", [ctypes.c_void_p])
    dev = torch.device("cuda", torch.cuda.current_device())

    def launch():
        _build.check(entry.launch(dev), "empty kernel")

    return {"ms": cuda_ms(launch), "device_ms": graph_ms(launch)}


def zero_event(kv, call, dead, width, at, card=None) -> dict:
    """One zeroing event: ``call()`` run once and held to an independent
    reference (slabs ``dead`` of every (L, limit, width) view of the pools
    ``kv`` +0.0, every other lane's bits as they were), then timed as a call
    (``cuda_ms``: the host included) and on the card (``graph_ms`` of
    ``card``, by default ``call``), beside ``index_fill_`` of the same slabs
    (one call a tensor)."""
    views = [t.view(t.shape[0], -1, width) for pair in kv for t in pair]
    before = [bits(t).clone() for t in views]
    call()
    torch.cuda.synchronize()
    ix = torch.as_tensor(dead, dtype=torch.long, device=views[0].device)
    for t, t0 in zip(views, before):
        keep = torch.ones(t.shape[1], dtype=torch.bool, device=t.device)
        keep[ix] = False
        check(bool((bits(t)[:, ix] == 0).all()), f"{at}: a listed lane is "
                                                  f"not +0.0")
        check(torch.equal(bits(t)[:, keep], t0[:, keep]),
              f"{at}: a lane outside the list was written")
    del before

    def fill():
        for t in views:
            t.index_fill_(1, ix, 0.0)

    nbytes = 4 * len(dead) * width * sum(t.shape[0] for t in views)
    return {"ms": cuda_ms(call), "device_ms": graph_ms(card or call),
            "library_ms": cuda_ms(fill), "library_device_ms": graph_ms(fill),
            "bound_ms": bound(nbytes, 0)[0], "at": at}


def host_split(target, dead) -> dict:
    """Where a single range's call spends its host time, host-clocked
    (``time.perf_counter``, ms a call, the least of 5 runs of 200 calls,
    the card synchronised before and after each run): the whole
    ``ops.pool_zero``; its CUDA wrapper with the C entry stubbed (the
    checks, the set and sort of the indices, their int32 array); and the C
    entry alone with its arguments built beforehand (ctypes' conversion,
    the copy into the parameter block, the launch). The stub's calls are
    taken off the launch counter again."""
    import array

    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa

    (k, v), = target
    L, N, P, H, D = k.shape
    ids = array.array("i", sorted(set(dead)))
    args = (k.data_ptr(), v.data_ptr(), L, 0, 0, 0, N * P * H * D, N * P,
            H * D, ids.buffer_info()[0], len(ids))

    def per_call(fn, n=200):
        best = math.inf
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best / n * 1e3

    out = {"indices": len(ids),
           "call_ms": per_call(lambda: ops.pool_zero(target, dead, "token")),
           "entry_ms": per_call(lambda: pa._ZERO.launch(k.device, *args))}
    real, counted = pa._ZERO, pa.PAGED_ROLLBACK.launches
    pa._ZERO = types.SimpleNamespace(launch=lambda *a: 1)
    try:
        out["wrapper_ms"] = per_call(
            lambda: pa.pool_zero_cuda(target, dead, "token"))
    finally:
        pa._ZERO, pa.PAGED_ROLLBACK.launches = real, counted
    return out


def pool_events(cfg, dev, seed: int) -> dict:
    """The page pools' zeroing events as ``PagePool`` runs them: an
    admission's reset (4 fresh pages; the target pool alone, then with a
    4-layer draft), one speculative tick's rollback (``TICK_TAILS``, both
    pools) and the single ranges ``SINGLE_RANGES`` of the target pool (a
    tick in which one slot rolled back), each by ``zero_event`` beside its
    plain version; the single ranges also by ``host_split``."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.runtime.serving import PagePool

    gen = torch.Generator(device=dev).manual_seed(seed)
    P, H, D = POOL_PAGE, cfg.n_kv_heads, cfg.d_head
    N = POOL_SLOTS * POOL_WIDTH
    shape = f"N={N} P={P} H={H} D={D} fp32"
    out = {"floor": launch_floor()}

    def make(draft):
        pool = PagePool(stub_model(cfg, dev, gen, cfg.n_layers),
                        n_slots=POOL_SLOTS, n_pages=N, page_size=P,
                        pages_per_slot=POOL_WIDTH,
                        draft_model=stub_model(cfg, dev, gen, POOL_DRAFT)
                        if draft else None)
        for s in range(POOL_SLOTS):
            check(pool.alloc(s, POOL_WIDTH), "PagePool.alloc refused")
        kv = [(p["k_pages"], p["v_pages"]) for p in (pool.pages,
                                                     pool.draft_pages)
              if p is not None]
        return pool, kv

    def event(kv, call, dead, slab, width, at):
        r = zero_event(kv, call, dead, width, at)
        r["plain_ms"] = cuda_ms(lambda: ref.pool_zero_ref(kv, dead, slab))
        return r

    for name, draft in (("reset", False), ("reset_draft", True)):
        pool, kv = make(draft)
        fresh = pool.slot_pages(1)[:POOL_FRESH]
        layers = sum(k.shape[0] for k, _ in kv)
        out[name] = event(
            kv, lambda: ops.pool_zero(kv, fresh, "page"), fresh, "page",
            P * H * D, f"{POOL_FRESH} fresh pages, {layers} layers "
            f"({'target + draft' if draft else 'target'}), {shape}")

    pool, kv = make(True)
    tokens = sum((ops.token_indices(pool.tables[s], P, a, b)
                  for s, a, b in TICK_TAILS), [])
    out["tick"] = event(
        kv, lambda: pool.rollback_many(TICK_TAILS), tokens, "token", H * D,
        f"{len(TICK_TAILS)} tails of 3 tokens across a page boundary, "
        f"{cfg.n_layers + POOL_DRAFT} layers (target + draft), {shape}")

    target = kv[:1]
    for a, b in SINGLE_RANGES:
        dead = ops.token_indices(pool.tables[0], P, a, b)
        r = event(target, lambda: ops.pool_zero(target, dead, "token"), dead,
                  "token", H * D, f"positions [{a}, {b}) of a row of "
                  f"{POOL_WIDTH} pages, {cfg.n_layers} layers (target), "
                  f"{shape}")
        out[f"range_{a}_{b}"] = {**r, "host": host_split(target, dead)}
    return out


def log_pool_events(ev: dict) -> None:
    f = ev["floor"]
    log(f"[kernel] launch floor (an empty kernel of the library, 1 block "
        f"of 32 threads): {f['device_ms']:.4f} ms on the card (50 launches "
        f"in a CUDA graph) | {f['ms']:.4f} ms a call")
    for name in ("reset", "reset_draft", "tick",
                 *(f"range_{a}_{b}" for a, b in SINGLE_RANGES)):
        r = ev[name]
        log(f"[kernel] page pool {name}: call {r['ms']:.4f} ms | card "
            f"{r['device_ms']:.4f} ms | index_fill_ {r['library_ms']:.4f} ms "
            f"(card {r['library_device_ms']:.4f}) | plain "
            f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.6f} ms (bytes) "
            f"| {r['at']}")
        if "host" in r:
            h = r["host"]
            log(f"[kernel] page pool {name} host, {h['indices']} indices "
                f"(perf_counter, ms a call): ops.pool_zero {h['call_ms']:.5f}"
                f" | wrapper, C entry stubbed {h['wrapper_ms']:.5f} | C entry "
                f"alone {h['entry_ms']:.5f}")


@contextlib.contextmanager
def rollback_ticks(PagePool):
    """Counts, in the one-element list it yields, the
    ``PagePool.rollback_many`` calls (one a speculative tick) that had a
    tail to erase: each must be one ``paged_rollback`` launch."""
    ticks = [0]
    real = PagePool.rollback_many

    def spy(self, ranges):
        ranges = list(ranges)
        ticks[0] += any(end > start for _, start, end in ranges)
        return real(self, ranges)

    PagePool.rollback_many = spy
    try:
        yield ticks
    finally:
        PagePool.rollback_many = real


def check_pool_zero(cfg, dev, gen, ops, ref) -> None:
    """The zeroing kernel against its plain version at the serving pools'
    shape (36 + 4 layers, 128 pages), bit for bit over both whole pools
    (+0.0 over NaN and negative lanes): a padded reset row (its first page
    repeated), the tick's tokens, and a list past one launch's capacity
    with repeats and indices outside the pool (600 distinct: three
    launches of 256, csrc/pool_zero.cu)."""
    P, H, D = POOL_PAGE, cfg.n_kv_heads, cfg.d_head
    N = POOL_SLOTS * POOL_WIDTH
    kv = []
    for L in (cfg.n_layers, POOL_DRAFT):
        k = -torch.rand(L, N, P, H, D, device=dev, generator=gen)
        v = torch.randn(L, N, P, H, D, device=dev, generator=gen)
        k[:, ::5, :, 1] = float("nan")
        kv.append((k, v))
    pages = torch.randperm(N, device=dev, generator=gen)[:POOL_FRESH].tolist()
    toks = torch.randperm(N * P, device=dev, generator=gen).tolist()
    cases = (("page", pages + [pages[0]] * (POOL_WIDTH - POOL_FRESH)),
             ("token", toks[:12]),
             ("token", toks[:600] + toks[:9] + [-1, N * P]))
    for slab, idx in cases:
        want = [(k.clone(), v.clone()) for k, v in kv]
        ops.pool_zero(kv, idx, slab)
        ref.pool_zero_ref(want, idx, slab)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for (k, v), (kw, vw) in
                  zip(kv, want) for a, b in ((k, kw), (v, vw))),
              f"pool_zero ({slab}, {len(idx)} indices) differs from its "
              f"plain version")


def check_flash(cfg, dev, gen, B, S, ops, ref, F):
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, S, Hq, D, device=dev, generator=gen)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          f"flash_attention disagrees with its plain version ({err})")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = S * (S + 1) // 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
    bms, by = bound(nbytes, 4 * D * Hq * B * pairs)
    call = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(call),
        "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True)),
        "library_ms": cuda_ms(sdpa),
        "library_device_ms": graph_ms(sdpa),
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal fp32",
    }


# --------------------------------------------------------------- phase 16

# the wire tier's runs: MNIST-MLP3 at its published width, 4 silos of
# synthetic MNIST (4096 examples), sigma 0.5, C 1 (B = 4); lr 0.1, where 10
# rounds take the loss down (the example's 0.5 raises it over its first 10
# rounds at this noise: the mean update's noise is sigma C / 4 an element);
# lambda 0.7 in the serial, pipelined and speculative runs, so that a
# speculative round reads both of its streams from memory (xi_{t-1} the
# round before's cached xi)
WIRE_SILOS, WIRE_ROUNDS, WIRE_LR, WIRE_LAM = 4, 10, 0.1, 0.7
# the fault-tolerant runs: 6 silos, quorum 4 (tests/test_faults.py:123);
# the chaos plan's seed 6 schedules an updater crash, a dropped blob, a
# hang (silo 4 in round 7, which finishes late beside round 8) with a
# corrupted blob, and KDS denials; the journal's resume plan (seed 7, 4
# silos, no hang) crashes a silo before the restart and corrupts a blob
# after it; the CLI's (seed 1) corrupts a blob and crashes the updater
CHAOS_SILOS, CHAOS_QUORUM, CHAOS_ROUNDS, CHAOS_SEED = 6, 4, 12, 6
# 3 rounds card vs CPU: each round's mean update carries the masks' fp32
# residue (contributions reach 10 B; 8 ulps of 10 B a sum), moved by lr
WIRE_PARAM_ATOL = 3 * WIRE_LR * 8 * 2.0 ** -23 * 10 * 4.0
# the losses move with the params by that much over 784 inputs
WIRE_LOSS_RTOL = 1e-4


def wire_update(p, update, lr):
    """The model owner's update: the numpy mean update onto the params'
    device, then one SGD step."""
    return {k: v - lr * torch.as_tensor(update[k], device=v.device)
            for k, v in p.items()}


def instrument_wire(sess) -> dict:
    """Per-party times of a session's rounds, read by wrapping methods on
    its component instances (the path's code is untouched): the host ms of
    the admin plane (keys, verdicts, set; the advance; the batch tag), the
    broadcast's encode, each handler's round trip (the times the session
    feeds ``SiloTelemetry``) and seal, the updater's ingest (open, decode,
    accumulate) and close; and each handler's compute on the card (its
    forward/backward and ``clip_mask``, between CUDA events). ``grad_fn``
    wraps the model owner's gradient code to record the first event."""
    t = {k: [] for k in ("admin_plane", "advance", "batch_tag", "broadcast",
                         "handler_round_trip", "seal", "ingest", "close")}
    events, starts = [], []

    def host(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t[name].append((time.perf_counter() - t0) * 1e3)
        return wrapped

    sess._admin_plane = host("admin_plane", sess._admin_plane)
    sess._params_broadcast = host("broadcast", sess._params_broadcast)
    sess._batch_tag = host("batch_tag", sess._batch_tag)
    sess.admin.advance = host("advance", sess.admin.advance)
    sess.updater.ingest = host("ingest", sess.updater.ingest)
    sess.updater.close_round = host("close", sess.updater.close_round)
    observe = sess.telemetry.observe

    def telemetry(silo, seconds):
        t["handler_round_trip"].append(seconds * 1e3)
        observe(silo, seconds)

    sess.telemetry.observe = telemetry
    for h in sess.handlers:
        h.channel.send = host("seal", h.channel.send)

        def contrib(*a, _fn=h._masked_contrib, **k):
            out = _fn(*a, **k)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((starts.pop(), end))
            return out

        h._masked_contrib = contrib

    def grad_fn(inner):
        def timed_grad(params, data):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            starts.append(start)
            return inner(params, data)
        return timed_grad

    def read(rounds: int) -> dict:
        torch.cuda.synchronize()
        t["handler_compute_card"] = [a.elapsed_time(b) for a, b in events]
        return {k: {"per_round_ms": sum(v) / rounds,
                    "median_call_ms": float(np.median(v)) if v else None,
                    "calls": len(v)} for k, v in t.items()}

    return {"grad_fn": grad_fn, "read": read}


def check_clip_mask_wire(dev, P, ops, ref, keys, prev, per_stream) -> dict:
    """``clip_mask`` at the wire tier's shape, silo 1 of 4 over a partial
    ring (silo 2 out: nxt 3, 3 streams at t, 4 at t-1) at the phase's
    sigma 0.5 and C 1, both ``use_prev`` settings bit-equal to the plain
    version; timed as a call and on the card (50 launches in a CUDA graph,
    every scalar a device tensor), beside the launch floor and the bound of
    its 4 streams from the SASS issue count."""
    gen = torch.Generator(device=dev).manual_seed(16)
    g = torch.randn(P, generator=gen, device=dev) * 0.01
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.5) * f32(1.0)
    args = (f32(0.731), keys.key_r, keys.key_xi, prev, 1, 4, sc,
            f32(8.0) * sc, f32(0.7))
    kw = dict(nxt=3, noise_scale=sc / torch.sqrt(f32(3.0)),
              prev_noise_scale=sc / torch.sqrt(f32(4.0)))
    errs = {}
    for use_prev in (True, False):
        out = ops.clip_mask(g, *args, True, use_prev, **kw)
        plain = ref.clip_mask_ref(g, *args, True, use_prev, **kw)
        errs[f"use_prev={use_prev}"] = (out - plain).abs().max().item()
        check(errs[f"use_prev={use_prev}"] == 0.0,
              f"clip_mask at the wire shape differs: {errs}")
    call = lambda: ops.clip_mask(g, *args, **kw)
    parts = stream_bound(P, 4, per_stream)
    bms = max(parts.values())
    floor = launch_floor()
    return {
        "max_abs_err": 0.0, "checked": errs,
        "ms": cuda_ms(call), "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.clip_mask_ref(g, *args, **kw)),
        "library_ms": None, "launch_floor_ms": floor["device_ms"],
        "launch_floor_call_ms": floor["ms"],
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts},
        "at": f"P={P} (MNIST-MLP3) silo 1 nxt 3 use_pairwise use_prev fp32",
    }


def check_stream_kernels(dev, P, ops, ref, keys, prev, per_stream) -> dict:
    """The speculative rounds' two port kernels at the wire tier's shape.
    ``noise_stream`` bit-equal to its plain version at P and at a ragged
    length; the external-stream ``clip_mask``, given ``noise_stream``'s
    buffers, bit-equal to its plain version and to ``clip_mask``'s
    in-kernel draw (silo 1 of 4 over the partial ring of
    ``check_clip_mask_wire``, both ``use_prev`` settings). Each timed as a
    call and on the card beside the launch floor and its bound: one normal
    an element and the output written for ``noise_stream``, two normals
    (r_i, r_nxt) and g, xi, xp read and the output written for the
    variant, at ``clip_mask``'s SASS cost a normal (the same device
    function)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    g = torch.randn(P, generator=gen, device=dev) * 0.01
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.5) * f32(1.0)
    args = (f32(0.731), keys.key_r, keys.key_xi, prev, 1, 4, sc,
            f32(8.0) * sc, f32(0.7))
    kw = dict(nxt=3, noise_scale=sc / torch.sqrt(f32(3.0)),
              prev_noise_scale=sc / torch.sqrt(f32(4.0)))
    ns_err = {}
    for n in (P, P - 333):
        out = ops.noise_stream(keys.key_xi, 1, torch.empty(n, device=dev))
        ns_err[f"P={n}"] = (out - ref.noise_stream_ref(
            keys.key_xi, 1, n, dev)).abs().max().item()
    check(all(e == 0.0 for e in ns_err.values()),
          f"noise_stream differs from its plain version: {ns_err}")
    xi = ops.noise_stream(keys.key_xi, 1, torch.empty(P, device=dev))
    xp = ops.noise_stream(prev, 1, torch.empty(P, device=dev))
    ext_err = {}
    for use_prev in (True, False):
        out = ops.clip_mask(g, *args, True, use_prev, xi=xi, xp=xp, **kw)
        plain = ref.clip_mask_ref(g, *args, True, use_prev, xi=xi, xp=xp,
                                  **kw)
        drawn = ops.clip_mask(g, *args, True, use_prev, **kw)
        ext_err[f"use_prev={use_prev}"] = {
            "plain": (out - plain).abs().max().item(),
            "in_kernel_draw": (out - drawn).abs().max().item()}
    check(all(e == 0.0 for d in ext_err.values() for e in d.values()),
          f"clip_mask with external streams differs: {ext_err}")
    floor = launch_floor()
    out = torch.empty(P, device=dev)
    rows = {}
    for name, call, plain, streams, words, errs in (
            ("noise_stream",
             lambda: ops.noise_stream(keys.key_xi, 1, out),
             lambda: ref.noise_stream_ref(keys.key_xi, 1, P, dev), 1, 1,
             ns_err),
            ("clip_mask_ext",
             lambda: ops.clip_mask(g, *args, xi=xi, xp=xp, **kw),
             lambda: ref.clip_mask_ref(g, *args, xi=xi, xp=xp, **kw), 2, 4,
             ext_err)):
        parts = stream_bound(P, streams, per_stream, words)
        bms = max(parts.values())
        rows[name] = {
            "max_abs_err": 0.0, "checked": errs,
            "ms": cuda_ms(call), "device_ms": graph_ms(call),
            "plain_ms": cuda_ms(plain), "library_ms": None,
            "library_call": "none (no PyTorch call draws keyed threefry "
                            "normals)",
            "launch_floor_ms": floor["device_ms"],
            "launch_floor_call_ms": floor["ms"], "bound_ms": bms,
            "bound_by": "bytes" if bms == parts["bytes"] else "operations",
            "bound_detail": {"ms_by_limit": parts, "streams": streams,
                             "fp32_words_an_element": words},
            "at": f"P={P} (MNIST-MLP3) silo 1 fp32"
                  + (" nxt 3 use_pairwise use_prev" if words > 1 else "")}
        r = rows[name]
        log(f"[kernel] {name} wire: max_abs_err {json.dumps(errs)} | kernel "
            f"{r['ms']:.4f} ms (on the card {r['device_ms']:.4f}) | launch "
            f"floor {floor['ms']:.4f} ms (on the card "
            f"{floor['device_ms']:.4f}) | plain {r['plain_ms']:.4f} ms | "
            f"bound {bms:.4f} ms ({r['bound_by']}: {json.dumps(parts)}) | "
            f"{r['at']}")
    return rows


def oracle_replay(make, journal, grad_fn, lr) -> tuple:
    """A fresh session (``make()``: (session, params)) scheduling each
    journaled round's realized set as an elastic membership change, then
    the serial ``step`` loop: the fault-free run a quorum-closed run must
    equal bit for bit. Returns (session, params, losses)."""
    sess, params = make()
    losses = []
    for rec in journal.rounds:
        t, want = rec["round"], np.asarray(rec["active"], bool)
        cur = sess.membership.active_at(t)
        for silo in range(sess.n_silos):
            if cur[silo] and not want[silo]:
                check(sess.drop_silo(silo, step=t), "oracle: drop refused")
            elif not cur[silo] and want[silo]:
                sess.rejoin_silo(silo, step=t)
        params, loss = sess.step(t, params, grad_fn, wire_update, lr)
        losses.append(loss)
    return sess, params, losses


def tolerant_phase(dev, init, wpriv, grad_fn, src: Path) -> dict:
    """Phase 16's fault-tolerant rounds on the card: a fault-free tolerant
    run of 6 silos (each handler on a worker thread and its own CUDA
    stream) bit-equal to the serial loop, its warm rounds setting the
    deadline; a seeded chaos run (6 silos, quorum 4, 12 rounds, the plan's
    hangs twice the deadline) that closes every round and equals the
    elastic oracle bit for bit; a journal resumed after a driver restart
    (no deadline) equal to a run that never stopped; and the CLI's chaos
    rounds with a journal."""
    import tempfile

    from repro_torch.api import CollaborativeSession
    from repro_torch.core import flatbuf
    from repro_torch.core.tee import wire
    from repro_torch.core.tee.faults import (FaultInjector, FaultPlan,
                                             RoundJournal)
    from repro_torch.data.synthetic import synthetic_mnist

    def make(n):
        silos = [{"x": s.x, "y": s.y} for s in synthetic_mnist(
            n_train=4096, n_test=16)[0].split(n)]

        def new():
            sess = CollaborativeSession.from_silos(silos, wpriv, device=dev)
            return sess, {k: v.clone() for k, v in init.items()}
        return new

    def bits(params):
        return wire.pack_np(flatbuf.layout_of(params), params).view(np.uint32)

    out = {}
    six = make(CHAOS_SILOS)
    rounds = 5
    sa, pa = six()
    pa, la = sa.run(pa, grad_fn, wire_update, WIRE_LR, rounds,
                    pipelined=False)
    sb, pb = six()
    stamps = []

    def upd(p, update, lr):
        q = wire_update(p, update, lr)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return q

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb, lb = sb.run(pb, grad_fn, upd, WIRE_LR, rounds, round_timeout_s=60.0,
                    quorum=CHAOS_SILOS)
    round_ms = np.diff([t0] + stamps) * 1e3
    check(np.array_equal(bits(pa), bits(pb)) and la == lb
          and sa.wire_stats == sb.wire_stats,
          "fault-free tolerant rounds are not bit-equal to serial on the card")
    warm_ms = float(np.median(round_ms[1:]))
    deadline = max(0.05, 4 * warm_ms / 1e3)
    out["fault_free"] = {"rounds": rounds, "round_ms": round_ms.tolist(),
                         "warm_median_ms": warm_ms, "deadline_s": deadline}
    log(f"[wire] fault-free tolerant == serial bit for bit (6 silos, "
        f"{rounds} rounds; rounds {json.dumps([round(x, 3) for x in round_ms])}"
        f" ms): deadline 4 x the warm median {warm_ms:.3f} ms = "
        f"{deadline:.4f} s")

    sess, params = six()
    inj = FaultInjector(FaultPlan.from_seed(
        CHAOS_SEED, CHAOS_SILOS, CHAOS_ROUNDS, quorum=CHAOS_QUORUM,
        hang_s=2 * deadline))
    journal = RoundJournal()
    t0 = time.perf_counter()
    params, losses = sess.run(params, grad_fn, wire_update, WIRE_LR,
                              CHAOS_ROUNDS, round_timeout_s=deadline,
                              quorum=CHAOS_QUORUM, chaos=inj,
                              journal=journal)
    chaos_s = time.perf_counter() - t0
    check(journal.rounds_done == CHAOS_ROUNDS and bool(inj.fired),
          f"chaos: {journal.rounds_done} rounds closed, fired {inj.fired}")
    osess, oparams, olosses = oracle_replay(six, journal, grad_fn, WIRE_LR)
    check(np.array_equal(bits(params), bits(oparams)) and losses == olosses
          and sess.accountant.contributions == osess.accountant.contributions,
          "chaos run is not bit-equal to its elastic oracle on the card")
    st = dict(sess.fault_stats)
    st["integrity_failures"] = [f"{f['round']}:{f['silo']}"
                                for f in st["integrity_failures"]]
    out["chaos"] = {"seed": CHAOS_SEED, "silos": CHAOS_SILOS,
                    "quorum": CHAOS_QUORUM, "rounds": CHAOS_ROUNDS,
                    "deadline_s": deadline, "plan": inj.plan.counts(),
                    "fired": inj.fired, "fault_stats": st, "s": chaos_s,
                    "contributions": sess.accountant.contributions,
                    "loss": [losses[0], losses[-1]]}
    log(f"[wire] chaos (seed {CHAOS_SEED}, {CHAOS_SILOS} silos, quorum "
        f"{CHAOS_QUORUM}, {CHAOS_ROUNDS} rounds, deadline {deadline:.4f} s) "
        f"in {chaos_s:.2f} s == elastic oracle bit for bit | plan "
        f"{json.dumps(inj.plan.counts())} | fired {json.dumps(inj.fired)} | "
        f"fault stats {json.dumps(st)} | contributions "
        f"{sess.accountant.contributions}")

    four = make(4)
    plan = FaultPlan.from_seed(7, 4, 4, quorum=2, hang_rate=0.0)
    ref_sess, ref_params = four()
    ref_journal = RoundJournal()
    ref_params, ref_losses = ref_sess.run(
        ref_params, grad_fn, wire_update, WIRE_LR, 4, quorum=2,
        chaos=FaultInjector(plan), journal=ref_journal)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rounds.journal")
        s1, p1 = four()
        inj = FaultInjector(plan)
        _, l1 = s1.run(p1, grad_fn, wire_update, WIRE_LR, 2, quorum=2,
                       chaos=inj, journal=RoundJournal(path=path))
        s2, _ = four()
        j2 = RoundJournal.load(path)
        p2 = s2.resume(j2)
        p2, l2 = s2.run(p2, grad_fn, wire_update, WIRE_LR, 2, quorum=2,
                        chaos=inj, journal=j2)
        check(j2.rounds == ref_journal.rounds
              and np.array_equal(bits(p2), bits(ref_params))
              and l1 + l2 == ref_losses and bool(inj.fired),
              "journal resume is not bit-equal to an uninterrupted run")
        out["resume"] = {"rounds": 4, "cut": 2, "fired": inj.fired,
                         "sets": [r["active"] for r in j2.rounds]}
        log(f"[wire] journal resume after 2 of 4 rounds == uninterrupted bit "
            f"for bit | fired {json.dumps(inj.fired)} | sets "
            f"{json.dumps(out['resume']['sets'])}")

        cli = [sys.executable, "-m", "repro_torch.launch.train",
               "--wire-rounds", "6", "--chaos-seed", "1", "--round-timeout",
               f"{deadline:.4f}", "--journal",
               os.path.join(tmp, "cli.journal")]
        t0 = time.perf_counter()
        r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                           timeout=300,
                           env={**os.environ, "PYTHONPATH": str(src)})
        check(r.returncode == 0 and "wire tier: 6 rounds closed on cuda"
              in r.stdout and "fault stats:" in r.stdout,
              f"wire chaos CLI failed ({r.returncode}):\n{r.stdout}\n"
              f"{r.stderr}")
        lines = [x for x in r.stdout.splitlines()
                 if x.startswith(("wire", "fault", "chaos"))]
        out["cli"] = {"cmd": " ".join(cli[1:-1] + ["<tmp>/cli.journal"]),
                      "s": time.perf_counter() - t0, "last": lines}
        log(f"[cli] {out['cli']['cmd']}: exit 0 in {out['cli']['s']:.1f} s | "
            + " | ".join(lines))
    return out


def wire_phase(dev, per_stream: dict, src: Path = ROOT / "src") -> tuple:
    """Phase 16, the wire tier on the card: MNIST-MLP3 at its published
    width over 4 silos, ``clip_mask``, ``noise_stream`` and the
    external-stream ``clip_mask`` at its shape against their plain
    versions, 10 serial, 10 pipelined and 10 speculative rounds (bit-equal;
    ``clip_mask`` once per silo per round, or in speculative rounds the
    variant once and ``noise_stream`` on each miss and prefetch; the loss
    falling; each round's time split by party), 3 rounds card vs CPU with a
    drop and a full resync, the ``--wire-rounds`` CLI (from ``src``), and
    the fault-tolerant rounds (:func:`tolerant_phase`). Returns ``(record,
    clip_mask's wire row, the two port kernels' rows)``."""
    from repro_torch.api import CollaborativeSession
    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.tee import wire
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dp_fused import ops as noise_ops
    from repro_torch.kernels.dp_fused import ref as noise_ref
    from repro_torch.models.small import build_small_model, value_and_grad

    t16 = time.perf_counter()
    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y} for s in synthetic_mnist(
        n_train=4096, n_test=16)[0].split(WIRE_SILOS)]
    wpriv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                          noise_lambda=WIRE_LAM)
    init = sm.init(torch.Generator(device=dev).manual_seed(1))
    P_WIRE = flatbuf.layout_of(init).total
    grad_fn = value_and_grad(sm.loss)
    row = check_clip_mask_wire(
        dev, P_WIRE, noise_ops, noise_ref, step_keys(prng.PRNGKey(0), 0),
        step_keys(prng.PRNGKey(0), 1).key_xi, per_stream)
    stream_rows = check_stream_kernels(
        dev, P_WIRE, noise_ops, noise_ref, step_keys(prng.PRNGKey(0), 0),
        step_keys(prng.PRNGKey(0), 1).key_xi, per_stream)
    log(f"[kernel] clip_mask wire: max_abs_err {row['checked']} | kernel "
        f"{row['ms']:.4f} ms (on the card {row['device_ms']:.4f}) | launch "
        f"floor {row['launch_floor_call_ms']:.4f} ms (on the card "
        f"{row['launch_floor_ms']:.4f}) | plain {row['plain_ms']:.4f} ms | "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{json.dumps(row['bound_detail']['ms_by_limit'])}) | {row['at']}")
    runs = {}
    for mode in ("serial", "pipelined", "speculative"):
        sess = CollaborativeSession.from_silos(silos, wpriv,
                                               params_template=init)
        parts = instrument_wire(sess)
        stamps = []

        def upd(p, update, lr, _stamps=stamps):
            out = wire_update(p, update, lr)
            torch.cuda.synchronize()
            _stamps.append(time.perf_counter())
            return out

        params = {k: v.clone() for k, v in init.items()}
        dispatch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = sess.run(params, parts["grad_fn"](grad_fn), upd,
                                  WIRE_LR, WIRE_ROUNDS,
                                  pipelined=mode != "serial",
                                  speculative=mode == "speculative")
        counts = dispatch.launch_counts()
        hits = [h._spec_hits for h in sess.handlers]
        if mode == "speculative":
            # per handler: round 0 draws xi and xi_{t-1}, every later
            # round's xi is prefetched, and both of its streams hit
            want = {"clip_mask_ext": WIRE_SILOS * WIRE_ROUNDS,
                    "noise_stream": WIRE_SILOS * (WIRE_ROUNDS + 1)}
            check(hits == [2 * (WIRE_ROUNDS - 1)] * WIRE_SILOS,
                  f"wire speculative: cache hits {hits}")
        else:
            want = {"clip_mask": WIRE_SILOS * WIRE_ROUNDS}
        check({k: v for k, v in counts.items() if v} == want,
              f"wire {mode}: launches {counts}, expected {want}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"wire {mode}: loss {losses[0]} -> {losses[-1]}")
        rounds_ms = np.diff([t0] + stamps) * 1e3
        runs[mode] = {"sess": sess, "losses": losses,
                      "packed": wire.pack_np(flatbuf.layout_of(params),
                                             params),
                      "round_ms": rounds_ms.tolist(),
                      "median_round_ms": float(np.median(rounds_ms)),
                      "parts": parts["read"](WIRE_ROUNDS),
                      "launches": {k: v for k, v in counts.items() if v},
                      "spec_hits": hits}
    a = runs["serial"]
    for mode in ("pipelined", "speculative"):
        b = runs[mode]
        check(np.array_equal(a["packed"].view(np.uint32),
                             b["packed"].view(np.uint32))
              and a["losses"] == b["losses"]
              and a["sess"].wire_stats == b["sess"].wire_stats,
              f"{mode} wire rounds are not bit-equal to serial on the card")
    report = {mode: {k: v for k, v in r.items()
                             if k not in ("sess", "packed")}
                      for mode, r in runs.items()}
    report["wire_stats"] = a["sess"].wire_stats
    report["P"] = P_WIRE
    for mode, r in runs.items():
        log(f"[wire] {mode}: {WIRE_ROUNDS} rounds, median "
            f"{r['median_round_ms']:.3f} ms a round (rounds "
            f"{json.dumps([round(x, 3) for x in r['round_ms']])}) | loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} | launches "
            f"{json.dumps(r['launches'])} | cache hits {r['spec_hits']}")
        log(f"[wire] {mode} split, ms a round (median call ms, calls): "
            + ", ".join(f"{k} {v['per_round_ms']:.3f} "
                        f"({v['median_call_ms'] or 0:.4f}, {v['calls']})"
                        for k, v in r["parts"].items()))
    log(f"[wire] pipelined == serial == speculative bit for bit; bytes on "
        f"the wire {json.dumps(a['sess'].wire_stats)}")
    # the card's busy share of 3 serial rounds (torch.profiler; a first
    # round outside the window warms the new session)
    from repro_torch.launch.profile_serve import _window
    sess = CollaborativeSession.from_silos(silos, wpriv, params_template=init)
    params, _ = sess.step(0, {k: v.clone() for k, v in init.items()},
                          grad_fn, wire_update, WIRE_LR)
    prof = _window(lambda: sess.run(params, grad_fn, wire_update, WIRE_LR, 3,
                                    pipelined=False), 8)
    report["profile_3_serial_rounds"] = prof
    log(f"[wire] 3 serial rounds under torch.profiler: wall "
        f"{prof['wall_ms']:.2f} ms | card busy {prof['device_busy_ms']:.3f} "
        f"ms ({prof['busy_share']:.2%}) | by device time: "
        + "; ".join(f"{r['name'][:48]} x{r['count']} {r['device_ms']:.3f}"
                    for r in prof["top"]))

    # 3 rounds at lambda 0.7, silo 1 out in round 1 and back (a full
    # resync) in round 2, on the card and on the host CPU, same weights
    def three(device):
        sess = CollaborativeSession.from_silos(silos, wpriv, device=device)
        params = {k: v.to(device) for k, v in init.items()}
        dispatch.reset_launches()
        losses = []
        for t in range(3):
            if t == 1:
                check(sess.drop_silo(1), "wire: drop refused")
            if t == 2:
                check(sess.rejoin_silo(1), "wire: rejoin refused")
            params, loss = sess.step(t, params, grad_fn, wire_update,
                                     WIRE_LR)
            losses.append(loss)
        return (sess, wire.pack_np(flatbuf.layout_of(params), params),
                losses, dispatch.launch_counts())

    gs, gp, gl, gcounts = three(dev)
    cs, cp, cl, ccounts = three("cpu")
    check(gcounts["clip_mask"] == 4 + 3 + 4
          and sum(ccounts.values()) == 0, f"wire card vs CPU launches "
          f"{gcounts['clip_mask']} (card), {sum(ccounts.values())} (CPU)")
    check(gs.wire_stats["resync_bytes"] > 0, "wire: no full resync")
    loss_rel = float(np.max(np.abs(np.subtract(gl, cl)) / np.abs(cl)))
    param_err = float(np.abs(gp - cp).max())
    check(loss_rel <= WIRE_LOSS_RTOL and param_err <= WIRE_PARAM_ATOL
          and gs.epsilon() == cs.epsilon()
          and gs.accountant.history == cs.accountant.history,
          f"wire card vs CPU: loss {loss_rel} params {param_err} eps "
          f"{gs.epsilon()} / {cs.epsilon()} history "
          f"{gs.accountant.history} / {cs.accountant.history}")
    report["card_vs_cpu"] = {
        "loss_max_rel": loss_rel, "loss_rtol": WIRE_LOSS_RTOL,
        "param_max_abs": param_err, "param_atol": WIRE_PARAM_ATOL,
        "epsilon": gs.epsilon(), "history": gs.accountant.history}
    log(f"[wire] card vs CPU, 3 rounds (lambda 0.7, silo 1 out in round 1, "
        f"resynced in round 2): loss {loss_rel:.2e} rel (<= "
        f"{WIRE_LOSS_RTOL}), params {param_err:.2e} (<= "
        f"{WIRE_PARAM_ATOL:.2e}), eps {gs.epsilon():.4f} equal, "
        f"participation {gs.accountant.contributions}")
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--wire-rounds",
           "4"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(src)})
    check(r.returncode == 0 and "wire tier: 4 rounds closed on cuda"
          in r.stdout, f"wire CLI failed ({r.returncode}):\n{r.stdout}\n"
          f"{r.stderr}")
    done = next(x for x in r.stdout.splitlines() if x.startswith("wire"))
    report["cli"] = {"cmd": " ".join(cli[1:]),
                     "s": time.perf_counter() - t0, "last": done}
    log(f"[cli] {' '.join(cli[1:])}: exit 0 in {report['cli']['s']:.1f} s "
        f"| {done}")
    row["launches"] = runs["serial"]["launches"]["clip_mask"]
    for name in stream_rows:
        stream_rows[name]["launches"] = runs["speculative"]["launches"][name]
    report["tolerant"] = tolerant_phase(dev, init, wpriv, grad_fn, src)
    report["phase_s"] = time.perf_counter() - t16
    log(f"[wire] phase 16 in {report['phase_s']:.1f} s")
    return report, row, stream_rows



# --------------------------------------------------------------- phase 11

def wkv_inputs(dev, gen, B, S, H, N, w=None):
    """The JAX package's test distribution at the path's shapes: r, k, v ~
    0.5 N(0, 1), decay in (0.45, 0.95) (or a constant ``w``), u ~ 0.3
    N(0, 1), an incoming state ~ 0.1 N(0, 1)."""
    n = lambda *s: torch.randn(*s, device=dev, generator=gen)
    r, k, v = n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5
    w = torch.sigmoid(n(B, S, H, N)) * 0.5 + 0.45 if w is None \
        else torch.full((B, S, H, N), w, device=dev)
    return r, k, v, w, n(H, N) * 0.3, n(B, H, N, N) * 0.1


def scan_timing(kernel, plain, nbytes: float, flops: float, at: str) -> dict:
    """A scan's call and card times at one shape, beside its plain
    version's and its bound."""
    bms, by = bound(nbytes, flops)
    return {"ms": cuda_ms(kernel), "device_ms": graph_ms(kernel),
            "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
            "at": at}


def check_wkv(dev, gen, B, S, H, N, ops, ref):
    """``wkv`` against its plain chunked version: at the main path's shape
    and at S 512 (both timed), at a ragged length past two staged passes
    (the plain version runs the recurrence) and under strong decay (w =
    0.05), within the JAX package's own bounds."""
    cases, timed_at = {}, {}
    for name, S_, w, tol in (("main", S, None, WKV_ATOL),
                             ("s512", 512, None, WKV_ATOL),
                             ("ragged", 37, None, WKV_ATOL),
                             ("strong decay", S, 0.05, WKV_STRONG_ATOL)):
        xs = wkv_inputs(dev, gen, B, S_, H, N, w)
        o, st = ops.wkv_chunked(*xs)
        po, pst = ref.wkv_chunked_ref(*xs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all() and torch.isfinite(st).all()),
              f"wkv {name}: non-finite")
        err = max((o - po).abs().max().item(), (st - pst).abs().max().item())
        check(err <= tol, f"wkv {name} (S={S_}) differs from its plain "
                          f"version by {err} (tolerance {tol})")
        cases[name] = {"S": S_, "max_abs_err": err, "tolerance": tol}
        if name in ("main", "s512"):
            timed_at[name] = xs
    out = {}
    for name, xs in timed_at.items():
        r, u, s0 = xs[0], xs[4], xs[5]
        S_ = r.shape[1]
        # r, k, v, w in and o out; u; the state in and out
        nbytes = (5 * r.numel() + u.numel() + 2 * s0.numel()) * 4
        out[name] = scan_timing(
            lambda: ops.wkv_chunked(*xs), lambda: ref.wkv_chunked_ref(*xs),
            nbytes, 4 * B * S_ * H * N * N,
            f"B={B} S={S_} H={H} N={N} fp32, with an incoming state")
        out[name]["max_abs_err"] = cases[name]["max_abs_err"]
    return {
        **out["main"], "s512": out["s512"], "cases": cases,
        "tolerance": f"{WKV_ATOL} ({WKV_STRONG_ATOL} under strong decay)",
        "library_ms": None,
        "library_call": "none (no single PyTorch call computes the scan)",
    }


def ssd_inputs(dev, gen, B, S, nh, P, N):
    """The JAX package's test distribution at the path's shapes."""
    n = lambda *s: torch.randn(*s, device=dev, generator=gen)
    return (n(B, S, nh, P) * 0.5,
            torch.nn.functional.softplus(n(B, S, nh)),
            -n(B, S, nh).abs() * 0.5, n(B, S, N) * 0.5, n(B, S, N) * 0.5,
            n(B, nh, P, N) * 0.1)


def check_ssd(dev, gen, B, S, nh, P, N, ops, ref):
    """``ssd`` against its plain chunked version at the main path's shape
    and at S 512 (both timed) and at a ragged length past two staged
    passes, within the JAX package's bound."""
    cases, timed_at = {}, {}
    for name, S_ in (("main", S), ("s512", 512), ("ragged", 37)):
        xs = ssd_inputs(dev, gen, B, S_, nh, P, N)
        y, h = ops.ssd_chunked(*xs)
        py, ph = ref.ssd_chunked_ref(*xs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              f"ssd {name}: non-finite")
        err = max((y - py).abs().max().item(), (h - ph).abs().max().item())
        check(err <= SSD_ATOL, f"ssd {name} (S={S_}) differs from its plain "
                               f"version by {err} (tolerance {SSD_ATOL})")
        cases[name] = {"S": S_, "max_abs_err": err, "tolerance": SSD_ATOL}
        if name in ("main", "s512"):
            timed_at[name] = xs
    out = {}
    for name, xs in timed_at.items():
        x, dt, _, Bc, _, h0 = xs
        S_ = x.shape[1]
        # x, dt, la, B, C, h0 in; y and h out
        nbytes = (2 * x.numel() + 2 * dt.numel() + 2 * Bc.numel()
                  + 2 * h0.numel()) * 4
        out[name] = scan_timing(
            lambda: ops.ssd_chunked(*xs), lambda: ref.ssd_chunked_ref(*xs),
            nbytes, 5 * B * S_ * nh * P * N,
            f"B={B} S={S_} nh={nh} P={P} N={N} fp32, with an incoming state")
        out[name]["max_abs_err"] = cases[name]["max_abs_err"]
    return {
        **out["main"], "s512": out["s512"], "cases": cases,
        "tolerance": SSD_ATOL, "library_ms": None,
        "library_call": "none (no single PyTorch call computes the scan)",
    }


def log_scan(name: str, r: dict) -> None:
    """One line for the main shape, one for S 512."""
    log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} "
        f"(cases {json.dumps(r['cases'])}) | kernel {r['ms']:.4f} ms "
        f"(on the card {r['device_ms']:.4f}) | plain {r['plain_ms']:.4f} "
        f"ms | library none | bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}) | {r['at']}")
    x = r["s512"]
    log(f"[kernel] {name} S 512: max_abs_err {x['max_abs_err']:.3g} | kernel "
        f"{x['ms']:.4f} ms (on the card {x['device_ms']:.4f}) | plain "
        f"{x['plain_ms']:.4f} ms | bound {x['bound_ms']:.4f} ms "
        f"({x['bound_by']}) | {x['at']}")


def check_scans(dev, seed: int) -> dict:
    """Phase 11's scans, from the ``repro_torch`` first on ``sys.path``:
    ``wkv`` at rwkv6-7b's and ``ssd`` at zamba2-7b's whole-prompt prefill
    (batch 4, prompt 32) and at S 512, each logged."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.models.mamba2 import dims as mamba2_dims

    rcfg = get_config("rwkv6-7b")
    _, nh, P, N, _ = mamba2_dims(get_config("zamba2-7b"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"wkv": check_wkv(dev, gen, 4, 32, rcfg.n_heads,
                            rcfg.rwkv_head_size, wkv_ops, wkv_ref),
           "ssd": check_ssd(dev, gen, 4, 32, nh, P, N, ssd_ops, ssd_ref)}
    for name, r in out.items():
        log_scan(name, r)
    return out


def log_scan_launches(rcfg, zcfg) -> None:
    """Each scan's launch configuration at the main path's shapes, as this
    checkout's built library reports it: a configuration, not a
    measurement, so it stays out of the ``kernels`` line."""
    from repro_torch.kernels.mamba2.mamba2 import kernel_config as ssd_config
    from repro_torch.kernels.rwkv6.rwkv6 import kernel_config as wkv_config
    from repro_torch.models.mamba2 import dims as mamba2_dims

    _, nh, P, N, _ = mamba2_dims(zcfg)
    for name, blocks, cfg in (
            ("wkv", 4 * rcfg.n_heads, wkv_config(rcfg.rwkv_head_size)),
            ("ssd", 4 * nh, ssd_config(P, N))):
        log(f"[kernel] {name} launch (the library's configuration, not "
            f"measured): {json.dumps({'blocks': blocks, **cfg})}")


def one_phase(phase: str, src: Path) -> int:
    """``--scans`` / ``--pool`` / ``--wire``: the card, the build and phase
    11's scans, phase 3's page-pool events or phase 16's wire tier alone,
    from the ``repro_torch`` under ``src`` (another tree's, to time two
    trees in one call); the last line is their JSON record."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = card_line()
    log(card)
    build_s = _build.build()
    log(f"[build] {_build.library_path()} in {build_s:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if phase == "scans":
        record = check_scans(dev, 11)
    elif phase == "pool":
        record = pool_events(get_config("qwen2.5-3b"), dev, 0)
        log_pool_events(record)
    else:
        record, row, stream_rows = wire_phase(
            dev, stream_ops(library_sass(), ROW8_SASS), src)
        record["clip_mask_wire"] = row
        record["stream_kernels"] = stream_rows
    log(json.dumps({"src": str(src), "card": card, phase: record}))
    return 0


def timed(fn):
    """(result, host seconds) of ``fn()``, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_family(Session, arch, kernels, per_prefill, reqs, log_name):
    """One full-width family through ``Session.serve``: direct (batch 4,
    prompt 32, 16 new) and wave (``reqs`` through 4 slots), the launch
    counts zeroed just before each and read just after, plus one timed
    whole-prompt prefill (batch 4 x 32: the wave scheduler's scan path).
    ``per_prefill`` is each kernel's launches a whole-prompt prefill;
    ``kernels`` the direct mode's launches (the ssm family prefills
    recurrently there, so none). Continuous batching must raise."""
    from repro_torch.kernels import dispatch

    sess = Session.from_config(arch, full=True, seed=0)
    cfg, V = sess.cfg, sess.cfg.vocab_size
    params, init_s = timed(sess.init_params)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[{log_name}] {arch} full width ({cfg.n_layers} layers): "
        f"{n_params / 1e9:.3f} B fp32 params ({n_params * 4 / 1e9:.2f} GB) "
        f"on the card in {init_s:.1f} s")
    sess.serve(batch_size=4, prompt_len=8, max_new_tokens=2, params=params)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    direct = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                        params=params)
    n_direct = dispatch.launch_counts()
    check(direct.tokens.shape == (4, 16)
          and bool(((direct.tokens >= 0) & (direct.tokens < V)).all()),
          f"{arch} direct tokens")
    check(tuple(direct.logits.shape) == (4, V)
          and bool(torch.isfinite(direct.logits).all()),
          f"{arch} direct logits")
    check(n_direct == {k: kernels.get(k, 0) for k in n_direct},
          f"{arch} direct launches {n_direct}, expected {kernels}")
    prompt = torch.randint(0, V, (4, 32), generator=torch.Generator(
        ).manual_seed(5)).to(sess.device)
    cache = sess.model.init_cache(4, 48)
    dispatch.reset_launches()
    with torch.inference_mode():
        logits, scan_s = timed(lambda: sess.model.prefill(params, prompt,
                                                          cache))
    n_scan = dispatch.launch_counts()
    check(n_scan == {k: per_prefill.get(k, 0) for k in n_scan},
          f"{arch} whole-prompt prefill launches {n_scan}, expected "
          f"{per_prefill}")
    check(bool(torch.isfinite(logits).all()), f"{arch} prefill logits")
    del cache, logits
    dispatch.reset_launches()
    wave = sess.serve(scheduler="wave", requests=copy.deepcopy(reqs),
                      params=params, max_batch=4, max_len=512)
    n_wave = dispatch.launch_counts()
    check(wave.stats.drained and len(wave.stats.latencies) == len(reqs),
          f"{arch} wave did not drain")
    want = {k: v * wave.stats.waves for k, v in per_prefill.items()}
    check(n_wave == {k: want.get(k, 0) for k in n_wave},
          f"{arch} wave launches {n_wave} for {wave.stats.waves} waves, "
          f"expected {want}")
    peak = torch.cuda.max_memory_allocated()
    try:
        sess.serve(scheduler="continuous", batch_size=2, prompt_len=4,
                   max_new_tokens=2, params=params)
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("no paged serving path" in raised,
          f"{arch}: continuous batching did not refuse ({raised!r})")
    st = wave.stats
    out = {
        "config": f"{arch} published width, {cfg.n_layers} layers, fp32",
        "n_params": n_params, "init_s": init_s,
        "direct": {"prefill_ms": direct.prefill_s * 1e3,
                   "decode_ms_per_token": direct.decode_s_per_token * 1e3,
                   "decode_tok_per_s": 4 / direct.decode_s_per_token,
                   "launches": n_direct},
        "scan_prefill": {"ms": scan_s * 1e3, "batch": 4, "prompt": 32,
                         "launches": n_scan},
        "wave": {"useful_tokens": st.useful_tokens,
                 "tok_per_s": 1 / wave.decode_s_per_token,
                 "waves": st.waves, "utilization": st.utilization,
                 "p50_latency_steps": st.p50_latency_steps,
                 "p99_latency_steps": st.p99_latency_steps,
                 "decode_steps": st.decode_steps, "launches": n_wave},
        "peak_mem_gb": peak / 1e9}
    log(f"[{log_name}] direct batch 4, prompt 32, 16 new: prefill "
        f"{direct.prefill_s * 1e3:.2f} ms | decode "
        f"{direct.decode_s_per_token * 1e3:.2f} ms/token step | "
        f"{4 / direct.decode_s_per_token:.1f} tok/s | launches "
        f"{ {k: v for k, v in n_direct.items() if v} }")
    log(f"[{log_name}] whole-prompt prefill, batch 4 x 32: {scan_s * 1e3:.2f}"
        f" ms | launches { {k: v for k, v in n_scan.items() if v} }")
    log(f"[{log_name}] wave: {len(reqs)} requests, 4 slots, {st.waves} "
        f"waves: {st.useful_tokens} tokens at {1 / wave.decode_s_per_token:.1f}"
        f" tok/s | utilization {st.utilization:.3f} | p50 "
        f"{st.p50_latency_steps} p99 {st.p99_latency_steps} steps | launches "
        f"{ {k: v for k, v in n_wave.items() if v} } | peak "
        f"{peak / 1e9:.2f} GB | continuous refused")
    return out


def family_cross_device(Session, cfg, reqs, log_name):
    """A narrow config of one family (the kernels' widths) on the card and
    on the host CPU from the same weights: the logits after a whole-prompt
    prefill and after 3 decode steps agree within CROSS_ATOL / CROSS_RTOL,
    and a wave serve gives the same greedy tokens."""
    from repro_torch.kernels import dispatch

    on = {d: Session.from_config(cfg, device=d, seed=7)
          for d in ("cuda", "cpu")}
    p_cpu = on["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(on["cuda"].device)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    steps = [torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
             for _ in range(3)]
    logits, launches = {}, {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        m = on[d].model
        dispatch.reset_launches()
        with torch.inference_mode():
            cache = m.init_cache(2, 32)
            out = [m.prefill(p, prompt.to(m.device), cache)]
            out += [m.decode_step(p, t.to(m.device), cache) for t in steps]
        launches[d] = {k: v for k, v in dispatch.launch_counts().items() if v}
        logits[d] = [o.float().cpu() for o in out]
    err = max((a - b).abs().max().item()
              for a, b in zip(logits["cuda"], logits["cpu"]))
    top = max(b.abs().max().item() for b in logits["cpu"])
    check(all(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              for a, b in zip(logits["cuda"], logits["cpu"])),
          f"{cfg.name} card vs CPU logits differ by {err} (|logit| up to "
          f"{top})")
    check(not launches["cpu"] and launches["cuda"],
          f"{cfg.name} launches: card {launches['cuda']}, CPU "
          f"{launches['cpu']}")
    toks = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        res = on[d].serve(scheduler="wave", requests=copy.deepcopy(reqs),
                          params=p, max_batch=2, max_len=64)
        toks[d] = res.tokens
    check(bool((toks["cuda"] == toks["cpu"]).all()),
          f"{cfg.name} wave tokens differ between card and CPU")
    log(f"[{log_name}] {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), card vs CPU: prefill + 3 decode steps max |logit "
        f"diff| {err:.3g} (|logit| up to {top:.3g}; atol {CROSS_ATOL}, rtol "
        f"{CROSS_RTOL}) | card launches {launches['cuda']} | wave tokens "
        f"equal ({int((toks['cpu'] >= 0).sum())})")
    return {"max_abs_err": err, "max_abs_logit": top, "atol": CROSS_ATOL,
            "rtol": CROSS_RTOL, "card_launches": launches["cuda"],
            "wave_tokens_equal": int((toks["cpu"] >= 0).sum())}


# ---------------------------------------------------------------- phase 5

def cut_layers(params, cfg_cut, device, Transformer):
    """The first ``cfg_cut.n_layers`` layers of ``params`` (with its
    embedding, final norm and head), copied onto ``device``."""
    out = Transformer(cfg_cut, device)
    keep = {k: v for k, v in params.state_dict().items()
            if not k.startswith("layers.")
            or int(k.split(".")[1]) < cfg_cut.n_layers}
    out.load_state_dict(keep)
    return out


def slice_logits(model, params, PagePool, prompt, steps):
    """Logits of the slice on one device: dense prefill + decode, then a
    paged prefill chunk + decode through a PagePool (reset included). Each
    step feeds the token ids in ``steps`` (the same on every device), so the
    two devices see identical inputs."""
    dev = model.device
    B, S = prompt.shape
    out = []
    with torch.inference_mode():
        cache = model.init_cache(B, S + len(steps))
        out.append(model.prefill(params, prompt.to(dev), cache))
        for t in steps:
            out.append(model.decode_step(params, t.to(dev)[:, None], cache))
        pool = PagePool(model, n_slots=B, n_pages=4 * B, page_size=16,
                        pages_per_slot=4)
        for b in range(B):
            check(pool.alloc(b, 2), "slice pool alloc")
        n_valid = torch.tensor([S - 3 * b for b in range(B)], dtype=torch.int32)
        tables = torch.as_tensor(pool.tables, device=dev)
        lengths = torch.zeros(B, dtype=torch.int32)
        lg, _ = model.paged_step(params, prompt.to(dev), pool.pages, tables,
                                 lengths.to(dev), n_valid.to(dev))
        out.append(lg)
        lengths += n_valid
        for t in steps:
            lg, _ = model.paged_step(params, t.to(dev)[:, None], pool.pages,
                                     tables, lengths.to(dev),
                                     torch.ones(B, dtype=torch.int32,
                                                device=dev))
            out.append(lg)
            lengths += 1
    return [o.float().cpu() for o in out]



# ---------------------------------------------------------------- phase 6

def max_err_by_window(out, plain, P: int) -> float:
    """Max |out - plain(a, b)| over all P columns, the plain version run on
    one window [a, b) of DP_WINDOW columns at a time."""
    err = torch.zeros((), device=out.device)
    for a in range(0, P, DP_WINDOW):
        b = min(a + DP_WINDOW, P)
        err = torch.maximum(err, (out[a:b] - plain(a, b)).abs().max())
    return err.item()


def check_clip_accumulate(dev, gen, n, P, ops, ref):
    g = torch.randn(n, P, device=dev, generator=gen)
    # clip factors as the path makes them, one silo dropped (factor 0)
    scale = torch.tensor([0.731, 1.0, 0.0, 0.418][:n], device=dev)
    out = ops.clip_accumulate(g, scale)
    err = max_err_by_window(
        out, lambda a, b: ref.clip_accumulate_ref(g[:, a:b], scale), P)
    check(err == 0.0, f"clip_accumulate differs from its plain version by "
                      f"{err}")
    w = g[:, :DP_WINDOW]
    bms, by = bound((n + 1) * P * 4, 2 * n * P)
    res = {
        "max_abs_err": err,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}",
        "ms": cuda_ms(lambda: ops.clip_accumulate(g, scale), reps=5,
                      warmup=1),
        "plain_ms": cuda_ms(lambda: ref.clip_accumulate_ref(w, scale)),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": cuda_ms(lambda: scale @ g, reps=5, warmup=1),
        "library_call": "scale @ g (cuBLAS)",
        "bound_ms": bms, "bound_by": by,
        "at": f"n={n} P={P} fp32",
    }
    return res, out, g


def check_noise_batch(dev, n, P, g_sum, ops, ref, step_keys, PRNGKey,
                      per_stream):
    keys = step_keys(PRNGKey(1), 0)
    prev = step_keys(PRNGKey(1), 1).key_xi
    # per-silo noise scales and lambda gates as corrected_noise_packed makes
    # them: silo 2 gated off (both 0), silo 1 with a lambda gate of 0
    s = 0.0750
    scales = torch.tensor([s, s, 0.0, s][:n], device=dev)
    lams = torch.tensor([0.7, 0.0, 0.0, 0.7][:n], device=dev)
    out = ops.noise_batch(g_sum, keys.key_xi, prev, scales, lams, s)
    check(bool(torch.isfinite(out).all()), "noise_batch: non-finite")
    err = max_err_by_window(out, lambda a, b: ref.noise_batch_ref(
        g_sum[a:b], keys.key_xi, prev, scales, lams, s, base=a), P)
    check(err == 0.0, f"noise_batch differs from its plain version by {err}")
    del out
    w = g_sum[:DP_WINDOW]
    parts = stream_bound(P, 2 * n, per_stream)  # xi_t, xi_{t-1} of each silo
    bms = max(parts.values())
    return {
        "max_abs_err": err,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}",
        "ms": cuda_ms(lambda: ops.noise_batch(g_sum, keys.key_xi, prev,
                                              scales, lams, s),
                      reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: ref.noise_batch_ref(
            w, keys.key_xi, prev, scales, lams, s), reps=5),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": None,
        "library_call": "none (no PyTorch call draws keyed threefry normals)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_stream": per_stream},
        "at": f"n={n} P={P} use_prev fp32",
    }


def stream_bound(P: int, streams: int, per_stream: dict,
                 words: int = 2) -> dict:
    """Milliseconds by limit for ``streams`` keyed normals an element over P
    elements: bytes (``words`` fp32 words an element, each read or written
    once: g in and the output out by default) and each pipe's share of the
    compiled stream body over its lanes, all of it over issue."""
    parts = {"bytes": words * P * 4 / HBM_BYTES_PER_S * 1e3}
    for pipe, lanes in LANES.items():
        parts[pipe] = (streams * P * per_stream[pipe]
                       / (lanes * SM_OPS_PER_S) * 1e3)
    return parts


def check_clip_mask(dev, P, g, ops, ref, keys, prev, per_stream):
    """Silo 1's contribution at the barrier tier's flags over a partial
    ring (silo 2 dropped, so its next active silo is 3), the scalars as
    ``silo_contribution`` makes them at sigma 0.3 and C 4 with 3 of 4 silos
    active, bit-equal to the plain version over all P columns; the other
    three flag combinations on the first window."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.3) * f32(4.0)  # sigma * C
    args = (f32(0.731), keys.key_r, keys.key_xi, prev, 1, 4, sc,
            f32(8.0) * sc, f32(0.7))
    kw = dict(nxt=3, noise_scale=sc / torch.sqrt(f32(3.0)),
              prev_noise_scale=sc / torch.sqrt(f32(4.0)))
    out = ops.clip_mask(g, *args, **kw)
    check(bool(torch.isfinite(out).all()), "clip_mask: non-finite")
    err = max_err_by_window(out, lambda a, b: ref.clip_mask_ref(
        g[a:b], *args, base=a, **kw), P)
    check(err == 0.0, f"clip_mask differs from its plain version by {err}")
    del out
    w = g[:DP_WINDOW]
    flags = {}
    for up, uv in ((True, False), (False, True), (False, False)):
        e = (ops.clip_mask(w, *args, up, uv, **kw)
             - ref.clip_mask_ref(w, *args, up, uv, **kw)).abs().max().item()
        check(e == 0.0, f"clip_mask pairwise={up} prev={uv} differs by {e}")
        flags[f"use_pairwise={up} use_prev={uv}"] = e
    parts = stream_bound(P, 4, per_stream)  # r_i, r_nxt, xi_t, xi_{t-1}
    bms = max(parts.values())
    return {
        "max_abs_err": err,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}; other "
                      f"flags on the first window: {flags}",
        "ms": cuda_ms(lambda: ops.clip_mask(g, *args, **kw), reps=3,
                      warmup=1),
        "plain_ms": cuda_ms(lambda: ref.clip_mask_ref(w, *args, **kw),
                            reps=5),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": None,
        "library_call": "none (no PyTorch call draws keyed threefry normals)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_stream": per_stream},
        "at": f"P={P} silo 1 nxt 3 use_pairwise use_prev fp32",
    }


# row 8's kernel in the SASS: clip_mask_kernel<false> (mangled ILb0E), or
# the untemplated clip_mask_kernel of a tree from before the external-stream
# variant; never clip_mask_kernel<true>
ROW8_SASS = r"clip_mask_kernel(ILb0E)?E"


def sass_loops(sass: str, kernel: str) -> list:
    """The innermost loops of ``kernel`` (a regular expression searched in
    the mangled name) in ``cuobjdump -sass`` text: one opcode list per loop
    body (from a backward branch's target through the branch), innermost
    meaning that no other loop lies inside it."""
    body, found = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(kernel, line) is not None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if found and m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            op = text.split()[0]
            tgt = re.search(r"0x([0-9a-f]+)", text) \
                if op.startswith("BRA") else None
            body.append((int(m.group(1), 16), op, tgt and int(tgt.group(1), 16)))
    check(bool(body), f"no SASS of {kernel}")
    loops = [(t, a) for a, _, t in body if t is not None and t <= a]
    check(bool(loops), f"no loop in the SASS of {kernel}")
    inner = [(t, a) for t, a in loops
             if not any((t, a) != (u, b) and t <= u and b <= a
                        for u, b in loops)]
    return [[op for a2, op, _ in body if t <= a2 <= a] for t, a in inner]


def library_sass() -> str:
    """``cuobjdump -sass`` of the built kernel library (next to ``nvcc``)."""
    from repro_torch.kernels import _build
    res = subprocess.run([str(Path(_build.nvcc()).with_name("cuobjdump")),
                          "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr}")
    return res.stdout


def stream_ops(sass: str, kernel: str) -> dict:
    """Arithmetic instructions one noise stream element costs in
    ``kernel``, by pipe: the innermost loop that draws the most normals
    (one ``MUFU.RSQ`` of ``sqrtf`` each), divided by that count. The
    grid-stride loop's own per-element work (load, store, index) is left
    out, which keeps the bound from these counts a lower bound."""
    best = max(sass_loops(sass, kernel),
               key=lambda ops: sum(o.startswith("MUFU.RSQ") for o in ops))
    n = sum(o.startswith("MUFU.RSQ") for o in best)
    check(n > 0, f"no loop of {kernel} draws a normal")
    rot = sum(o.startswith(("SHF.L.W", "PRMT")) for o in best)
    # each normal comes from one threefry2x32 of 20 rotations in that loop
    check(rot >= 20 * n, f"{kernel}: {rot} rotations in a loop of {n} normals")
    base = [o.split(".")[0] for o in best if ".MOV" not in o]
    count = {c: sum(o in ops for o in base) for c, ops in (
        ("alu", ALU_OPS), ("imad", IMAD_OPS), ("fp32", FP32_OPS),
        ("mufu", {"MUFU"}), ("other", OTHER_OPS))}
    per = {k: v / n for k, v in count.items()}
    return {"normals_in_loop": n, "alu": per["alu"], "imad": per["imad"],
            "fp32+imad": per["fp32"] + per["imad"], "mufu": per["mufu"],
            "issue": sum(per.values())}


def leaf_slices(layout) -> list:
    """``(leaf index, offset in the leaf, offset in the buffer, numel)`` of
    every tensor of a layout's tree: what the perleaf mask launches on."""
    out = []
    for i, (k, size, off) in enumerate(zip(layout.stacks, layout.sizes,
                                           layout.offsets)):
        m = size // k if k else size
        out += [(i, j * m, off + j * m, m) for j in range(k or 1)]
    return out


def check_zsmask(dev, layout, g, zs_ops, zs_ref, fold_leaf, folds, keys,
                 per_stream):
    """One pass of silo 1 of 4's perleaf mask over every tensor of the
    layout's tree (keys folded per leaf, counters at each tensor's offset in
    its leaf), the scalars as the barrier tier makes them at sigma 0.3 and
    C 4, bit-equal to the plain version over every element (windows of
    DP_WINDOW)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.3) * f32(4.0)
    b = f32(8.0) * sc
    slices = leaf_slices(layout)
    kr = [fold_leaf(keys.key_r, folds[0], i) for i in range(layout.n_leaves)]
    kx = [fold_leaf(keys.key_xi, folds[1], i) for i in range(layout.n_leaves)]
    out = torch.empty_like(g)

    def one_pass():
        for i, o, a, m in slices:
            zs_ops.apply_zsmask(g[a:a + m], kr[i], kx[i], 1, 4, sc, b,
                                offset=o, out=out[a:a + m])

    one_pass()
    err = torch.zeros((), device=dev)
    for i, o, a, m in slices:
        for w in range(0, m, DP_WINDOW):
            e = min(w + DP_WINDOW, m)
            plain = zs_ref.zsmask_ref(g[a + w:a + e], kr[i], kx[i], 1, 4, sc,
                                      b, offset=o + w)
            err = torch.maximum(err, (out[a + w:a + e] - plain).abs().max())
    err = err.item()
    check(err == 0.0, f"zsmask differs from its plain version by {err}")
    check(bool(torch.isfinite(out[:layout.offsets[-1]]).all()),
          "zsmask: non-finite")
    n = layout.n_params
    parts = stream_bound(n, 3, per_stream)  # r_i, r_nxt, xi
    bms = max(parts.values())
    w = g[:DP_WINDOW]
    res = {
        "max_abs_err": err,
        "checked_at": f"all {n} elements of {len(slices)} leaf tensors, "
                      f"windows of {DP_WINDOW}",
        "ms": cuda_ms(one_pass, reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: zs_ref.zsmask_ref(w, kr[0], kx[0], 1, 4,
                                                      sc, b), reps=5),
        "plain_at": f"window of {DP_WINDOW} elements",
        "library_ms": None,
        "library_call": "none (no PyTorch call draws keyed threefry normals)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_stream": per_stream},
        "at": f"one pass over the {len(slices)} leaf tensors ({n} "
              f"elements), silo 1 of 4, fp32",
    }
    del out
    return res


def leaf_columns(stacked, layout) -> list:
    """Each leaf's columns of a (B, P) buffer, rows P apart, as views."""
    return [stacked[:, off:off + size]
            for off, size in zip(layout.offsets, layout.sizes)]


def max_rel(a, b) -> float:
    return ((a - b).abs() / b.abs()).max().item()


def check_sumsq(stacked, layout, clip_ops, clip_ref):
    """``per_example_sumsq`` on every leaf's columns of the (4, P) buffer
    in place, as the perleaf clip route runs it: within SUMSQ_RTOL of the
    plain version and bit-identical across two launches."""
    cols = leaf_columns(stacked, layout)
    run = lambda: [clip_ops.sumsq(c) for c in cols]
    out, again = run(), run()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "per_example_sumsq differs between two launches")
    plain = [clip_ref.per_example_sumsq_ref(c) for c in cols]
    err = max((a - b).abs().max().item() for a, b in zip(out, plain))
    rel = max(max_rel(a, b) for a, b in zip(out, plain))
    check(rel <= SUMSQ_RTOL, f"per_example_sumsq off its plain version by "
                             f"{rel} relative")
    B, n = stacked.shape[0], layout.n_params
    bms, by = bound(B * n * 4 + len(cols) * B * 4, 2 * B * n)
    return {
        "max_abs_err": err, "max_rel_err": rel, "tolerance_rel": SUMSQ_RTOL,
        "bit_identical_relaunch": True,
        "checked_at": f"every leaf's columns, all {n} per row",
        "ms": cuda_ms(run, reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: [clip_ref.per_example_sumsq_ref(c)
                                     for c in cols], reps=3, warmup=1),
        "plain_at": "every leaf (chunked dot products)",
        "library_ms": cuda_ms(lambda: [torch.linalg.vector_norm(c, dim=1)
                                       for c in cols], reps=3, warmup=1),
        "library_call": "torch.linalg.vector_norm(g, dim=1) per leaf",
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B}, {len(cols)} leaves of qwen2.5-3b at 12 layers "
              f"({n} columns), rows P apart, fp32",
    }


def check_clip_sum(dev, stacked, noise_ops, noise_ref, clip_ref, P):
    """``clip_sum`` at C = 1 on the (4, P) buffer: norms within SUMSQ_RTOL
    of the plain version's, the sum bit-equal to the plain fold at the
    kernel's norms and within SUMSQ_RTOL of the largest value of the plain
    version's (its own norms), bit-identical across two launches."""
    c = torch.ones((), device=dev)
    s, n = noise_ops.clip_sum_packed(stacked, c)
    s2, n2 = noise_ops.clip_sum_packed(stacked, c)
    check(torch.equal(n, n2) and torch.equal(s, s2),
          "clip_sum differs between two launches")
    del s2
    ss = clip_ref.per_example_sumsq_ref(stacked)
    n_plain, scale_plain = noise_ref.clip_sum_scales(ss, c)
    rel = max_rel(n, n_plain)
    check(rel <= SUMSQ_RTOL, f"clip_sum norms off by {rel} relative")
    scale_k = torch.clamp(c / n, max=1.0)
    same = max_err_by_window(s, lambda a, b: clip_ref.clip_accumulate_ref(
        stacked[:, a:b], scale_k), P)
    check(same == 0.0, f"clip_sum's sum differs from the plain fold at its "
                       f"own norms by {same}")
    err = max_err_by_window(s, lambda a, b: clip_ref.clip_accumulate_ref(
        stacked[:, a:b], scale_plain), P)
    top = s.abs().max().item()
    check(err <= SUMSQ_RTOL * top, f"clip_sum differs from its plain version "
                                   f"by {err} (largest value {top})")
    del s
    B = stacked.shape[0]
    w = stacked[:, :DP_WINDOW]
    bms, by = bound((B * P + P + B) * 4, 4 * B * P)
    return {
        "max_abs_err": err, "norms_max_rel_err": rel,
        "sum_max_abs_err_at_kernel_norms": same, "largest_value": top,
        "tolerance": f"norms {SUMSQ_RTOL} relative; sum {SUMSQ_RTOL} of the "
                     f"largest value",
        "bit_identical_relaunch": True,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}",
        "ms": cuda_ms(lambda: noise_ops.clip_sum_packed(stacked, c), reps=3,
                      warmup=1),
        "plain_ms": cuda_ms(lambda: noise_ref.clip_sum_ref(w, c), reps=5),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": cuda_ms(lambda: torch.clamp(
            c / torch.linalg.vector_norm(stacked, dim=1), max=1.0) @ stacked,
            reps=3, warmup=1),
        "library_call": "min(1, C / vector_norm(g, dim=1)) @ g (cuBLAS)",
        "bound_ms": bms, "bound_by": by,
        "two_pass_floor_ms": (2 * B * P + P) * 4 / HBM_BYTES_PER_S * 1e3,
        "at": f"B={B} P={P} C=1 fp32",
    }


# ---------------------------------------------------------------- phase 8

def narrow_step(sess, params, batch, steps, step_keys, prng):
    """One fused-grads pass and one train step of ``sess`` from ``params``
    (moved into a fresh state): (noisy gradient, metrics, state)."""
    state = sess.init_state(params=params)
    root = prng.PRNGKey(sess.seed + 1)
    keys = step_keys(root, 0)
    dev = state.clip_bound.device
    noisy, loss, norms, ns, bound = steps._fused_grads(
        sess.model, sess.run_cfg.privacy, state.params, batch, 4, keys,
        state.noise_state, state.clip_bound, keys.key_clip, state.layout,
        steps.StageTimer(dev))
    noisy = noisy.float().cpu()
    step = steps.build_train_step(sess.model, sess.run_cfg)
    state, metrics = step(state, batch, root, timer=steps.StageTimer(dev))
    return noisy, {k: float(v) for k, v in metrics.items()}, \
        {"norms": norms.cpu(), "loss": float(loss), "bound": float(bound),
         "prev_key": ns.prev_key}, state


# ---------------------------------------------------------- phases 9, 10

def chunked_max_diff(a, b, chunk: int = 1 << 26) -> float:
    """max |a - b| over two (P,) buffers, a chunk at a time (no P-sized
    temporary)."""
    err = torch.zeros((), device=a.device)
    for i in range(0, a.shape[0], chunk):
        err = torch.maximum(err, (a[i:i + chunk] - b[i:i + chunk]).abs().max())
    return err.item()


def mask_std(contrib, g, scale, chunk: int = 1 << 26) -> float:
    """std of ``contrib - g * scale`` (a silo's contribution minus its
    clipped gradient), accumulated in float64 a chunk at a time."""
    s1 = s2 = 0.0
    for i in range(0, g.shape[0], chunk):
        d = (contrib[i:i + chunk] - g[i:i + chunk] * scale).double()
        s1 += d.sum().item()
        s2 += (d * d).sum().item()
    n = g.shape[0]
    return math.sqrt(s2 / n - (s1 / n) ** 2)


def silo_grads_packed(model, params, batch, layout, i, n, flatbuf, param_tree):
    """Silo i's rows of ``batch``: its gradient packed into a (P,) buffer,
    and its gradient tree's norm (the barrier tier's ``norm_tree``)."""
    from repro_torch.core import clipping
    rows = batch["tokens"].shape[0] // n
    b = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
    tensors = flatbuf.flat_tensors(layout, param_tree(params))
    grads = torch.autograd.grad(model.loss(params, b), tensors)
    with torch.no_grad():
        return flatbuf.pack_tensors(layout, grads), clipping.global_norm(grads)


def barrier_step_parts(sess, params, batch, ns, active, steps, step_keys,
                       prng, flatbuf, param_tree, pack_params, DPPipeline):
    """One ``_barrier_grads`` call on ``sess``'s device from ``params``
    (moved into a packed buffer), and every silo's contribution rebuilt
    from its own gradient at the step's bound."""
    layout, _ = pack_params(params)
    priv, mesh = sess.run_cfg.privacy, sess.run_cfg.mesh
    n = mesh.n_silos
    keys = step_keys(prng.PRNGKey(sess.seed + 1), 0)
    dev = sess.device
    c0 = torch.tensor(priv.clip_bound, dtype=torch.float32, device=dev)
    agg, loss, norms, new_ns, bound = steps._barrier_grads(
        sess.model, priv, mesh, params, batch, keys, ns, c0, keys.key_clip,
        layout, steps.StageTimer(dev), active=active)
    agg = flatbuf.zero_padding(layout, agg).cpu()
    pipe = DPPipeline(priv, layout, n)
    contribs = []
    for i in range(n):
        g, norm = silo_grads_packed(sess.model, params, batch, layout, i, n,
                                    flatbuf, param_tree)
        with torch.no_grad():  # in place: a tree of views under perleaf
            pipe.silo_contribution(g, i, pipe.clip_scale(norm, bound), active,
                                   keys, ns, bound, out=g)
            contribs.append(g.cpu())
    return {"agg": agg, "loss": float(loss), "bound": float(bound),
            "norms": norms.cpu(), "prev_key": new_ns.prev_key,
            "prev_active": new_ns.prev_active, "contribs": contribs}


# ------------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig, reduce_for_smoke)
    from repro_torch.core import clipping, flatbuf, masking, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.dp_pipeline import DPPipeline
    from repro_torch.core.noise_correction import NoiseState
    from repro_torch.core.noise_correction import init_state as init_noise
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.dp_clip import ref as clip_ref
    from repro_torch.kernels.dp_fused import ops as noise_ops
    from repro_torch.kernels.dp_fused import ref as noise_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.kernels.zsmask import ops as zs_ops
    from repro_torch.kernels.zsmask import ref as zs_ref
    from repro_torch.models.transformer import (Transformer, pack_params,
                                                param_tree)
    from repro_torch.runtime.serving import PagePool, zipf_requests

    t_start = time.perf_counter()
    report: dict = {}

    # 1. the card
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    report["card"] = card
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 at full precision

    # 2. build
    report["build_s"] = _build.build()
    log(f"[build] {len(_build.sources())} sources -> {_build.library_path().name} "
        f"in {report['build_s']:.1f} s")

    # 3. kernels against their plain versions, at the main path's shapes
    cfg = get_config("qwen2.5-3b")
    B_SLOTS, PAGE, CHUNK, MAX_LEN = 4, 16, 16, 512  # Session.serve defaults
    nP = MAX_LEN // PAGE
    gen = torch.Generator(device=dev).manual_seed(0)
    kern = {
        "paged_attention": check_paged_attention(
            cfg, dev, gen, B_SLOTS, nP, PAGE, 1, paged_ops, paged_ref, F),
        "flash_attention": check_flash(cfg, dev, gen, 4, 32, flash_ops,
                                       flash_ref, F),
    }
    # a speculative verify (spec_k 4) and a prefill chunk; decode is C 1
    kern["paged_attention"]["verify4"] = check_paged_attention(
        cfg, dev, gen, B_SLOTS, nP, PAGE, 4, paged_ops, paged_ref, F)
    kern["paged_attention"]["chunk16"] = check_paged_attention(
        cfg, dev, gen, B_SLOTS, nP, PAGE, CHUNK, paged_ops, paged_ref, F)
    # the page pools' zeroing: bit-equal to its plain version, then each
    # event as PagePool runs it (rows 3 and 4 of the kernel table)
    check_pool_zero(cfg, dev, gen, paged_ops, paged_ref)
    events = pool_events(cfg, dev, 0)

    def pool_row(r) -> dict:
        r = {k: x for k, x in r.items() if k != "host"}
        return {**r, "max_abs_err": 0.0, "bound_by": "bytes",
                "launch_floor_ms": events["floor"]["device_ms"],
                "library_call": "index_fill_, one call a tensor"}

    kern["paged_reset"] = {**pool_row(events["reset"]),
                           "cases": [pool_row(events["reset_draft"])]}
    kern["paged_rollback"] = {
        **pool_row(events["tick"]),
        "cases": [pool_row(events[f"range_{a}_{b}"])
                  for a, b in SINGLE_RANGES]}
    report["pool_events"] = events
    for name in ("paged_attention", "flash_attention"):
        log_attention(name, kern[name])
    log_pool_events(events)
    for sub in ("verify4", "chunk16"):
        log_attention(f"paged_attention {sub}", kern["paged_attention"][sub])

    # 4. full-width qwen2.5-3b through the user's entry points
    L, V = cfg.n_layers, cfg.vocab_size
    sess = Session.from_config("qwen2.5-3b", full=True, seed=0)
    t0 = time.perf_counter()
    params = sess.init_params()
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[serve] qwen2.5-3b full width: {n_params / 1e9:.3f} B fp32 params "
        f"on the card in {report['init_s']:.1f} s")

    sess.serve(batch_size=4, prompt_len=32, max_new_tokens=2, params=params)

    dispatch.reset_launches()
    direct = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                        params=params)
    n_direct = dispatch.launch_counts()
    check(direct.tokens.shape == (4, 16), "direct tokens shape")
    check(bool(((direct.tokens >= 0) & (direct.tokens < V)).all()),
          "direct tokens out of vocab")
    check(tuple(direct.logits.shape) == (4, V)
          and bool(torch.isfinite(direct.logits).all()), "direct logits")
    check(n_direct["flash_attention"] == L,
          f"direct prefill ran flash {n_direct['flash_attention']}x, not {L}x")
    check(n_direct["paged_attention"] == 0 and n_direct["paged_reset"] == 0,
          "direct mode touched the paged kernels")
    report["direct"] = {
        "prefill_ms": direct.prefill_s * 1e3,
        "decode_ms_per_token": direct.decode_s_per_token * 1e3,
        "decode_tok_per_s": 4 / direct.decode_s_per_token,
        "launches": n_direct}
    log(f"[serve] direct batch 4, prompt 32, 16 new: prefill "
        f"{direct.prefill_s * 1e3:.2f} ms | decode "
        f"{direct.decode_s_per_token * 1e3:.2f} ms/token step | "
        f"{4 / direct.decode_s_per_token:.1f} tok/s | launches {n_direct}")

    reqs = zipf_requests(8, V, min_len=8, max_len=48, max_new_low=8,
                         max_new_high=24, seed=0)
    runs = {}
    for kind in ("wave", "continuous"):
        dispatch.reset_launches()
        res = sess.serve(scheduler=kind, requests=copy.deepcopy(reqs),
                         params=params, max_batch=B_SLOTS, max_len=MAX_LEN,
                         page_size=PAGE, prefill_chunk=CHUNK)
        runs[kind] = (res, dispatch.launch_counts())
    (wave, n_wave), (cont, n_cont) = runs["wave"], runs["continuous"]
    check(wave.stats.drained and cont.stats.drained, "a server did not drain")
    check(bool((cont.tokens == wave.tokens).all()),
          "continuous tokens differ from wave tokens")
    check(n_wave["flash_attention"] == L * wave.stats.waves
          and n_wave["paged_attention"] == 0,
          f"wave launches {n_wave} for {wave.stats.waves} waves")
    admissions = len(reqs) + cont.stats.preemptions
    check(n_cont["paged_reset"] == admissions,
          f"continuous ran reset {n_cont['paged_reset']}x for {admissions} "
          f"admissions")
    check(n_cont["paged_attention"] > 0
          and n_cont["paged_attention"] % L == 0,
          f"continuous ran paged attention {n_cont['paged_attention']}x, not "
          f"a positive multiple of {L}")
    check(n_cont["flash_attention"] == 0, "continuous mode ran flash")
    check(n_cont["paged_rollback"] == 0, "plain continuous mode rolled back")
    # speculative: the self-draft, and a 4-layer early-exit draft over
    # prefix sharing; one launch resets both pools at an admission, one
    # erases every rejected tail of a tick in both
    rolled = {}
    for kind, draft, share in (("speculative self-draft", None, False),
                               ("speculative 4-layer draft", 4, True)):
        with rollback_ticks(PagePool) as ticks:
            dispatch.reset_launches()
            res = sess.serve(scheduler="continuous",
                             requests=copy.deepcopy(reqs), params=params,
                             max_batch=B_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE, prefill_chunk=CHUNK,
                             speculative=True, spec_k=4, draft_layers=draft,
                             prefix_sharing=share)
            n = dispatch.launch_counts()
        runs[kind] = (res, n)
        rolled[kind] = ticks[0]
        check(res.stats.drained, f"{kind}: the server did not drain")
        check(bool((res.tokens == cont.tokens).all()),
              f"{kind} tokens differ from continuous tokens")
        check(res.stats.spec_proposed > 0, f"{kind}: no proposals")
        spec_admissions = len(reqs) + res.stats.preemptions
        check(n["paged_reset"] == spec_admissions,
              f"{kind} ran reset {n['paged_reset']}x for {spec_admissions} "
              f"admissions (one launch covers both pools)")
        check(n["paged_rollback"] == rolled[kind],
              f"{kind} ran rollback {n['paged_rollback']}x for "
              f"{rolled[kind]} ticks that rolled back")
        check(n["paged_attention"] > 0 and n["flash_attention"] == 0,
              f"{kind} launches {n}")
    n_spec = runs["speculative 4-layer draft"][1]
    check(n_spec["paged_rollback"] > 0, "the early-exit run never rolled back")
    for kind, (res, n) in runs.items():
        tok_s = 1 / res.decode_s_per_token
        st = res.stats
        report[kind] = {"useful_tokens": st.useful_tokens,
                        "ticks_rolled_back": rolled.get(kind, 0),
                        "tok_per_s": tok_s,
                        "p50_latency_steps": st.p50_latency_steps,
                        "p99_latency_steps": st.p99_latency_steps,
                        "utilization": st.utilization,
                        "decode_steps": st.decode_steps,
                        "launches": n}
        spec = ""
        if kind.startswith("speculative"):
            report[kind].update(spec_proposed=st.spec_proposed,
                                spec_accepted=st.spec_accepted,
                                acceptance=st.acceptance_rate)
            spec = (f" | acceptance {st.acceptance_rate:.3f} "
                    f"({st.spec_accepted}/{st.spec_proposed})")
        log(f"[serve] {kind}: 8 requests, 4 slots: {st.useful_tokens} "
            f"tokens at {tok_s:.1f} tok/s | utilization "
            f"{st.utilization:.3f} | p50 {st.p50_latency_steps} p99 "
            f"{st.p99_latency_steps} steps | {st.decode_steps} decode steps"
            f"{spec} | launches {n}")
    log("[serve] continuous == wave and speculative == continuous token for "
        "token")

    # 5. the slice at 2 layers: card (kernels) vs host CPU (plain versions)
    cut = dataclasses.replace(cfg, n_layers=2)
    on = {"cuda": Session.from_config(cut, device="cuda"),
          "cpu": Session.from_config(cut, device="cpu")}
    p_gpu = cut_layers(params, cut, dev, Transformer)
    del params
    torch.cuda.empty_cache()
    p_cpu = cut_layers(p_gpu, cut, "cpu", Transformer)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, V, (2, 24), generator=g)
    steps = [torch.randint(0, V, (2,), generator=g) for _ in range(3)]
    dispatch.reset_launches()
    got = slice_logits(on["cuda"].model, p_gpu, PagePool, prompt, steps)
    n_slice = dispatch.launch_counts()
    want = slice_logits(on["cpu"].model, p_cpu, PagePool, prompt, steps)
    check(dispatch.launch_counts() == n_slice, "the CPU run launched a kernel")
    check(all(n_slice[k] > 0 for k in ("flash_attention", "paged_attention",
                                       "paged_reset")),
          f"the card's slice run skipped a serving kernel: {n_slice}")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    scale = max(b.abs().max().item() for b in want)
    check(all(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              for a, b in zip(got, want)),
          f"card vs CPU logits differ by {err} (|logit| up to {scale})")
    report["cross_device"] = {"max_abs_err": err, "max_abs_logit": scale,
                              "atol": CROSS_ATOL, "rtol": CROSS_RTOL}
    log(f"[slice] 2-layer full width, card vs CPU: max |logit diff| {err:.3g} "
        f"(|logit| up to {scale:.3g}; atol {CROSS_ATOL}, rtol {CROSS_RTOL})")
    sreqs = zipf_requests(3, V, min_len=8, max_len=24, max_new_low=6,
                          max_new_high=10, seed=2)
    skw = dict(scheduler="continuous", max_batch=2, max_len=64,
               page_size=PAGE, prefill_chunk=CHUNK, speculative=True,
               spec_k=4, draft_layers=1)
    dispatch.reset_launches()
    sg = on["cuda"].serve(requests=copy.deepcopy(sreqs), params=p_gpu, **skw)
    n_sg = dispatch.launch_counts()
    sc = on["cpu"].serve(requests=copy.deepcopy(sreqs), params=p_cpu, **skw)
    check(dispatch.launch_counts() == n_sg, "the CPU speculative run launched "
                                            "a kernel")
    check(n_sg["paged_attention"] > 0
          and n_sg["paged_reset"] == len(sreqs) + sg.stats.preemptions,
          f"the card's speculative slice launches {n_sg}")
    check(bool((sg.tokens == sc.tokens).all()),
          "speculative slice tokens differ between card and CPU")
    spec_stats = [(r.stats.spec_proposed, r.stats.spec_accepted)
                  for r in (sg, sc)]
    check(spec_stats[0] == spec_stats[1],
          f"speculative slice proposed/accepted card vs CPU: {spec_stats}")
    report["spec_cross_device"] = {
        "tokens": int((sg.tokens >= 0).sum()), "proposed": spec_stats[0][0],
        "accepted": spec_stats[0][1], "launches": n_sg}
    log(f"[slice] speculative, 1-layer draft, 3 requests, card vs CPU: "
        f"{report['spec_cross_device']['tokens']} tokens equal | proposed / "
        f"accepted {spec_stats[0]} on both | launches {n_sg}")
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--scheduler",
           "continuous", "--speculative", "--draft-layers", "1"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    check(r.returncode == 0 and "device=cuda" in r.stdout
          and "acceptance" in r.stdout,
          f"serving CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    acc = next(x for x in r.stdout.splitlines() if "acceptance" in x)
    report["cli_serve"] = {"cmd": " ".join(cli[1:]),
                           "s": time.perf_counter() - t0, "last": acc}
    log(f"[cli] {' '.join(cli[1:])}: exit 0 in {report['cli_serve']['s']:.1f}"
        f" s | {acc}")

    del p_gpu, p_cpu, on, sess
    torch.cuda.empty_cache()

    # 6. the DP kernels at the training path's shapes
    cut12 = dataclasses.replace(cfg, n_layers=12)
    layout = flatbuf.layout_of(param_tree(Transformer(cut12, "meta")))
    N_SILOS, P = 4, layout.total
    log(f"[dp] qwen2.5-3b at 12 layers: packed P = {P} "
        f"({layout.n_params} parameters, {layout.n_leaves} leaves)")
    gen = torch.Generator(device=dev).manual_seed(6)
    kern["clip_accumulate"], g_sum, stacked = check_clip_accumulate(
        dev, gen, N_SILOS, P, clip_ops, clip_ref)
    # the per-example kernels on the same (4, P) buffer: B = 4 examples, one
    # silo's share of the training cells' batch
    kern["per_example_sumsq"] = check_sumsq(stacked, layout, clip_ops,
                                            clip_ref)
    kern["clip_sum"] = check_clip_sum(dev, stacked, noise_ops, noise_ref,
                                      clip_ref, P)
    del stacked
    torch.cuda.empty_cache()
    sass = library_sass()
    per_stream = stream_ops(sass, "noise_batch_kernel")
    log(f"[kernel] noise_batch SASS, instructions per stream element by "
        f"pipe: {json.dumps(per_stream)}")
    kern["noise_batch"] = check_noise_batch(dev, N_SILOS, P, g_sum, noise_ops,
                                            noise_ref, step_keys, prng.PRNGKey,
                                            per_stream)
    per_stream_cm = stream_ops(sass, ROW8_SASS)
    log(f"[kernel] clip_mask SASS, instructions per stream element by pipe: "
        f"{json.dumps(per_stream_cm)}")
    kern["clip_mask"] = check_clip_mask(
        dev, P, g_sum, noise_ops, noise_ref, step_keys(prng.PRNGKey(1), 0),
        step_keys(prng.PRNGKey(1), 1).key_xi, per_stream_cm)
    per_stream_zs = stream_ops(sass, "zsmask_kernel")
    log(f"[kernel] zsmask SASS, instructions per stream element by pipe: "
        f"{json.dumps(per_stream_zs)}")
    kern["zsmask"] = check_zsmask(
        dev, layout, g_sum, zs_ops, zs_ref, masking.fold_leaf,
        (masking.R_FOLD, masking.XI_FOLD), step_keys(prng.PRNGKey(1), 0),
        per_stream_zs)
    del g_sum
    torch.cuda.empty_cache()
    for name in ("clip_accumulate", "noise_batch", "clip_mask", "zsmask",
                 "per_example_sumsq", "clip_sum"):
        r = kern[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernel] {name}: max_abs_err {r['max_abs_err']} over all P "
            f"columns | kernel "
            f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms "
            f"({r['plain_at']}) | library {lib} | bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {r['at']}")
    for name in ("per_example_sumsq", "clip_sum"):
        r = kern[name]
        log(f"[kernel] {name}: " + json.dumps({k: r[k] for k in r if k in (
            "max_rel_err", "norms_max_rel_err",
            "sum_max_abs_err_at_kernel_norms", "largest_value",
            "two_pass_floor_ms")}))
    for name in ("noise_batch", "clip_mask", "zsmask"):
        log(f"[kernel] {name} bound parts (ms): "
            f"{json.dumps(kern[name]['bound_detail'])}")

    # 7. training at full width, 12 layers, through Session.train
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=N_SILOS)
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    tsess = Session.from_config(cut12, privacy=priv, optimizer=opt, seed=0)
    t0 = time.perf_counter()
    state = tsess.init_state()
    torch.cuda.synchronize()
    check(state.layout.total == P, f"train layout {state.layout.total} != {P}")
    log(f"[train] qwen2.5-3b full width, 12 layers: {P} packed fp32 "
        f"parameters on the card in {time.perf_counter() - t0:.1f} s")
    STEPS, BATCH, SEQ = 3, 16, 64
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = tsess.train(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                      state=state, log_every=1)
    n_train = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    check(res.step == STEPS and len(res.metrics) == STEPS,
          f"trained {res.step} steps, not {STEPS}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"epsilon does not rise: {eps}")
    check(n_train["clip_accumulate"] == STEPS and n_train["noise_batch"] == STEPS,
          f"training launches {n_train}: each DP kernel once per step")
    check(all(n_train[k] == 0 for k in SERVING_KERNELS),
          f"training ran a serving kernel: {n_train}")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stage_keys = ("silo_grads", "pack", "norms", "aggregate", "noise",
                  "optimizer")
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in stage_keys}
    report["train"] = {
        "config": "qwen2.5-3b, n_layers 12 (d_model 2048, 16/2 heads, "
                  "d_ff 11008, vocab 151936), fp32",
        "P": P, "n_silos": N_SILOS, "batch": BATCH, "seq_len": SEQ,
        "loss": losses, "clip_bound": [m["clip_bound"] for m in res.metrics],
        "epsilon": eps, "step_ms": step_ms,
        "step_ms_after_first": sum(step_ms[1:]) / (STEPS - 1),
        "stage_ms": stages, "peak_mem_gb": peak / 1e9, "launches": n_train}
    log(f"[train] {STEPS} steps, batch {BATCH} x {SEQ}, 4 silos: loss "
        f"{[round(x, 4) for x in losses]} | epsilon {[round(e, 3) for e in eps]}"
        f" | step ms {[round(t, 1) for t in step_ms]} (after the first: "
        f"{report['train']['step_ms_after_first']:.1f}) | peak "
        f"{peak / 1e9:.2f} GB | launches {n_train}")
    log("[train] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, tsess
    torch.cuda.empty_cache()

    # 7b. per-example clipping at full width, 12 layers, both routes
    pe = Session.from_config(cut12, seed=0)
    params = pe.init_params()
    layout7 = flatbuf.layout_of(param_tree(params))
    pe_batch = pe.synthetic_batches(4, SEQ)()
    routes = {}
    for impl in ("packed", "perleaf", "packed", "perleaf"):  # cold, warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        summed, norms, loss = clipping.per_example_clipped_grad(
            pe.model.loss, params, pe_batch, 1.0, impl=impl)
        torch.cuda.synchronize()
        cold = routes.get(impl, {}).get("s")
        routes[impl] = {
            "s": time.perf_counter() - t0, "cold_s": cold,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_above_start_gb":
                (torch.cuda.max_memory_allocated() - start) / 1e9,
            "launches": {k: v for k, v in dispatch.launch_counts().items()
                         if v},
            "loss": float(loss), "norms": norms, "sum": summed}
    n_pe = {"clip_sum": routes["packed"]["launches"].get("clip_sum", 0),
            "per_example_sumsq":
                routes["perleaf"]["launches"].get("per_example_sumsq", 0)}
    L7 = layout7.n_leaves
    check(routes["packed"]["launches"] == {"clip_sum": 1},
          f"packed route launches {routes['packed']['launches']}")
    check(routes["perleaf"]["launches"] == {"per_example_sumsq": L7,
                                            "clip_accumulate": L7},
          f"perleaf route launches {routes['perleaf']['launches']}")
    na, nb = routes["packed"]["norms"], routes["perleaf"]["norms"]
    pe_rel = max_rel(na, nb)
    pe_err = max((a - b).abs().max().item() for a, b in zip(
        flatbuf.flat_tensors(layout7, routes["packed"]["sum"]),
        flatbuf.flat_tensors(layout7, routes["perleaf"]["sum"])))
    pe_top = max(t.abs().max().item() for t in flatbuf.flat_tensors(
        layout7, routes["packed"]["sum"]))
    check(pe_rel <= ROUTES_RTOL and pe_err <= ROUTES_RTOL * pe_top
          and math.isclose(routes["packed"]["loss"], routes["perleaf"]["loss"],
                           rel_tol=ROUTES_RTOL),
          f"per-example routes disagree: norms {pe_rel} relative, sums "
          f"{pe_err} (largest {pe_top})")
    report["per_example"] = {
        "config": report["train"]["config"], "P": layout7.total,
        "examples": 4, "seq_len": SEQ, "clip_bound": 1.0,
        "norms": na.tolist(), "norms_max_rel_err": pe_rel,
        "sum_max_abs_err": pe_err, "sum_largest": pe_top,
        **{impl: {k: r[k] for k in ("s", "cold_s", "peak_mem_gb",
                                    "peak_above_start_gb", "launches",
                                    "loss")}
           for impl, r in routes.items()}}
    log(f"[per-example] qwen2.5-3b full width, 12 layers, 4 examples x {SEQ}"
        f" (second call of each; the first: packed "
        f"{routes['packed']['cold_s'] * 1e3:.1f} ms, perleaf "
        f"{routes['perleaf']['cold_s'] * 1e3:.1f} ms): "
        f"packed {routes['packed']['s'] * 1e3:.1f} ms, peak "
        f"{routes['packed']['peak_mem_gb']:.2f} GB, launches "
        f"{routes['packed']['launches']} | perleaf "
        f"{routes['perleaf']['s'] * 1e3:.1f} ms, peak "
        f"{routes['perleaf']['peak_mem_gb']:.2f} GB, launches "
        f"{routes['perleaf']['launches']} | norms {[round(x, 3) for x in na.tolist()]}"
        f" agree to {pe_rel:.3g} | sums to {pe_err:.3g} (largest {pe_top:.3g})")
    del routes, params, pe, summed, norms, na, nb
    torch.cuda.empty_cache()

    # 8. one training step of a narrow config, card (kernels) vs CPU (plain)
    narrow = reduce_for_smoke(cfg, n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=2, d_head=64, d_ff=512,
                              vocab_size=4096)
    # the cap raised, so the bound is the percentile protocol's noisy
    # median (sort, linear quantile, threefry normal), not a clamped constant
    priv_c = dataclasses.replace(priv, clip_percentile_max=NARROW_CAP)
    sess_c = {d: Session.from_config(narrow, privacy=priv_c, optimizer=opt,
                                     seed=3, device=d) for d in ("cuda", "cpu")}
    p_cpu = sess_c["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    batch = batch8 = sess_c["cpu"].synthetic_batches(16, 32)()
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        out[d] = narrow_step(sess_c[d], p, {k: v.to(d) for k, v in batch.items()},
                             steps_mod, step_keys, prng)
        out[d] += (dispatch.launch_counts(),)
    (n_g, m_g, x_g, s_g, c_g), (n_c, m_c, x_c, s_c, c_c) = out["cuda"], out["cpu"]
    check(c_g["clip_accumulate"] == 2 and c_g["noise_batch"] == 2,
          f"narrow card step launches {c_g}")
    check(all(v == 0 for v in c_c.values()), f"the CPU step launched {c_c}")
    check(x_g["prev_key"] == x_c["prev_key"]
          and s_g.noise_state.prev_key == s_c.noise_state.prev_key,
          "carried noise key differs between card and CPU")
    check(max(m_g["clip_bound"], m_c["clip_bound"]) < NARROW_CAP,
          f"narrow step bound at the cap: card {m_g['clip_bound']}, CPU "
          f"{m_c['clip_bound']}")
    for k in ("loss", "clip_bound", "grad_norm_mean"):
        check(math.isclose(m_g[k], m_c[k], rel_tol=TRAIN_RTOL),
              f"narrow step {k}: card {m_g[k]} vs CPU {m_c[k]}")
    check(torch.allclose(x_g["norms"], x_c["norms"], rtol=TRAIN_RTOL, atol=0),
          f"norms {x_g['norms']} vs {x_c['norms']}")
    noisy_err = (n_g - n_c).abs().max().item()
    check(noisy_err <= NOISY_ATOL, f"noisy gradient differs by {noisy_err}")
    dp = (s_g.opt_state["master"].cpu() - s_c.opt_state["master"]).abs()
    flips = int((dp > PARAM_ATOL).sum())
    check(dp.max().item() <= 2 * opt.lr * 1.001 and flips <= PARAM_FLIPS,
          f"params differ: max {dp.max().item()}, {flips} beyond {PARAM_ATOL}")
    report["train_cross_device"] = {
        "P": s_c.layout.total, "loss": [m_g["loss"], m_c["loss"]],
        "clip_bound": [m_g["clip_bound"], m_c["clip_bound"]],
        "noisy_max_abs_err": noisy_err,
        "noisy_max_abs": n_c.abs().max().item(),
        "param_max_abs_err": dp.max().item(), "param_beyond_atol": flips}
    log(f"[train-slice] narrow config (P {s_c.layout.total}), card vs CPU: "
        f"loss {m_g['loss']:.6f} / {m_c['loss']:.6f} | bound "
        f"{m_g['clip_bound']:.6f} / {m_c['clip_bound']:.6f} | noisy grad max "
        f"|diff| {noisy_err:.3g} (|g| up to {n_c.abs().max().item():.3g}) | "
        f"params max |diff| {dp.max().item():.3g}, {flips} beyond "
        f"{PARAM_ATOL} | prev_key equal")

    # 9. the barrier tier at full width, 12 layers
    mesh4 = MeshConfig((N_SILOS,), ("data",))
    priv_b = dataclasses.replace(priv, sync_path="barrier")
    bsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                mesh=mesh4, seed=0)
    params = bsess.init_params()
    layout9, _ = pack_params(params)
    batch9 = bsess.synthetic_batches(BATCH, SEQ)()
    keys9 = step_keys(prng.PRNGKey(1), 0)
    ns9 = init_noise(prng.fold_in(prng.PRNGKey(0), 0xD0), N_SILOS)
    c0 = torch.tensor(priv.clip_bound, dtype=torch.float32, device=dev)
    grads_args = (batch9, keys9, ns9, c0, keys9.key_clip, layout9,
                  steps_mod.StageTimer(dev))
    f_agg, f_loss, _, _, f_bound = steps_mod._fused_grads(
        bsess.model, priv, params, grads_args[0], N_SILOS, *grads_args[1:])
    flatbuf.zero_padding(layout9, f_agg)
    torch.cuda.reset_peak_memory_stats()
    b_agg, b_loss, _, _, b_bound = steps_mod._barrier_grads(
        bsess.model, priv_b, mesh4, params, *grads_args)
    peak_grads = torch.cuda.max_memory_allocated()
    flatbuf.zero_padding(layout9, b_agg)
    B9 = priv.mask_scale * priv.sigma * float(b_bound)
    agg_err = chunked_max_diff(b_agg, f_agg)
    agg_tol = MASK_ATOL_PER_B * B9
    check(agg_err <= agg_tol, f"barrier vs fused aggregate differ by "
                              f"{agg_err} (tolerance {agg_tol}, B {B9})")
    check(math.isclose(float(b_loss), float(f_loss), rel_tol=TRAIN_RTOL)
          and math.isclose(float(b_bound), float(f_bound), rel_tol=TRAIN_RTOL),
          f"barrier vs fused loss {float(b_loss)} / {float(f_loss)}, bound "
          f"{float(b_bound)} / {float(f_bound)}")
    agg_max = f_agg.abs().max().item()
    del b_agg, f_agg
    torch.cuda.empty_cache()
    # silo 0's contribution minus its clipped gradient: the mask (and its
    # noise share), std sqrt(2 B^2 + s^2) = B sqrt(2) (1 + 1/1024)
    g0, norm0 = silo_grads_packed(bsess.model, params, batch9, layout9, 0,
                                  N_SILOS, flatbuf, param_tree)
    with torch.no_grad():
        pipe9 = DPPipeline(priv_b, layout9, N_SILOS)
        scale0 = pipe9.clip_scale(norm0, b_bound)
        contrib0 = pipe9.silo_contribution(g0, 0, scale0, None, keys9, ns9,
                                           b_bound)
        std0 = mask_std(contrib0, g0, scale0)
    check(abs(std0 / (B9 * math.sqrt(2)) - 1) < 0.01,
          f"contribution minus clipped gradient has std {std0}, not about "
          f"B*sqrt(2) = {B9 * math.sqrt(2)}")
    report["barrier_vs_fused"] = {
        "aggregate_max_abs_err": agg_err, "tolerance": agg_tol, "B": B9,
        "aggregate_max_abs": agg_max, "loss": [float(b_loss), float(f_loss)],
        "bound": [float(b_bound), float(f_bound)], "mask_std": std0,
        "B_sqrt2": B9 * math.sqrt(2),
        "peak_mem_gb_barrier_grads": peak_grads / 1e9}
    log(f"[barrier] full width, 12 layers, first step: barrier vs fused "
        f"aggregate max |diff| {agg_err:.3g} (|g| up to {agg_max:.3g}; "
        f"tolerance {agg_tol:.3g} from B {B9:.4f}) | loss {float(b_loss):.6f}"
        f" / {float(f_loss):.6f} | bound {float(b_bound):.6f} / "
        f"{float(f_bound):.6f} | silo 0's contribution minus its clipped "
        f"gradient: std {std0:.4f} (B*sqrt(2) = {B9 * math.sqrt(2):.4f}) | "
        f"peak {peak_grads / 1e9:.2f} GB in _barrier_grads")
    del g0, contrib0, params, bsess, pipe9
    torch.cuda.empty_cache()

    tsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                mesh=mesh4, seed=0)
    state = tsess.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = tsess.train(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                      state=state, log_every=1)
    n_barrier = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    check(res.step == STEPS and len(res.metrics) == STEPS,
          f"barrier trained {res.step} steps, not {STEPS}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"epsilon does not rise: {eps}")
    check(n_barrier["clip_mask"] == N_SILOS * STEPS
          and n_barrier["clip_accumulate"] == 0
          and n_barrier["noise_batch"] == 0
          and all(n_barrier[k] == 0 for k in SERVING_KERNELS),
          f"barrier launches {n_barrier}: clip_mask {N_SILOS} a step, no "
          f"other kernel")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stage_keys = ("silo_grads", "norms", "pack", "contributions", "reduce",
                  "optimizer")
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in stage_keys}
    report["barrier"] = {
        "config": report["train"]["config"], "mesh": [N_SILOS],
        "P": P, "batch": BATCH, "seq_len": SEQ, "loss": losses,
        "clip_bound": [m["clip_bound"] for m in res.metrics],
        "epsilon": eps, "step_ms": step_ms,
        "step_ms_after_first": sum(step_ms[1:]) / (STEPS - 1),
        "stage_ms": stages, "peak_mem_gb": peak / 1e9,
        "launches": n_barrier}
    log(f"[barrier] {STEPS} steps, batch {BATCH} x {SEQ}, mesh (4,): loss "
        f"{[round(x, 4) for x in losses]} | epsilon "
        f"{[round(e, 3) for e in eps]} | step ms "
        f"{[round(t, 1) for t in step_ms]} (after the first: "
        f"{report['barrier']['step_ms_after_first']:.1f}) | peak "
        f"{peak / 1e9:.2f} GB | launches {n_barrier}")
    log("[barrier] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, tsess
    torch.cuda.empty_cache()

    # 9b. the barrier tier under the per-leaf policy, same width and depth
    n_slices = len(leaf_slices(layout))
    perleaf = dispatch.force_impl("perleaf", kernel="dp_noise_tree")
    with perleaf:
        bsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                    mesh=mesh4, seed=0)
        params = bsess.init_params()
        layout9, _ = pack_params(params)
        batch9 = bsess.synthetic_batches(BATCH, SEQ)()
        primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                            np.ones(N_SILOS, bool))
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        agg, _, _, _, bound9 = steps_mod._barrier_grads(
            bsess.model, priv_b, mesh4, params, batch9, keys9, primed, c0,
            keys9.key_clip, layout9, steps_mod.StageTimer(dev))
        n_one = dispatch.launch_counts()
        peak_one = torch.cuda.max_memory_allocated()
        agg = flatbuf.zero_padding(layout9, agg.clone())  # frees the rows
        check(n_one["zsmask"] == 2 * N_SILOS * n_slices
              and sum(n_one.values()) == n_one["zsmask"],
              f"perleaf barrier step launches {n_one}: zsmask 2 x {N_SILOS} "
              f"x {n_slices}, no other kernel")
        clipped = torch.zeros_like(agg)
        for i in range(N_SILOS):
            g, norm = silo_grads_packed(bsess.model, params, batch9, layout9,
                                        i, N_SILOS, flatbuf, param_tree)
            with torch.no_grad():
                clipped.add_(g * clipping.clip_scale(norm, bound9))
            del g
        # the aggregate minus sum_i clip(g_i): sigma_c (xi_t - lam xi_{t-1})
        # if the +-b r terms cancel (else std about 8 sigma_c)
        std9 = mask_std(agg, clipped, 1.0)
        want9 = priv.sigma * float(bound9) * math.sqrt(
            1 + priv.noise_lambda ** 2)
        check(abs(std9 / want9 - 1) < 0.01,
              f"perleaf aggregate minus the clipped sum has std {std9}, not "
              f"sigma_c sqrt(1 + lam^2) = {want9}")
        del agg, clipped, params, bsess
        torch.cuda.empty_cache()
        tsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                    mesh=mesh4, seed=0)
        state = tsess.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        res = tsess.train(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                          state=state, log_every=1)
        n_perleaf = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    check(res.step == STEPS and all(math.isfinite(x) for x in losses),
          f"perleaf barrier: {res.step} steps, loss {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"epsilon does not rise: {eps}")
    check(n_perleaf["zsmask"] == STEPS * 2 * N_SILOS * n_slices
          and sum(n_perleaf.values()) == n_perleaf["zsmask"],
          f"perleaf barrier launches {n_perleaf}: zsmask {STEPS} x 2 x "
          f"{N_SILOS} x {n_slices}, no other kernel")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in stage_keys}
    report["barrier_perleaf"] = {
        "config": report["train"]["config"], "mesh": [N_SILOS],
        "policy": "perleaf (force_impl dp_noise_tree)", "P": P,
        "leaf_tensors": n_slices, "batch": BATCH, "seq_len": SEQ,
        "loss": losses, "clip_bound": [m["clip_bound"] for m in res.metrics],
        "epsilon": eps, "step_ms": step_ms,
        "step_ms_after_first": sum(step_ms[1:]) / (STEPS - 1),
        "stage_ms": stages, "peak_mem_gb": peak / 1e9,
        "launches": n_perleaf, "one_step_launches": n_one,
        "one_step_peak_mem_gb": peak_one / 1e9,
        "noise_std": std9, "noise_std_expected": want9}
    log(f"[barrier-perleaf] one primed step: aggregate minus sum clip(g_i) "
        f"std {std9:.5f} (sigma_c sqrt(1 + lam^2) = {want9:.5f}) | "
        f"{STEPS} steps: loss {[round(x, 4) for x in losses]} | epsilon "
        f"{[round(e, 3) for e in eps]} | step ms "
        f"{[round(t, 1) for t in step_ms]} (after the first: "
        f"{report['barrier_perleaf']['step_ms_after_first']:.1f}) | peak "
        f"{peak / 1e9:.2f} GB | launches {n_perleaf}")
    log("[barrier-perleaf] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, tsess
    torch.cuda.empty_cache()

    # 10. one barrier step of the narrow config, card (kernels) vs CPU
    priv_cb = dataclasses.replace(priv_c, sync_path="barrier")
    sess_b = {d: Session.from_config(narrow, privacy=priv_cb, optimizer=opt,
                                     mesh=mesh4, seed=3, device=d)
              for d in ("cuda", "cpu")}
    p_cpu = sess_b["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    batch = batch10 = sess_b["cpu"].synthetic_batches(16, 32)()
    act10 = np.array([True, False, True, True])  # silo 0's next is 2
    primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                        np.array([True, True, False, True]))
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        out[d] = barrier_step_parts(
            sess_b[d], p, {k: v.to(d) for k, v in batch.items()}, primed,
            act10, steps_mod, step_keys, prng, flatbuf, param_tree,
            pack_params, DPPipeline)
        out[d]["launches"] = dispatch.launch_counts()
    xg, xc = out["cuda"], out["cpu"]
    check(xg["launches"]["clip_mask"] == 2 * N_SILOS
          and sum(xg["launches"].values()) == 2 * N_SILOS,
          f"narrow barrier card launches {xg['launches']}")
    check(all(v == 0 for v in xc["launches"].values()),
          f"the CPU barrier step launched {xc['launches']}")
    check(xg["prev_key"] == xc["prev_key"]
          and np.array_equal(xg["prev_active"], xc["prev_active"]),
          "carried noise state differs between card and CPU")
    check(max(xg["bound"], xc["bound"]) < NARROW_CAP,
          f"narrow barrier bound at the cap: {xg['bound']} / {xc['bound']}")
    for k in ("loss", "bound"):
        check(math.isclose(xg[k], xc[k], rel_tol=TRAIN_RTOL),
              f"narrow barrier {k}: card {xg[k]} vs CPU {xc[k]}")
    check(torch.allclose(xg["norms"], xc["norms"], rtol=TRAIN_RTOL, atol=0),
          f"norms {xg['norms']} vs {xc['norms']}")
    B10 = priv.mask_scale * priv.sigma * xc["bound"]
    tol10 = BARRIER_ATOL_PER_B * B10
    c_err = [(a - b).abs().max().item()
             for a, b in zip(xg["contribs"], xc["contribs"])]
    a_err = (xg["agg"] - xc["agg"]).abs().max().item()
    check(max(c_err) <= tol10 and a_err <= tol10,
          f"narrow barrier contributions differ by {c_err}, aggregate by "
          f"{a_err} (tolerance {tol10})")
    check(not xg["contribs"][1].any() and not xc["contribs"][1].any(),
          "the dropped silo contributed")
    report["barrier_cross_device"] = {
        "P": xc["agg"].shape[0], "active": act10.tolist(),
        "loss": [xg["loss"], xc["loss"]], "bound": [xg["bound"], xc["bound"]],
        "contribution_max_abs_err": c_err, "aggregate_max_abs_err": a_err,
        "tolerance": tol10,
        "contribution_max_abs": max(c.abs().max().item()
                                    for c in xc["contribs"])}
    log(f"[barrier-slice] narrow config (P {xc['agg'].shape[0]}), active "
        f"{act10.astype(int).tolist()}, primed state: loss {xg['loss']:.6f} /"
        f" {xc['loss']:.6f} | bound {xg['bound']:.6f} / {xc['bound']:.6f} | "
        f"contributions max |diff| {[f'{e:.3g}' for e in c_err]} (|c| up to "
        f"{report['barrier_cross_device']['contribution_max_abs']:.3g}) | "
        f"aggregate {a_err:.3g} (tolerance {tol10:.3g}) | prev_key equal")
    del p_gpu, out, xg
    torch.cuda.empty_cache()

    # 10b. the narrow config's per-example clipping (both routes) and one
    # fused and one barrier step under the per-leaf policy, card vs CPU
    sess_p = {d: Session.from_config(narrow, seed=3, device=d)
              for d in ("cuda", "cpu")}
    p_cpu = sess_p["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    batch = sess_p["cpu"].synthetic_batches(4, 32)()
    narrow_layout = flatbuf.layout_of(param_tree(p_cpu))
    cross = {}
    for impl in ("packed", "perleaf"):
        dispatch.reset_launches()
        a = clipping.per_example_clipped_grad(
            sess_p["cuda"].model.loss, p_gpu,
            {k: v.to(dev) for k, v in batch.items()}, 1.0, impl=impl)
        card_launches = {k: v for k, v in dispatch.launch_counts().items()
                         if v}
        b = clipping.per_example_clipped_grad(
            sess_p["cpu"].model.loss, p_cpu, batch, 1.0, impl=impl)
        sa = flatbuf.pack(narrow_layout, a[0]).cpu()
        sb = flatbuf.pack(narrow_layout, b[0])
        err, top = (sa - sb).abs().max().item(), sb.abs().max().item()
        rel = max_rel(a[1].cpu(), b[1])
        check(rel <= TRAIN_RTOL and err <= TRAIN_RTOL * top
              and math.isclose(float(a[2]), float(b[2]), rel_tol=TRAIN_RTOL),
              f"narrow per-example {impl}: norms {rel}, sums {err} (largest "
              f"{top}), loss {float(a[2])} / {float(b[2])}")
        cross[impl] = {"norms_max_rel_err": rel, "sum_max_abs_err": err,
                       "sum_largest": top, "card_launches": card_launches}
    check(cross["packed"]["card_launches"] == {"clip_sum": 1}
          and cross["perleaf"]["card_launches"] == {
              "per_example_sumsq": narrow_layout.n_leaves,
              "clip_accumulate": narrow_layout.n_leaves},
          f"narrow per-example launches {cross}")
    with dispatch.force_impl("perleaf", kernel="dp_noise_tree"):
        out = {}
        for d in ("cuda", "cpu"):
            p = sess_c["cpu"].init_params()
            dispatch.reset_launches()
            out[d] = narrow_step(sess_c[d], p.to(d), {
                k: v.to(d) for k, v in batch8.items()}, steps_mod, step_keys,
                prng) + (dispatch.launch_counts(),)
        (n_g, m_g, x_g, s_g, c_g), (n_c, m_c, x_c, s_c, c_c) = \
            out["cuda"], out["cpu"]
        check(c_g["clip_accumulate"] == 2 and sum(c_g.values()) == 2
              and not any(c_c.values()),
              f"narrow perleaf fused launches: card {c_g}, CPU {c_c}")
        check(x_g["prev_key"] == x_c["prev_key"]
              and s_g.noise_state.prev_key == s_c.noise_state.prev_key,
              "perleaf fused: carried noise key differs between card and CPU")
        for k in ("loss", "clip_bound", "grad_norm_mean"):
            check(math.isclose(m_g[k], m_c[k], rel_tol=TRAIN_RTOL),
                  f"narrow perleaf fused {k}: card {m_g[k]} vs CPU {m_c[k]}")
        f_err = (n_g - n_c).abs().max().item()
        check(f_err <= NOISY_ATOL,
              f"narrow perleaf fused noisy gradient differs by {f_err}")
        primed_full = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                                 np.ones(N_SILOS, bool))
        out = {}
        for d in ("cuda", "cpu"):
            p = sess_b["cpu"].init_params()
            dispatch.reset_launches()
            out[d] = barrier_step_parts(
                sess_b[d], p.to(d), {k: v.to(d) for k, v in batch10.items()},
                primed_full, None, steps_mod, step_keys, prng, flatbuf,
                param_tree, pack_params, DPPipeline)
            out[d]["launches"] = dispatch.launch_counts()
    xg, xc = out["cuda"], out["cpu"]
    narrow_slices = len(leaf_slices(narrow_layout))
    check(xg["launches"]["zsmask"] == 2 * 2 * N_SILOS * narrow_slices
          and sum(xg["launches"].values()) == xg["launches"]["zsmask"]
          and not any(xc["launches"].values()),
          f"narrow perleaf barrier launches: card {xg['launches']}, CPU "
          f"{xc['launches']}")
    check(xg["prev_key"] == xc["prev_key"],
          "perleaf barrier: carried noise key differs between card and CPU")
    for k in ("loss", "bound"):
        check(math.isclose(xg[k], xc[k], rel_tol=TRAIN_RTOL),
              f"narrow perleaf barrier {k}: card {xg[k]} vs CPU {xc[k]}")
    tol = BARRIER_ATOL_PER_B * priv.mask_scale * priv.sigma * xc["bound"]
    pc_err = [(a - b).abs().max().item()
              for a, b in zip(xg["contribs"], xc["contribs"])]
    pa_err = (xg["agg"] - xc["agg"]).abs().max().item()
    check(max(pc_err) <= tol and pa_err <= tol,
          f"narrow perleaf barrier contributions differ by {pc_err}, "
          f"aggregate by {pa_err} (tolerance {tol})")
    report["perleaf_cross_device"] = {
        "per_example": cross, "fused_noisy_max_abs_err": f_err,
        "fused_loss": [m_g["loss"], m_c["loss"]],
        "barrier_contribution_max_abs_err": pc_err,
        "barrier_aggregate_max_abs_err": pa_err, "barrier_tolerance": tol,
        "barrier_launches": xg["launches"]["zsmask"]}
    log(f"[perleaf-slice] narrow config, card vs CPU: per-example norms "
        f"{cross['packed']['norms_max_rel_err']:.3g} / "
        f"{cross['perleaf']['norms_max_rel_err']:.3g} relative (packed / "
        f"perleaf), sums {cross['packed']['sum_max_abs_err']:.3g} / "
        f"{cross['perleaf']['sum_max_abs_err']:.3g} | perleaf fused step: "
        f"noisy grad {f_err:.3g}, loss {m_g['loss']:.6f} / {m_c['loss']:.6f}"
        f" | perleaf barrier step: contributions {max(pc_err):.3g}, "
        f"aggregate {pa_err:.3g} (tolerance {tol:.3g}), {xg['launches']['zsmask']}"
        f" zsmask launches | keys equal")
    del p_gpu, out, xg, xc, sess_p
    torch.cuda.empty_cache()

    cli = [sys.executable, "-m", "repro_torch.launch.train", "--sync-path",
           "barrier", "--silos", "4", "--steps", "2", "--drop-silos", "1:2"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    check(r.returncode == 0
          and "done at step 2 on cuda (barrier tier)" in r.stdout,
          f"training CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    done = next(x for x in r.stdout.splitlines() if x.startswith("done"))
    report["cli"] = {"cmd": " ".join(cli[1:]), "s": time.perf_counter() - t0,
                     "last": done}
    log(f"[cli] {' '.join(cli[1:])}: exit 0 in {report['cli']['s']:.1f} s | "
        f"{report['cli']['last']}")
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--sync-path",
           "barrier", "--silos", "4", "--steps", "2"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={
                           **os.environ, "PYTHONPATH": str(ROOT / "src"),
                           "REPRO_KERNEL_IMPL": "dp_noise_tree=perleaf"})
    check(r.returncode == 0
          and "done at step 2 on cuda (barrier tier)" in r.stdout,
          f"perleaf training CLI failed ({r.returncode}):\n{r.stdout}\n"
          f"{r.stderr}")
    done = next(x for x in r.stdout.splitlines() if x.startswith("done"))
    report["cli_perleaf"] = {
        "cmd": "REPRO_KERNEL_IMPL=dp_noise_tree=perleaf " + " ".join(cli[1:]),
        "s": time.perf_counter() - t0, "last": done}
    log(f"[cli] {report['cli_perleaf']['cmd']}: exit 0 in "
        f"{report['cli_perleaf']['s']:.1f} s | {done}")
    del sess_b, sess_c, p_cpu, batch, batch8, batch10
    torch.cuda.empty_cache()

    # 11. the scans and flash at d_head 112, at the SSM/hybrid paths' shapes
    rcfg, zcfg = get_config("rwkv6-7b"), get_config("zamba2-7b")
    gen = torch.Generator(device=dev).manual_seed(11)
    kern.update(check_scans(dev, 11))
    log_scan_launches(rcfg, zcfg)
    d112 = check_flash(zcfg, dev, gen, 4, 32, flash_ops, flash_ref, F)
    kern["flash_attention"]["d112"] = d112
    log_attention("flash_attention d_head 112", d112)

    # 12-13. rwkv6-7b and zamba2-7b at full width and depth
    ssm_reqs = zipf_requests(8, 32000, min_len=8, max_len=48, max_new_low=8,
                             max_new_high=24, seed=0)
    g_z = zcfg.n_layers // zcfg.attn_every
    report["rwkv6"] = serve_family(
        Session, "rwkv6-7b", {}, {"wkv": rcfg.n_layers}, ssm_reqs, "rwkv6")
    torch.cuda.empty_cache()
    report["zamba2"] = serve_family(
        Session, "zamba2-7b",
        {"ssd": zcfg.n_layers, "flash_attention": g_z},
        {"ssd": zcfg.n_layers, "flash_attention": g_z}, ssm_reqs, "zamba2")
    torch.cuda.empty_cache()

    # 14. narrow configs at the kernels' widths, card vs CPU
    narrow_r = reduce_for_smoke(rcfg, n_layers=2, d_model=256, n_heads=4,
                                n_kv_heads=4, d_head=64, rwkv_head_size=64,
                                d_ff=512, vocab_size=4096)
    narrow_z = reduce_for_smoke(zcfg, n_layers=4, d_model=256, n_heads=2,
                                n_kv_heads=2, d_head=112, d_ff=512,
                                vocab_size=4096, ssm_state=64,
                                mamba_headdim=64, attn_every=2)
    x_reqs = zipf_requests(4, 4096, min_len=8, max_len=24, max_new_low=4,
                           max_new_high=8, seed=3)
    report["ssm_cross_device"] = {
        "rwkv6": family_cross_device(Session, narrow_r, x_reqs, "ssm-slice"),
        "zamba2": family_cross_device(Session, narrow_z, x_reqs,
                                      "ssm-slice")}

    # 15. the serving CLI on the card, wave mode, both families
    for arch in ("rwkv6-7b", "zamba2-7b"):
        cli = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               arch, "--scheduler", "wave"]
        t0 = time.perf_counter()
        r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                           timeout=600, env={**os.environ,
                                             "PYTHONPATH": str(ROOT / "src")})
        check(r.returncode == 0 and "device=cuda" in r.stdout
              and "utilization" in r.stdout,
              f"serving CLI {arch} failed ({r.returncode}):\n{r.stdout}\n"
              f"{r.stderr}")
        util = next(x for x in r.stdout.splitlines() if "utilization" in x)
        report[f"cli_serve_{arch}"] = {"cmd": " ".join(cli[1:]),
                                       "s": time.perf_counter() - t0,
                                       "last": util}
        log(f"[cli] {' '.join(cli[1:])}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s | {util}")

    # 16. the wire tier on the card
    report["wire"], kern["clip_mask"]["wire"], stream_rows = wire_phase(
        dev, per_stream_cm)
    kern.update(stream_rows)

    # the record
    launches = {"flash_attention": n_direct["flash_attention"],
                "paged_attention": n_cont["paged_attention"],
                "paged_reset": n_cont["paged_reset"],
                "paged_rollback": n_spec["paged_rollback"],
                "clip_accumulate": n_train["clip_accumulate"],
                "noise_batch": n_train["noise_batch"],
                "clip_mask": n_barrier["clip_mask"],
                "zsmask": n_perleaf["zsmask"],
                "per_example_sumsq": n_pe["per_example_sumsq"],
                "clip_sum": n_pe["clip_sum"],
                "wkv": report["rwkv6"]["wave"]["launches"]["wkv"],
                "ssd": report["zamba2"]["direct"]["launches"]["ssd"],
                **{k: r["launches"] for k, r in stream_rows.items()}}
    check(set(kern) == set(dispatch.KERNELS) == set(launches),
          f"the kernels line covers {sorted(kern)}, the registry "
          f"{sorted(dispatch.KERNELS)}")
    line = []
    for name, r in kern.items():
        k = dispatch.KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": k.source,
                 "replaces": k.replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "at": r["at"]}
        for extra in ("checked_at", "plain_at", "library_call",
                      "bound_detail", "cases", "device_ms", "max_rel_err",
                      "launch_floor_ms", "checked",
                      "norms_max_rel_err", "tolerance", "tolerance_rel",
                      "two_pass_floor_ms", "library_device_ms"):
            if extra in r:
                entry[extra] = r[extra]
        for sub in ("verify4", "chunk16", "d112", "s512", "wire"):
            if sub in r:
                entry[sub] = {x: r[sub][x] for x in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "library_ms", "library_device_ms", "bound_ms",
                    "bound_by", "launch_floor_ms", "at") if x in r[sub]}
        if "wire" in r:
            entry["wire"]["launches"] = r["wire"]["launches"]
        line.append(entry)
    report["total_s"] = time.perf_counter() - t_start
    log(f"[report] {json.dumps(report)}")
    log(f"[done] {report['total_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    src = Path(args[args.index("--src") + 1]).resolve() \
        if "--src" in args else ROOT / "src"
    for phase in ("scans", "pool", "wire"):
        if f"--{phase}" in args:
            sys.exit(one_phase(phase, src))
    sys.exit(main())
