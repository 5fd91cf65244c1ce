#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100):
builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version at the serving path's full-width shapes, serves qwen2.5-3b at
its published width through ``repro_torch.api.Session`` (direct, wave and
continuous modes) and checks the slice against the host CPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the kernel build (nvcc, sm_90a) into ``build/``, with its time;
  3. each kernel against its plain version on the card at the main path's
     shapes, timed beside the plain version and one PyTorch call for the
     same function (a yardstick only: the port never calls it);
  4. qwen2.5-3b, all 36 layers, fp32, random weights from a seed: direct
     serve (batch 4, prompt 32, 16 new tokens), then 8 Zipf requests through
     4 slots in wave and continuous mode (page 16, chunk 16); continuous
     must equal wave token for token, and every kernel's launch counter,
     zeroed just before each path, must show the path went through it;
  5. the same weights cut to 2 layers, run on the card with the kernels and
     on the host CPU with the plain versions; the logits must agree.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the fp32 rate outside the tensor cores (the path holds fp32 without TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain version on the same inputs, fp32 on the card: the two sum
# in different orders, so they agree to fp32 rounding (about 1e-6 here)
KERNEL_ATOL = KERNEL_RTOL = 1e-5
# the 2-layer full-width slice, card (kernels, cuBLAS) vs host CPU (plain
# versions, CPU BLAS): fp32 products over d_model 2048 and d_ff 11008 in
# different orders
CROSS_ATOL, CROSS_RTOL = 2e-3, 1e-3


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
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.paged_attention(q, kp, vp, tables, qs)),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_ref(q, kp, vp, tables,
                                                            qs)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True)),
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} P={P} nP={nP} fp32",
    }


def check_paged_reset(cfg, dev, gen, L, N, P, width, fresh_n, ops, ref):
    H, D = cfg.n_kv_heads, cfg.d_head
    k = torch.randn(L, N, P, H, D, device=dev, generator=gen)
    v = torch.randn(L, N, P, H, D, device=dev, generator=gen)
    fresh = torch.randperm(N, device=dev, generator=gen)[:fresh_n]
    # PagePool.alloc's row: the fresh pages, padded with fresh[0]
    row = torch.full((width,), int(fresh[0]), dtype=torch.int32, device=dev)
    row[:fresh_n] = fresh.to(torch.int32)
    k0, v0 = k.clone(), v.clone()
    kr, vr = k.clone(), v.clone()
    ops.paged_reset(k, v, row)
    ref.paged_reset_ref(kr, vr, row)
    torch.cuda.synchronize()
    check(torch.equal(k, kr) and torch.equal(v, vr),
          "paged_reset differs from its plain version")
    named = torch.zeros(N, dtype=torch.bool, device=dev)
    named[row.long()] = True
    check(bool((k[:, named] == 0).all()) and bool((v[:, named] == 0).all()),
          "paged_reset left a named page non-zero")
    check(torch.equal(k[:, ~named], k0[:, ~named])
          and torch.equal(v[:, ~named], v0[:, ~named]),
          "paged_reset touched a page outside its row")
    rl = row.long()
    nbytes = fresh_n * L * P * H * D * 4 * 2 + width * 4
    bms, by = bound(nbytes, 0)
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: ops.paged_reset(k, v, row)),
        "plain_ms": cuda_ms(lambda: ref.paged_reset_ref(k, v, row)),
        "library_ms": cuda_ms(lambda: (k.index_fill_(1, rl, 0.0),
                                       v.index_fill_(1, rl, 0.0))),
        "bound_ms": bms, "bound_by": by,
        "at": f"L={L} N={N} P={P} H={H} D={D} row width={width} "
              f"({fresh_n} distinct) fp32",
    }


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
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal fp32",
    }


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
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.models.transformer import Transformer
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
        "paged_reset": check_paged_reset(
            cfg, dev, gen, cfg.n_layers, B_SLOTS * nP, PAGE, nP, 4,
            paged_ops, paged_ref),
        "flash_attention": check_flash(cfg, dev, gen, 4, 32, flash_ops,
                                       flash_ref, F),
    }
    kern["paged_attention"]["chunk16"] = check_paged_attention(
        cfg, dev, gen, B_SLOTS, nP, PAGE, CHUNK, paged_ops, paged_ref, F)
    for name, r in kern.items():
        log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} | "
            f"kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
            f"library {r['library_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {r['at']}")
    c16 = kern["paged_attention"]["chunk16"]
    log(f"[kernel] paged_attention chunk: max_abs_err {c16['max_abs_err']:.3g} "
        f"| kernel {c16['ms']:.4f} ms | plain {c16['plain_ms']:.4f} ms | "
        f"library {c16['library_ms']:.4f} ms | bound {c16['bound_ms']:.4f} ms "
        f"({c16['bound_by']}) | {c16['at']}")

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
    for kind, (res, n) in runs.items():
        tok_s = 1 / res.decode_s_per_token
        report[kind] = {"useful_tokens": res.stats.useful_tokens,
                        "tok_per_s": tok_s,
                        "p50_latency_steps": res.stats.p50_latency_steps,
                        "p99_latency_steps": res.stats.p99_latency_steps,
                        "utilization": res.stats.utilization,
                        "launches": n}
        log(f"[serve] {kind}: 8 requests, 4 slots: {res.stats.useful_tokens} "
            f"tokens at {tok_s:.1f} tok/s | utilization "
            f"{res.stats.utilization:.3f} | p99 {res.stats.p99_latency_steps} "
            f"steps | launches {n}")
    log("[serve] continuous == wave token for token")

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
    check(all(n > 0 for n in n_slice.values()),
          f"the card's slice run skipped a kernel: {n_slice}")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    scale = max(b.abs().max().item() for b in want)
    check(all(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              for a, b in zip(got, want)),
          f"card vs CPU logits differ by {err} (|logit| up to {scale})")
    report["cross_device"] = {"max_abs_err": err, "max_abs_logit": scale,
                              "atol": CROSS_ATOL, "rtol": CROSS_RTOL}
    log(f"[slice] 2-layer full width, card vs CPU: max |logit diff| {err:.3g} "
        f"(|logit| up to {scale:.3g}; atol {CROSS_ATOL}, rtol {CROSS_RTOL})")

    # the record
    launches = {"flash_attention": n_direct["flash_attention"],
                "paged_attention": n_cont["paged_attention"],
                "paged_reset": n_cont["paged_reset"]}
    line = []
    for name, r in kern.items():
        k = dispatch.KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": k.source,
                 "replaces": k.replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "at": r["at"]}
        if "chunk16" in r:
            entry["chunk16"] = {x: r["chunk16"][x] for x in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "at")}
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
    sys.exit(main())
