#!/usr/bin/env python3
"""Check and time flash attention's training pair (the lse forward and the
backward) and its serving forward of one tree on the GPU, so that two
trees (an unpacked parent and this checkout) compare in one call on one
card:

    python3 tools/time_flash_pair.py [--src DIR] [--shapes a,b] [--out F]

DIR is a tree's ``src`` (default: this checkout's). At each shape (below;
``--shapes`` picks some by name) the pair runs on inputs from a seed, is
held to its plain versions (``ref.flash_forward_ref`` and
``ref.flash_backward_ref``, the backward from the kernel's own out and lse)
at the gates of ``tests/test_torch_flash_backward.py`` (each output within
1e-5 + 1e-5 of its largest |value|, bf16 one ulp past that; lse within
1e-5), two launches bit-equal, and timed as calls (CUDA events over
back-to-back calls, after a warm-up) and on the card (a CUDA graph of 5
calls, replayed) beside SDPA's forward and backward in the same dtype (its
backward on the card: its kernels' device time under ``torch.profiler``),
with the split's floor (the
tensor-core design's products at bf16's rate: 3 / 10 S x S x D units for
bf16, 12 / 42 for fp32). It also reports each of the tree's flash
kernels' registers, spills and shared memory (``cuobjdump -res-usage``)
and its tensor-core instructions (``HMMA`` in ``cuobjdump -sass``).

The serving shapes (``serve_*``, below; ``--shapes serve`` picks them all)
launch the serving entry (``flash_attention_cuda``: in the trees from PR
39 on the lse forward's kernel without its lse, in earlier trees the
CUDA-core kernel) on inputs from a seed: held to the plain version
(``ref.attention_ref``: within 1e-5 + 1e-5 |want| elementwise, bf16 one
ulp past that; at S 32768, whose scores would not fit, at 64 sampled query
rows), two launches bit-equal, timed as calls and on the card (a CUDA
graph of 5 calls; at S 32768 the kernel's device time under
``torch.profiler`` over 2 calls) beside SDPA in the same dtype (at S 32768
its flash backend on K and V repeated to Hq), with the bound (the larger
of q, k, v and out's bytes at 3.35 TB/s and 4 D flops a visible pair at
67 TFLOP/s for fp32, 989 for bf16). At S 32768 the profiler trace's
launch record of the kernel (registers, shared memory, blocks and warps
an SM, estimated achieved occupancy, as CUPTI reports them) is kept too.

The card's name and power limit come first; the last line is the JSON
record.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16
# name: B, S, Hq, Hkv, D, causal, dtype
SHAPES = {
    "silo_bf16": (1, 4096, 16, 2, 128, True, BF16),
    "silo_fp32": (1, 4096, 16, 2, 128, True, torch.float32),
    "moe_bf16": (2, 2048, 32, 8, 128, True, BF16),
    "hubert_bf16": (4, 512, 16, 16, 80, False, BF16),
    "hubert_fp32": (4, 512, 16, 16, 80, False, torch.float32),
    "s1000_bf16": (1, 1000, 16, 2, 128, True, BF16),
    "s1000_fp32": (1, 1000, 16, 2, 128, True, torch.float32),
    "ragged_bf16": (2, 77, 8, 1, 16, True, BF16),
    "d112_bf16": (1, 200, 4, 1, 112, True, BF16),
    "d96_bf16": (1, 65, 32, 32, 96, True, BF16),
}
# the serving forward: name: B, S, Hq, Hkv, D, causal, dtype (the prefills
# at B 4, S 32 of each serving arch's heads, hubert-xlarge's non-causal
# frames, and the prefill_32k cells at their planned batches)
SERVING_HEADS = {"qwen": (16, 2, 128), "zamba": (32, 32, 112),
                 "stablelm": (32, 32, 80), "phi3": (32, 32, 96),
                 "phimoe": (32, 8, 128), "qwen3moe": (64, 4, 128),
                 "vl": (64, 8, 128)}
for _arch, (_hq, _hkv, _d) in SERVING_HEADS.items():
    for _dt, _t in (("fp32", torch.float32), ("bf16", BF16)):
        SHAPES[f"serve_{_arch}_{_dt}"] = (4, 32, _hq, _hkv, _d, True, _t)
SHAPES["serve_hubert_fp32"] = (4, 64, 16, 16, 80, False, torch.float32)
SHAPES["serve_hubert_bf16"] = (4, 64, 16, 16, 80, False, BF16)
SHAPES["serve32k_qwen_bf16"] = (15, 32768, 16, 2, 128, True, BF16)
SHAPES["serve32k_zamba_bf16"] = (5, 32768, 32, 32, 112, True, BF16)
# the query rows held to the plain version at S 32768
SAMPLED_ROWS = 64
FLASH_KERNELS = r"flash_(fwd|bwd|attention)\w*kernel"


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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


def graph_ms(fn, n: int = 5, reps: int = 3) -> float:
    """Device time of one ``fn()``: ``n`` calls in one CUDA graph."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, reps, 1) / n


def busy_ms(fn, n: int = 3) -> float:
    """Device time of one ``fn()`` for an ``autograd.grad`` that a CUDA
    graph cannot capture: the card's busy time under ``torch.profiler``
    over ``n`` calls (the tree's ``launch/profile_serve._window``)."""
    from repro_torch.launch.profile_serve import _window
    fn()
    return _window(lambda: [fn() for _ in range(n)], 0)["device_busy_ms"] / n


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def past_gate(got, want, dtype) -> float:
    """How far ``got`` lies past the gate (<= 0: inside), in absolute
    terms."""
    got, want = got.float(), want.float()
    gate = 1e-5 + 1e-5 * want.abs().max()
    if dtype == BF16:
        gate = gate + bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return float(((got - want).abs() - gate).max())


def one_shape(name: str, reps: int) -> dict:
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_lse_cuda)
    import torch.nn.functional as F

    B, S, Hq, Hkv, D, causal, dtype = SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(D + S)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                   .to(dtype) for H in (Hq, Hkv, Hkv, Hq))
    fwd = lambda: flash_attention_fwd_lse_cuda(q, k, v, causal)  # noqa: E731
    out, lse = fwd()
    bwd = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do,  # noqa
                                           causal)
    grads = bwd()
    out2, lse2 = fwd()
    again = bwd()
    want_out, want_lse = ref.flash_forward_ref(q, k, v, causal)
    want = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    rec = {
        "shape": dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
                      dtype=str(dtype).replace("torch.", "")),
        "bit_equal": bool(torch.equal(out, out2) and torch.equal(lse, lse2)
                          and all(torch.equal(a, b)
                                  for a, b in zip(grads, again))),
        "out_past_gate": past_gate(out, want_out, dtype),
        "lse_max_abs_err": float((lse - want_lse).abs().max()),
        "grads_past_gate": [past_gate(g, w, dtype)
                            for g, w in zip(grads, want)],
        "grads_max_abs_err": [float((g.float() - w.float()).abs().max())
                              for g, w in zip(grads, want)],
        "out_max_abs_err": float((out.float() - want_out.float()).abs()
                                 .max()),
    }
    rec["ok"] = (rec["bit_equal"] and rec["out_past_gate"] <= 0
                 and rec["lse_max_abs_err"] <= 1e-5
                 and max(rec["grads_past_gate"]) <= 0)
    del want, want_out, want_lse, out2, lse2, again
    torch.cuda.empty_cache()
    rec["fwd_ms"] = cuda_ms(fwd, reps)
    rec["bwd_ms"] = cuda_ms(bwd, reps)
    rec["fwd_device_ms"] = graph_ms(fwd)
    rec["bwd_device_ms"] = graph_ms(bwd)
    rec["bwd_kernels_ms"] = kernel_split(bwd)
    pairs = S * (S + 1) // 2 if causal else S * S
    unit = 2 * D * Hq * B * pairs / 989e12 * 1e3  # ms at bf16's rate
    rec["split_floor_ms"] = [u * unit for u in (
        (4, 10) if dtype == BF16 else (12, 42))]
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    with torch.no_grad():
        rec["sdpa_fwd_ms"] = cuda_ms(sdpa, reps)
    o = sdpa()
    dot = do.transpose(1, 2).contiguous()
    rec["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), reps)
    rec["sdpa_bwd_device_ms"] = busy_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True))
    del q, k, v, do, out, lse, grads, o, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rec


def rows_plain(q, k, v, rows, causal: bool):
    """``ref.attention_ref``'s function at query rows ``rows`` only (fp32
    scores against every key up to the last row, the softmax, the fp32
    product with V, rounded once to q's dtype)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    end = int(rows.max()) + 1 if causal else S
    qg = q[:, rows].reshape(B, rows.numel(), Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, :end].float()) / D ** 0.5
    if causal:
        mask = rows[:, None] >= torch.arange(end, device=q.device)[None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                       v[:, :end].float())
    return out.reshape(B, rows.numel(), Hq, D).to(q.dtype)


def launch_record(fn) -> dict:
    """The flash kernel's launch record in a ``torch.profiler`` trace of
    one ``fn()``: what CUPTI reports of it (grid, block, registers, shared
    memory, blocks and warps an SM, estimated achieved occupancy)."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
    finally:
        os.unlink(path)
    for e in events:
        if e.get("cat") == "kernel" and "flash" in e.get("name", ""):
            return {"name": e["name"], "dur_ms": e.get("dur", 0) / 1e3,
                    **{k: v for k, v in e.get("args", {}).items()
                       if k not in ("External id", "correlation",
                                    "device", "context", "stream",
                                    "queued")}}
    return {}


def one_serving(name: str, reps: int) -> dict:
    """The serving forward at ``name``'s shape: checked, then timed."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    import torch.nn.functional as F

    B, S, Hq, Hkv, D, causal, dtype = SHAPES[name]
    big = S > 4096
    gen = torch.Generator(device="cuda").manual_seed(D + S + Hq)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=gen)
               .to(dtype) for H in (Hq, Hkv, Hkv))
    call = lambda: flash_attention_cuda(q, k, v, causal)  # noqa: E731
    out = call()
    again = call()
    if big:
        rows = torch.cat([torch.tensor([S - 1], device="cuda"), torch.randint(
            0, S - 1, (SAMPLED_ROWS - 1,), device="cuda", generator=gen)])
        got, want = out[:, rows], rows_plain(q, k, v, rows, causal)
    else:
        got, want = out, ref.attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    gate = 1e-5 + 1e-5 * want.abs()
    if dtype == BF16:
        gate = gate + bf16_ulp(torch.maximum(got.abs(), want.abs()))
    err = (got - want).abs()
    rec = {
        "shape": dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
                      dtype=str(dtype).replace("torch.", "")),
        "bit_equal": bool(torch.equal(out, again)),
        "out_max_abs_err": float(err.max()),
        "out_past_gate": float((err - gate).max()),
        "checked_rows": SAMPLED_ROWS if big else S,
    }
    rec["ok"] = rec["bit_equal"] and rec["out_past_gate"] <= 0
    del out, again, got, want, err, gate
    torch.cuda.empty_cache()
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = 4 * D * Hq * B * pairs / (989e12 if dtype == BF16 else 67e12) \
        * 1e3
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if big:
        # SDPA's flash backend on K and V repeated to Hq (GQA by hand: the
        # math backend's S x S scores would not fit the card)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
                  .contiguous() for t in (k, v))

        def sdpa():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
        rec["ms"] = cuda_ms(call, 2, 0)
        rec["device_ms"] = sum(kernel_split(call, 2).values())
        rec["launch"] = launch_record(call)
        rec["sdpa_ms"] = cuda_ms(sdpa, 2, 1)
        rec["sdpa_device_ms"] = sum(kernel_split(sdpa, 2).values())
    else:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        rec["ms"] = cuda_ms(call, reps)
        rec["device_ms"] = graph_ms(call)
        rec["sdpa_ms"] = cuda_ms(sdpa, reps)
        rec["sdpa_device_ms"] = graph_ms(sdpa)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def kernel_split(fn, n: int = 3) -> dict:
    """Device ms of each kernel one ``fn()`` launches (``torch.profiler``
    over ``n`` calls, averaged), by a short form of its name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        m = re.search(r"(flash_\w+?kernel\w*?)(<|I|$)", e.key)
        key = m.group(1) if m else e.key[:40]
        out[key] = out.get(key, 0.0) + t / 1e3 / n
    return {k: v for k, v in out.items() if v > 0}


def kernel_resources() -> dict:
    """Registers, spills, shared memory and HMMA count of each flash kernel
    in the built library, by mangled name."""
    from repro_torch.kernels import _build
    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    lib = str(_build.library_path())
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=120).stdout
    out: dict = {}
    name = None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1) if re.search(FLASH_KERNELS, m.group(1)) \
                else None
        elif name and "REG:" in line:
            out[name] = line.strip()
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = fn if fn in out else None
            if name:
                out[name] = {"res": out[name], "hmma": 0}
        elif name and "HMMA" in line:
            out[name]["hmma"] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="names, comma-separated; 'serve' is every serve* "
                         "shape, 'train' every other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_pair: no CUDA device", file=sys.stderr)
        return 2
    src = Path(a.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    card = card_line()
    print(card, flush=True)
    rec: dict = {"src": str(src), "card": card, "build_s": _build.build()}
    rec["kernels"] = kernel_resources()
    for k, v in rec["kernels"].items():
        print(f"[res] {k}: {v}", flush=True)
    ok = True
    names = []
    for x in a.shapes.split(","):
        names += ([n for n in SHAPES if n.startswith("serve")] if x == "serve"
                  else [n for n in SHAPES if not n.startswith("serve")]
                  if x == "train" else [x])
    for name in names:
        if name.startswith("serve"):
            r = one_serving(name, a.reps)
            ok &= r["ok"]
            rec[name] = r
            print(f"[{name}] ok {r['ok']} | call {r['ms']:.4f} ms, card "
                  f"{r['device_ms']:.4f} | SDPA {r['sdpa_ms']:.4f}, card "
                  f"{r['sdpa_device_ms']:.4f} | bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']}) | out {r['out_max_abs_err']:.3g}, past "
                  f"gate {r['out_past_gate']:.3g} over {r['checked_rows']} "
                  f"rows" + (f" | {json.dumps(r['launch'])}" if "launch" in r
                             else ""), flush=True)
            continue
        r = one_shape(name, a.reps)
        ok &= r["ok"]
        rec[name] = r
        print(f"[{name}] ok {r['ok']} | fwd {r['fwd_ms']:.4f} ms, card "
              f"{r['fwd_device_ms']:.4f} (SDPA {r['sdpa_fwd_ms']:.4f}) | bwd "
              f"{r['bwd_ms']:.4f} ms, card {r['bwd_device_ms']:.4f} (SDPA "
              f"{r['sdpa_bwd_ms']:.4f}, card {r['sdpa_bwd_device_ms']:.4f}) "
              f"| floors {[round(x, 4) for x in r['split_floor_ms']]} | "
              f"out {r['out_max_abs_err']:.3g} "
              f"lse {r['lse_max_abs_err']:.3g} grads "
              f"{[f'{x:.3g}' for x in r['grads_max_abs_err']]} | past gate "
              f"{r['out_past_gate']:.3g} {[f'{x:.3g}' for x in r['grads_past_gate']]}",
              flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
