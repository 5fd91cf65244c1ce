#!/usr/bin/env python3
"""Check and time bf16 paged attention (``PERF.md`` §6 row 2's bf16
sub-rows) on the GPU, one tree at a time or two trees in turns:

    python3 tools/time_paged_bf16.py [--src DIR] [--rows a,b] [--out F]
    python3 tools/time_paged_bf16.py --parent DIR [--rows a,b] [--out F]

DIR is a tree's ``src`` (default: this checkout's). Each sub-row runs the
tree's ``ops.paged_attention`` on bf16 q and pools at the serving shape (4
slots of 32 pages of 16 tokens, a pool of 128 pages, q_starts {0, S/3, S -
C, -1}, inputs from a seed, the same in every tree), holds it to the plain
version at 1e-5 (and to ``ref.paged_attention_split_model`` where the tree
has it) and a second launch to the first bit for bit, then times it as a
call (CUDA events over back-to-back calls, after a warm-up) and on the card
alone (50 calls captured in one CUDA graph, the graph replayed), beside
SDPA in bf16 over the gathered K/V with the same mask, timed both ways,
and splits one call's device time by kernel (``torch.profiler``). For this
checkout's tree it also reports each paged-attention kernel's registers,
spills and shared memory (``cuobjdump -res-usage``) and its tensor-core
instructions (``HMMA``). The bound is the larger of the bytes the call must
move (q read and the output written once, the K/V of every page holding a
visible position read once) over 3.35 TB/s and its products over bf16's
989 TFLOP/s.

With ``--parent``, the script runs itself on the parent's tree and on this
checkout's in turns (parent, change, change, parent), each a process of
its own that builds its tree's kernels, and prints one line a sub-row with
the four card times. The card's name and power limit come first; the last
line is the JSON record.
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
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# sub-row: arch, Hq, Hkv, d_head, C (chip_smoke.py phase 23(a)'s names)
ROWS = {
    "bf16": ("qwen2.5-3b", 16, 2, 128, 1),
    "bf16_verify4": ("qwen2.5-3b", 16, 2, 128, 4),
    "bf16_chunk16": ("qwen2.5-3b", 16, 2, 128, 16),
    "bf16_d80": ("stablelm-3b", 32, 32, 80, 1),
    "bf16_d80_verify4": ("stablelm-3b", 32, 32, 80, 4),
    "bf16_d80_chunk16": ("stablelm-3b", 32, 32, 80, 16),
    "bf16_d96": ("phi3-mini-3.8b", 32, 32, 96, 1),
    "bf16_d96_verify4": ("phi3-mini-3.8b", 32, 32, 96, 4),
    "bf16_d96_chunk16": ("phi3-mini-3.8b", 32, 32, 96, 16),
}
B_SLOTS, N_PAGES_A_SLOT, PAGE = 4, 32, 16
ATOL = RTOL = 1e-5
PAGED_KERNELS = r"paged_(attention|combine)\w*kernel"


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def graph_ms(fn, n: int = 50, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``n`` calls in one CUDA graph."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, reps=reps) / n


def inputs(Hq, Hkv, D, C, seed):
    """chip_smoke.paged_case's inputs in bf16: B slots, each its own nP
    distinct pages of a pool of B*nP."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, nP, P = B_SLOTS, N_PAGES_A_SLOT, PAGE
    N, S = B * nP, nP * P
    q = torch.randn(B, C, Hq, D, device=dev, generator=gen)
    kp = torch.randn(N, P, Hkv, D, device=dev, generator=gen)
    vp = torch.randn(N, P, Hkv, D, device=dev, generator=gen)
    tables = torch.randperm(N, device=dev, generator=gen).reshape(
        B, nP).to(torch.int32).contiguous()
    qs = torch.tensor([0, S // 3, S - C, -1], dtype=torch.int32, device=dev)
    return q.to(BF16), kp.to(BF16), vp.to(BF16), tables, qs


def work(q, tables, q_start) -> tuple[set, int]:
    """The pages holding a visible position (each read once) and the flops
    of the call: 4 D a visible (query head, key) pair."""
    B, C, Hq, D = q.shape
    P, S = PAGE, tables.shape[1] * PAGE
    pages, flops = set(), 0
    for b in range(B):
        qs = int(q_start[b])
        last = min(max(qs + C, 0), S)
        pages.update(tables[b, :-(-last // P)].tolist())
        for c in range(C):
            flops += 4 * D * Hq * min(max(qs + c + 1, 0), S)
    return pages, flops


def kernel_split(fn, n: int = 5) -> dict:
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
        m = re.search(r"(paged_\w+?kernel)", e.key)
        key = m.group(1) if m else e.key[:40]
        out[key] = out.get(key, 0.0) + t / 1e3 / n
    return {k: v for k, v in out.items() if v > 0}


def kernel_resources() -> dict:
    """Registers, spills, shared memory and HMMA count of each paged
    attention kernel in the built library, by mangled name."""
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
            name = m.group(1) if re.search(PAGED_KERNELS, m.group(1)) \
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


def one_row(name: str) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention import ops, ref

    arch, Hq, Hkv, D, C = ROWS[name]
    q, kp, vp, tables, qs = inputs(Hq, Hkv, D, C, seed=D + C)
    B, S = B_SLOTS, N_PAGES_A_SLOT * PAGE
    dispatch.reset_launches()
    got = ops.paged_attention(q, kp, vp, tables, qs)
    again = ops.paged_attention(q, kp, vp, tables, qs)
    variants = dict(dispatch.KERNELS["paged_attention"].variants)
    want = ref.paged_attention_ref(q, kp, vp, tables, qs)
    model = (ref.paged_attention_split_model(q, kp, vp, tables, qs)
             if hasattr(ref, "paged_attention_split_model") else None)
    torch.cuda.synchronize()
    pages, flops = work(q, tables.cpu(), qs.cpu())
    # q read in bf16, the output written in fp32, K and V in bf16
    nbytes = (q.numel() * (2 + 4) + len(pages) * PAGE * Hkv * D * 2 * 2
              + tables.numel() * 4 + B * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    rec = {
        "arch": arch,
        "at": f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} P={PAGE} "
              f"nP={N_PAGES_A_SLOT} q_start={qs.tolist()} bf16",
        "dtype_out": str(got.dtype).replace("torch.", ""),
        "launches": variants,
        "bit_equal_launches": bool(torch.equal(got, again)),
        "max_abs_err": float((got - want).abs().max()),
        "within_plain": bool(torch.allclose(got, want, atol=ATOL,
                                            rtol=RTOL)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    if model is not None:
        rec["model_max_abs_err"] = float((got - model).abs().max())
        rec["within_model"] = bool(torch.allclose(got, model, atol=ATOL,
                                                  rtol=RTOL))
    rec["ok"] = (rec["bit_equal_launches"] and rec["within_plain"]
                 and rec.get("within_model", True)
                 and variants.get("bf16") == 2 and variants.get("f32") == 0
                 and got.dtype == torch.float32
                 and bool(torch.isfinite(got).all()))
    del got, again, want, model
    call = lambda: ops.paged_attention(q, kp, vp, tables, qs)  # noqa: E731
    kg = kp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    qpos = qs.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = (torch.arange(S, device=q.device)[None, None]
            <= qpos[:, :, None])[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kg, vg, attn_mask=mask, enable_gqa=True)
    rec["ms"] = cuda_ms(call)
    rec["device_ms"] = graph_ms(call)
    rec["library_ms"] = cuda_ms(sdpa)
    rec["library_device_ms"] = graph_ms(sdpa)
    rec["kernels_ms"] = kernel_split(call)
    dispatch.reset_launches()
    return rec


def run_tree(src: Path, rows: list) -> dict:
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    card = card_line()
    print(card, flush=True)
    rec: dict = {"src": str(src), "card": card, "build_s": _build.build()}
    if src == (ROOT / "src").resolve():
        rec["kernels"] = kernel_resources()
        for k, v in rec["kernels"].items():
            print(f"[res] {k}: {v}", flush=True)
    for name in rows:
        r = one_row(name)
        rec[name] = r
        print(f"[{name}] ok {r['ok']} | card {r['device_ms']:.4f} ms "
              f"(SDPA bf16 {r['library_device_ms']:.4f}) | call "
              f"{r['ms']:.4f} ms (SDPA {r['library_ms']:.4f}) | bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) | err "
              f"{r['max_abs_err']:.3g} model "
              f"{r.get('model_max_abs_err', float('nan')):.3g} | kernels "
              f"{ {k: round(v, 4) for k, v in r['kernels_ms'].items()} } | "
              f"{r['at']}", flush=True)
    rec["ok"] = all(rec[n]["ok"] for n in rows)
    return rec


def in_turns(parent: Path, rows: list) -> dict:
    """Parent, change, change, parent, each in a process of its own."""
    here = (ROOT / "src").resolve()
    runs = []
    for tag, src in (("parent", parent), ("change", here),
                     ("change", here), ("parent", parent)):
        res = subprocess.run([sys.executable, __file__, "--src", str(src),
                              "--rows", ",".join(rows)],
                             capture_output=True, text=True, timeout=1500)
        for line in res.stdout.splitlines():
            if line.startswith("["):
                print(f"({tag}) {line}", flush=True)
        if res.returncode not in (0, 1):
            sys.stderr.write(res.stderr[-4000:])
            raise RuntimeError(f"{tag} run failed ({res.returncode})")
        runs.append((tag, json.loads(res.stdout.strip().splitlines()[-1])))
    out: dict = {"card": runs[0][1]["card"], "turns": [t for t, _ in runs],
                 "runs": [r for _, r in runs]}
    for name in rows:
        card = [r[name]["device_ms"] for _, r in runs]
        call = [r[name]["ms"] for _, r in runs]
        sdpa = [r[name]["library_device_ms"] for _, r in runs]
        out[name] = {"card_ms": card, "call_ms": call, "sdpa_card_ms": sdpa,
                     "bound_ms": runs[1][1][name]["bound_ms"]}
        print(f"[turns] {name}: card ms parent {card[0]:.4f} / "
              f"{card[3]:.4f}, change {card[1]:.4f} / {card[2]:.4f} | SDPA "
              f"bf16 {min(sdpa):.4f}-{max(sdpa):.4f} | bound "
              f"{out[name]['bound_ms']:.4f}", flush=True)
    out["ok"] = all(r["ok"] for _, r in runs[1:3])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_paged_bf16: no CUDA device", file=sys.stderr)
        return 2
    rows = a.rows.split(",")
    if a.parent:
        rec = in_turns(Path(a.parent).resolve(), rows)
    else:
        rec = run_tree(Path(a.src).resolve(), rows)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rec, indent=1))
    # the turns' own records stay in --out; the line carries the summary
    print(json.dumps({k: v for k, v in rec.items() if k != "runs"}))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
