"""fp32 against bf16 serving of one dense arch at its published width and
depth, in one process on one card, in turns: fp32, bf16 compute with fp32
weights (cast in the forward pass), bf16 weights, then the same three in
the reverse order.

    python3 tools/time_bf16_serving.py [--arch qwen2.5-3b] [--out FILE]

Each turn serves direct (batch 4, prompt 32, 16 new tokens: prefill ms,
decode ms a token step) and 8 Zipf requests through 4 continuous slots
(chip_smoke.py's workloads: tok/s, decode ms a step), reads the peak
memory of each (absolute, and above what was allocated before it), and
profiles one direct serve with 4 new tokens (``launch/profile_serve``'s
window: wall ms, the card's busy ms and share, the kernels by device
time). The last line is the JSON record. Needs a CUDA device; imports no
JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch.profile_serve import _window  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime.serving import zipf_requests  # noqa: E402

BF16 = torch.bfloat16


def peak_of(fn) -> tuple:
    """(fn(), peak GB, peak GB above what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, peak / 1e9, (peak - base) / 1e9


def turn(sess, params, reqs) -> dict:
    direct, peak, above = peak_of(lambda: sess.serve(
        batch_size=4, prompt_len=32, max_new_tokens=16, params=params))
    cont, cpeak, cabove = peak_of(lambda: sess.serve(
        scheduler="continuous", requests=copy.deepcopy(reqs), params=params,
        max_batch=4, max_len=512, page_size=16, prefill_chunk=16))
    st = cont.stats
    prof = _window(lambda: sess.serve(batch_size=4, prompt_len=32,
                                      max_new_tokens=4, params=params), 6)
    return {"prefill_ms": direct.prefill_s * 1e3,
            "decode_ms_per_token": direct.decode_s_per_token * 1e3,
            "direct_peak_gb": peak, "direct_peak_above_gb": above,
            "continuous_tok_per_s": 1 / cont.decode_s_per_token,
            "continuous_decode_ms_per_step": cont.decode_s_per_token * 1e3
            * st.useful_tokens / max(st.decode_steps, 1),
            "continuous_peak_gb": cpeak, "continuous_peak_above_gb": cabove,
            "profile_direct_4": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "busy_share")},
            "profile_top": [{k: r[k] for k in ("name", "count", "device_ms")}
                            for r in prof["top"]]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_bf16_serving: needs a CUDA device")

    cfg = get_config(args.arch)
    s32 = Session.from_config(cfg, seed=0)
    s16 = Session.from_config(cfg, compute_dtype=BF16, seed=0)
    dev = s32.device
    m16w = build_model(cfg, dev, param_dtype=BF16, compute_dtype=BF16)
    s16w = Session(cfg=cfg, run_cfg=RunConfig(model=cfg), model=m16w,
                   device=dev, seed=0)
    p32, p16w = s32.init_params(), s16w.init_params()
    settings = {"fp32": (s32, p32), "bf16": (s16, p32),
                "bf16_weights": (s16w, p16w)}
    reqs = zipf_requests(8, cfg.vocab_size, min_len=8, max_len=48,
                         max_new_low=8, max_new_high=24, seed=0)
    for sess, params in settings.values():  # warm-up: build, cuBLAS, caches
        sess.serve(batch_size=4, prompt_len=32, max_new_tokens=2,
                   params=params)
        sess.serve(scheduler="continuous", requests=copy.deepcopy(reqs[:2]),
                   params=params, max_batch=4, page_size=16,
                   prefill_chunk=16)
    order = list(settings) + list(settings)[::-1]
    record = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
              "n_layers": cfg.n_layers, "order": order,
              "turns": {k: [] for k in settings}}
    t0 = time.perf_counter()
    for name in order:
        sess, params = settings[name]
        r = turn(sess, params, reqs)
        record["turns"][name].append(r)
        print(f"[{name}] prefill {r['prefill_ms']:.2f} ms | decode "
              f"{r['decode_ms_per_token']:.2f} ms/token | continuous "
              f"{r['continuous_tok_per_s']:.1f} tok/s, "
              f"{r['continuous_decode_ms_per_step']:.2f} ms a step | peak "
              f"{r['direct_peak_gb']:.2f} / {r['continuous_peak_gb']:.2f} GB "
              f"(above the start {r['direct_peak_above_gb']:.2f} / "
              f"{r['continuous_peak_above_gb']:.2f}) | card busy "
              f"{r['profile_direct_4']['busy_share']:.1%} of a 4-token "
              f"direct serve", flush=True)
        for row in r["profile_top"]:
            print(f"    {row['device_ms']:9.3f} ms x{row['count']:<5d} "
                  f"{row['name'][:80]}")
    record["s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=2))
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
