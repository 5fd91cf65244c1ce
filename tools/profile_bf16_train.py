"""Where one silo's gradient spends its time in fp32 and in bf16 training:
qwen2.5-3b at its published width and 12 layers, one silo's share of
``chip_smoke.py`` phase 25's batch (4 x 64 tokens), in one process on one
card, in turns: fp32, route (A) bf16 compute over fp32 weights, route (B)
bf16 weights, then the same three in the reverse order.

    python3 tools/profile_bf16_train.py [--layers 12] [--top 12] [--out FILE]

Each turn times the silo's forward and backward (``model.loss`` and
``torch.autograd.grad`` over every weight, as ``distributed/steps.py``
runs them) with CUDA events, warm, 5 times; then profiles one more under
``torch.profiler`` (``launch/profile_serve``'s window): wall ms, the card's
busy ms and share, the kernels and operators by device time; and times the
forward alone. The last line is the JSON record. Needs a CUDA device;
imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import flatbuf  # noqa: E402
from repro_torch.launch.profile_serve import _window  # noqa: E402
from repro_torch.models.packing import pack_params, param_tree  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

BF16 = torch.bfloat16
ROUTES = ("fp32", "A", "B")


def route_session(cfg, route: str) -> Session:
    sess = Session.from_config(cfg, seed=0, compute_dtype=torch.float32
                               if route == "fp32" else BF16)
    if route == "B":
        sess = dataclasses.replace(sess, model=build_model(
            cfg, sess.device, param_dtype=BF16, compute_dtype=BF16))
    return sess


def events_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def turn(cfg, route: str, top: int) -> dict:
    sess = route_session(cfg, route)
    params = sess.init_params()
    layout, _ = pack_params(params)  # trainable views, as a train state
    tensors = flatbuf.flat_tensors(layout, param_tree(params))
    batch = {k: v[:4] for k, v in sess.synthetic_batches(16, 64)().items()}

    def grad():
        loss = sess.model.loss(params, batch)
        return torch.autograd.grad(loss, tensors, materialize_grads=True)

    def forward():
        with torch.no_grad():
            return sess.model.loss(params, batch)

    grad()  # warm-up: cuBLAS handles and heuristics, the allocator
    torch.cuda.synchronize()
    grad_ms = events_ms(grad, 5)
    fwd_ms = events_ms(forward, 5)
    prof = _window(grad, top)
    rec = {"route": route, "P": layout.total, "grad_ms": grad_ms,
           "forward_ms": fwd_ms, **prof}
    print(f"[{route}] silo grad ms {[round(t, 2) for t in grad_ms]} | "
          f"forward ms {[round(t, 2) for t in fwd_ms]} | profiled wall "
          f"{prof['wall_ms']:.1f} ms, card busy {prof['device_busy_ms']:.1f}"
          f" ({prof['busy_share']:.1%})", flush=True)
    for r in prof["top"]:
        print(f"    {r['device_ms']:9.2f} ms  x{r['count']:<5d} "
              f"{r['name'][:110]}", flush=True)
    del sess, params, tensors
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bf16_train: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    card = torch.cuda.get_device_name(0)
    turns = [turn(cfg, r, args.top) for r in ROUTES + ROUTES[::-1]]
    record = {"card": card, "arch": args.arch, "n_layers": args.layers,
              "tokens": 4 * 64, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({"card": card, "grad_ms": {
        f"{i}:{t['route']}": min(t["grad_ms"]) for i, t in
        enumerate(turns)}}))
    return record


if __name__ == "__main__":
    main()
