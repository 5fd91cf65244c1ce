"""Where a serving step's time goes on the card: ``torch.profiler`` over the
port's serving at an arch's published width (qwen2.5-3b by default).

    python -m repro_torch.launch.profile_serve [--arch ID] [--out FILE.json]

The workloads are chip_smoke.py's: direct serve (batch 4, prompt 32, here 4
new tokens) and 8 Zipf requests through 4 slots, in continuous mode for the
dense family and in wave mode for the ssm and hybrid families (which have
no paged path), every layer, fp32, random weights. For each mode it prints
the wall time, the summed device time of every kernel (and the busy share
it makes of the wall time), and the kernels and operators that take the
most device time; ``--out`` also writes the table as JSON. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.runtime.serving import zipf_requests

TOP = 12  # table rows kept per mode


def _window(fn, top: int) -> dict:
    """Profile one call of ``fn``: wall ms, device-busy ms and the ``top``
    entries by device time (kernels under their own names, plus the ATen
    operators that launched them)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_attr = ("self_device_time_total" if hasattr(events[0],
                "self_device_time_total") else "self_cuda_time_total")
    rows = sorted(({"name": e.key, "count": e.count,
                    "device_ms": getattr(e, dev_attr) / 1e3,
                    "cpu_ms": e.self_cpu_time_total / 1e3} for e in events),
                  key=lambda r: -r["device_ms"])
    # kernels have device time and (almost) no host time of their own;
    # their sum is the time the card was busy
    busy = sum(r["device_ms"] for r in rows if r["cpu_ms"] == 0.0)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall, "top": rows[:top]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--out", default=None, help="also write the table here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    sess = Session.from_config(cfg, seed=0)
    params = sess.init_params()
    reqs = zipf_requests(8, cfg.vocab_size, min_len=8, max_len=48,
                         max_new_low=8, max_new_high=24, seed=0)
    sched = "continuous" if sess.model.paged_step is not None else "wave"
    runs = {
        "direct": lambda: sess.serve(batch_size=4, prompt_len=32,
                                     max_new_tokens=4, params=params),
        sched: lambda: sess.serve(scheduler=sched,
                                  requests=copy.deepcopy(reqs),
                                  params=params, max_batch=4, page_size=16,
                                  prefill_chunk=16)}
    for fn in runs.values():  # warm-up: cuBLAS handles, the build, allocator
        fn()
    report = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
              "n_layers": cfg.n_layers,
              **{mode: _window(fn, TOP) for mode, fn in runs.items()}}
    for mode in runs:
        w = report[mode]
        print(f"[{mode}] wall {w['wall_ms']:.2f} ms | device busy "
              f"{w['device_busy_ms']:.2f} ms ({w['busy_share']:.1%})")
        for r in w["top"]:
            print(f"  {r['device_ms']:10.3f} ms dev {r['cpu_ms']:10.3f} ms "
                  f"host  x{r['count']:<5d} {r['name'][:90]}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
