#!/usr/bin/env python3
"""Time the per-leaf policy end to end on one tree, so that two trees (an
unpacked parent and this checkout) compare in one call on one GPU:

    python3 tools/time_perleaf_steps.py [--src DIR]   # DIR: a tree's src

The cells are ``chip_smoke.py``'s: the barrier tier under
``force_impl("perleaf", kernel="dp_noise_tree")`` for qwen2.5-3b at
published width and 12 of 36 layers (phase 9b: 4 silos, quickstart
privacy, AdamW, batch 16 x 64, 3 steps through ``Session.train``) and for
the paper's CNN6 and WRN28 (phase 20: 3 steps through the Trainer), and
per-example clipping of 16 WRN28 examples on the perleaf route (phase
20(c), the second of two calls). Each reports its step ms after the
first, its stage ms and the kernels it launched (counts zeroed just
before), and checks nothing about them, so a tree from before the tree
kernels runs as it is. The last line is the JSON record.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def qwen_perleaf(smoke) -> dict:
    """Phase 9b's 3 steps of the perleaf barrier tier at 12 layers."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig)
    from repro_torch.kernels import dispatch

    cut12 = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4,
                         sync_path="barrier")
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    with dispatch.force_impl("perleaf", kernel="dp_noise_tree"):
        sess = Session.from_config(cut12, privacy=priv, optimizer=opt,
                                   mesh=MeshConfig((4,), ("data",)), seed=0)
        state = sess.init_state()
        torch.cuda.synchronize()
        dispatch.reset_launches()
        res = sess.train(steps=3, batch_size=16, seq_len=64, state=state,
                         log_every=0)
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in res.trainer.stage_log[0]}
    del res, state, sess
    torch.cuda.empty_cache()
    return {"step_ms_after_first": step_ms[1:], "stage_ms": stages,
            "launches": n}


def cifar_perleaf(smoke, dev) -> dict:
    """Phase 20's perleaf tier of CNN6 and WRN28 (3 Trainer steps each),
    and WRN28's per-example clipping on the perleaf route."""
    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.configs.paper_models import CIFAR10_CNN6, CIFAR10_WRN28
    from repro_torch.core import clipping
    from repro_torch.kernels import dispatch

    priv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4,
                         sync_path="barrier")
    out = {}
    for cfg in (CIFAR10_CNN6, CIFAR10_WRN28):
        tr, state, _, n = smoke.cifar_trainer(cfg, dev, priv, 4,
                                              smoke.CIFAR_STEPS, perleaf=True)
        step_ms = [m["step_time_s"] * 1e3 for m in tr.metrics_log]
        out[cfg.name] = {
            "step_ms_after_first": step_ms[1:],
            "contributions_ms": [st.get("contributions", 0.0)
                                 for st in tr.stage_log],
            "launches": n}
        del tr, state
    sm, _ = smoke.cifar_setup(CIFAR10_WRN28, dev)
    params = sm.init(torch.Generator(device=dev).manual_seed(0))
    _, next_batch = smoke.cifar_batcher(CIFAR10_WRN28, dev)
    batch = {k: v[:smoke.CIFAR_PE] for k, v in next_batch().items()}
    secs = []
    for _ in range(2):  # cold, warm
        dispatch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clipping.per_example_clipped_grad(sm.loss, params, batch, 1.0,
                                          impl="perleaf")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["wrn28_per_example_perleaf"] = {
        "ms": secs[1] * 1e3, "cold_ms": secs[0] * 1e3,
        "launches": {k: v for k, v in dispatch.launch_counts().items()
                     if v}}
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_perleaf_steps: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    src = Path(args[args.index("--src") + 1]).resolve() \
        if "--src" in args else ROOT / "src"
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as smoke
    from repro_torch.kernels import _build

    card = smoke.card_line()
    smoke.log(card)
    build_s = _build.build()
    smoke.log(f"[build] {_build.library_path()} in {build_s:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"qwen2.5-3b_12": qwen_perleaf(smoke),
              **cifar_perleaf(smoke, dev)}
    for name, r in record.items():
        smoke.log(f"[perleaf-steps] {name}: {json.dumps(r)}")
    smoke.log(json.dumps({"src": str(src), "card": card,
                          "perleaf_steps": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
