#!/usr/bin/env python3
"""Time the page pools' zeroing events on a tree from before the batched
zeroing kernel (``csrc/pool_zero.cu``), the events and checks of
``chip_smoke.py --pool``, so that the two trees can be compared in one
call on one GPU.

    python3 tools/time_pool_parent.py --src DIR   # DIR: that tree's src

In such a tree ``PagePool`` launched one ``paged_reset`` a pool an
admission, over a full-width table row padded with its first fresh page,
and one ``paged_rollback`` a pool and a range, each launch after copying
its row from pageable host memory to the card. Each event is timed as that
``PagePool`` ran it: as a call (``PagePool``'s own method, the copies
included) and, on the card, its launches from rows copied beforehand (a
copy from pageable memory cannot be captured in a CUDA graph). The events:
an admission's reset (4 fresh pages; the target pool, then with a 4-layer
draft), one speculative tick's 4 tails through both pools, and the single
ranges of the target pool. Each is held to ``chip_smoke.zero_event``'s
reference first. The last line is the JSON record.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def events(smoke, cfg, dev) -> dict:
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.runtime.serving import PagePool

    gen = torch.Generator(device=dev).manual_seed(0)
    P, H, D = smoke.POOL_PAGE, cfg.n_kv_heads, cfg.d_head
    N, W = smoke.POOL_SLOTS * smoke.POOL_WIDTH, smoke.POOL_WIDTH
    shape = f"N={N} P={P} H={H} D={D} fp32"

    def make(draft):
        stub = smoke.stub_model(cfg, dev, gen, cfg.n_layers)
        stub.device = dev  # that tree's PagePool reads it
        draft_model = None
        if draft:
            draft_model = smoke.stub_model(cfg, dev, gen, smoke.POOL_DRAFT)
            draft_model.device = dev
        pool = PagePool(stub, n_slots=smoke.POOL_SLOTS, n_pages=N,
                        page_size=P, pages_per_slot=W,
                        draft_model=draft_model)
        for s in range(smoke.POOL_SLOTS):
            smoke.check(pool.alloc(s, W), "PagePool.alloc refused")
        kv = [(p["k_pages"], p["v_pages"]) for p in (pool.pages,
                                                     pool.draft_pages)
              if p is not None]
        return pool, kv

    out = {}
    for name, draft in (("reset", False), ("reset_draft", True)):
        pool, kv = make(draft)
        fresh = pool.slot_pages(1)[:smoke.POOL_FRESH]
        row = np.full((W,), fresh[0], np.int32)  # as that tree's alloc
        row[:smoke.POOL_FRESH] = fresh
        row_dev = torch.as_tensor(row, device=dev)

        def card():
            for k, v in kv:
                ops.paged_reset(k, v, row_dev)

        layers = sum(k.shape[0] for k, _ in kv)
        out[name] = smoke.zero_event(
            kv, lambda: pool._reset_rows(row), fresh, P * H * D,
            f"{smoke.POOL_FRESH} fresh pages, {layers} layers "
            f"({'target + draft' if draft else 'target'}), {shape}", card)

    pool, kv = make(True)
    rows = [torch.as_tensor(pool.tables[s], device=dev)
            for s in range(smoke.POOL_SLOTS)]
    tokens = [int(pool.tables[s][p // P]) * P + p % P
              for s, a, b in smoke.TICK_TAILS for p in range(a, b)]

    def tick():
        for tail in smoke.TICK_TAILS:
            pool.rollback(*tail)

    def tick_card():
        for k, v in kv:
            for s, a, b in smoke.TICK_TAILS:
                ops.paged_rollback(k, v, rows[s], a, b)

    out["tick"] = smoke.zero_event(
        kv, tick, tokens, H * D,
        f"{len(smoke.TICK_TAILS)} tails of 3 tokens across a page boundary, "
        f"{cfg.n_layers + smoke.POOL_DRAFT} layers (target + draft), {shape}",
        tick_card)

    (k, v), = target = kv[:1]
    for a, b in smoke.SINGLE_RANGES:
        dead = [int(pool.tables[0][p // P]) * P + p % P for p in range(a, b)]
        out[f"range_{a}_{b}"] = smoke.zero_event(
            target, lambda: ops.paged_rollback(k, v, rows[0], a, b), dead,
            H * D, f"positions [{a}, {b}) of a row of {W} pages, "
            f"{cfg.n_layers} layers (target), {shape}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_pool_parent: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    src = Path(args[args.index("--src") + 1]).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = smoke.card_line()
    smoke.log(card)
    build_s = _build.build()
    smoke.log(f"[build] {_build.library_path()} in {build_s:.1f} s")
    record = events(smoke, get_config("qwen2.5-3b"), torch.device("cuda"))
    for name, r in record.items():
        smoke.log(f"[kernel] page pool {name} (parent): call {r['ms']:.4f} "
                  f"ms | card {r['device_ms']:.4f} ms | index_fill_ "
                  f"{r['library_ms']:.4f} ms (card "
                  f"{r['library_device_ms']:.4f}) | {r['at']}")
    smoke.log(json.dumps({"src": str(src), "card": card, "pool": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
