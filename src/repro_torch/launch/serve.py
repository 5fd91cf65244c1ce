"""Confidential serving launcher of the port:
``python -m repro_torch.launch.serve --arch qwen2.5-3b --full --tokens 16``.

Thin CLI over :meth:`repro_torch.api.Session.serve`. ``--scheduler`` picks
the mode: ``direct`` (one lockstep batch, wall-clock timings), ``wave``
(length-bucketed static batching) or ``continuous`` (paged KV cache with
in-kernel slot recycling; ``--speculative`` adds draft-propose/verify
decoding). Runs on ``cuda`` unless ``--device cpu``.

``--soak N`` runs a long Zipf-distributed trace (N requests, the JAX
package's ``zipf_requests`` draws) through the continuous scheduler and
reports ROLLING p99 latency over a sliding window of completions, the
figure that catches slot-recycling leaks and latency drift a short drain
never shows. The row is merged into ``--out`` (read-modify-write, as in the
JAX package), by default ``build/serve_soak.json`` at the repository root:
the port never writes the JAX package's ``BENCH_serve.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from repro_torch.api import Session
from repro_torch.kernels._build import BUILD_DIR, REPO_ROOT

SOAK_OUT = BUILD_DIR / "serve_soak.json"


def _rolling_p99(latencies, window: int = 64):
    """p99 over each sliding window of completions (completion order):
    max over windows = the worst sustained tail, not one outlier."""
    lat = np.asarray(latencies, np.float64)
    if len(lat) == 0:
        return [], None
    window = min(window, len(lat))
    p99s = [float(np.percentile(lat[i:i + window], 99))
            for i in range(0, len(lat) - window + 1, max(window // 4, 1))]
    return p99s, max(p99s)


def run_soak(sess: Session, n_requests: int, *, max_batch: int,
             page_size: int, prefill_chunk: int, window: int,
             out=SOAK_OUT, seed: int = 0) -> dict:
    """N Zipf requests through the continuous scheduler; the row (the JAX
    package's keys) is merged into the JSON file ``out`` under
    ``serve/soak`` and returned."""
    from repro_torch.runtime.serving.load import zipf_requests

    out = Path(out)
    if out.resolve().parent == REPO_ROOT and out.name.startswith("BENCH_"):
        raise ValueError(f"{out.name} is the JAX package's benchmark record; "
                         f"the port writes its soak rows elsewhere")
    requests = zipf_requests(n_requests, sess.cfg.vocab_size, seed=seed)
    res = sess.serve(scheduler="continuous", requests=requests,
                     max_batch=max_batch, max_len=512, page_size=page_size,
                     prefill_chunk=prefill_chunk)
    s = res.stats
    p99s, worst = _rolling_p99(s.latencies, window)
    row = {"requests": n_requests, "window": window,
           "useful_tokens": s.useful_tokens,
           "decode_steps": s.decode_steps,
           "utilization": round(s.utilization, 4),
           "p50_latency_steps": s.p50_latency_steps,
           "p99_latency_steps": s.p99_latency_steps,
           "rolling_p99_first": p99s[0] if p99s else None,
           "rolling_p99_last": p99s[-1] if p99s else None,
           "rolling_p99_worst": worst}
    # read-modify-write: the soak row joins whatever rows the file holds
    bench = {}
    if out.exists():
        with open(out) as f:
            bench = json.load(f)
    bench["serve/soak"] = row
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
    os.replace(tmp, out)
    return row


def _tenant_weights(spec):
    if not spec:
        return None
    weights = {}
    for part in spec.split(","):
        name, sep, w = part.partition("=")
        if not sep or not name:
            raise SystemExit(
                f"--tenant-weights: bad entry {part!r} (want name=weight)")
        weights[name] = float(w)
    return weights


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests (scheduler modes) / batch rows (direct)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--scheduler", default="direct",
                    choices=["direct", "wave", "continuous"])
    ap.add_argument("--max-batch", type=int, default=8,
                    help="batch slots for the scheduler modes")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="continuous only: map same-tenant shared prompt "
                         "pages read-only instead of re-prefilling them")
    ap.add_argument("--speculative", action="store_true",
                    help="continuous only: draft-propose/verify decoding "
                         "over a parallel draft page pool")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative tokens per tick (draft proposes k-1, "
                         "one chunk-shaped verify scores all k)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="early-exit draft depth (first N target layers); "
                         "default: self-draft (all layers)")
    ap.add_argument("--tenant-weights", default=None, metavar="a=2,b=1",
                    help="continuous only: deficit-round-robin admission "
                         "weights per tenant (unlisted tenants weigh 1)")
    ap.add_argument("--soak", type=int, default=None, metavar="N",
                    help="soak mode: N Zipf requests through the continuous "
                         "scheduler, rolling p99 merged into --out")
    ap.add_argument("--window", type=int, default=64,
                    help="soak mode: completions per rolling-p99 window")
    ap.add_argument("--out", default=str(SOAK_OUT),
                    help="soak mode: JSON file to merge the row into "
                         "(default: build/serve_soak.json)")
    args = ap.parse_args(argv)

    sess = Session.from_config(args.arch, full=args.full, device=args.device)
    if not sess.cfg.causal:
        raise SystemExit(f"{sess.cfg.name} is encoder-only: no decode step")
    if args.soak is not None:
        row = run_soak(sess, args.soak, max_batch=args.max_batch,
                       page_size=args.page_size,
                       prefill_chunk=args.prefill_chunk, window=args.window,
                       out=args.out)
        print(f"arch={sess.cfg.name} device={sess.device} soak={args.soak} "
              f"slots={args.max_batch} window={args.window}")
        print(f"useful tokens: {row['useful_tokens']} | utilization: "
              f"{row['utilization']:.3f}")
        print(f"rolling p99 (steps): first={row['rolling_p99_first']} "
              f"last={row['rolling_p99_last']} "
              f"worst={row['rolling_p99_worst']}")
        print(f"# merged serve/soak into {args.out}")
        return row
    if args.scheduler == "direct":
        res = sess.serve(batch_size=args.batch, prompt_len=args.prompt_len,
                         max_new_tokens=args.tokens)
        print(f"arch={sess.cfg.name} device={sess.device} batch={args.batch} "
              f"prompt={args.prompt_len} gen={args.tokens}")
        print(f"prefill: {res.prefill_s * 1e3:.1f} ms | decode: "
              f"{res.decode_s_per_token * 1e3:.2f} ms/token")
        print("first sequences:", res.tokens[:2, :8].tolist())
        return res

    res = sess.serve(batch_size=args.batch, prompt_len=args.prompt_len,
                     max_new_tokens=args.tokens, scheduler=args.scheduler,
                     max_batch=args.max_batch,
                     max_len=args.prompt_len + args.tokens,
                     page_size=args.page_size,
                     prefill_chunk=args.prefill_chunk,
                     prefix_sharing=args.prefix_sharing,
                     speculative=args.speculative, spec_k=args.spec_k,
                     draft_layers=args.draft_layers,
                     tenant_weights=_tenant_weights(args.tenant_weights))
    s = res.stats
    print(f"arch={sess.cfg.name} device={sess.device} "
          f"scheduler={args.scheduler} requests={args.batch} "
          f"slots={args.max_batch}")
    print(f"useful tokens: {s.useful_tokens} | decode steps: "
          f"{s.decode_steps} | utilization: {s.utilization:.3f}")
    print(f"latency (steps): p50={s.p50_latency_steps:.0f} "
          f"p99={s.p99_latency_steps:.0f}")
    if args.prefix_sharing:
        print(f"shared prompt tokens: {s.shared_prompt_tokens}")
    if args.speculative:
        print(f"speculative: proposed={s.spec_proposed} "
              f"accepted={s.spec_accepted} "
              f"(acceptance {s.acceptance_rate:.2f})")
    print("first sequences:", res.tokens[:2, :8].tolist())
    return res


if __name__ == "__main__":
    main()
