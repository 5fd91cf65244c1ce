"""Confidential serving launcher of the port:
``python -m repro_torch.launch.serve --arch qwen2.5-3b --full --tokens 16``.

Thin CLI over :meth:`repro_torch.api.Session.serve`. ``--scheduler`` picks
the mode: ``direct`` (one lockstep batch, wall-clock timings), ``wave``
(length-bucketed static batching) or ``continuous`` (paged KV cache with
in-kernel slot recycling; ``--speculative`` adds draft-propose/verify
decoding). Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch.api import Session


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
    args = ap.parse_args(argv)

    sess = Session.from_config(args.arch, full=args.full, device=args.device)
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
