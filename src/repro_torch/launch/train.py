"""Training launcher of the port:
``python -m repro_torch.launch.train [--sync-path barrier] [options]``.

Thin CLI over :meth:`repro_torch.api.Session.train`, with the JAX package's
flags (``repro/launch/train.py``) plus ``--device``. Runs the smoke config
on ``cuda`` unless ``--device cpu``; ``--full`` takes the published config.
``--sync-path`` picks the DP tier: ``fused`` (the central aggregate) or
``barrier`` (the paper's per-silo masked contributions).

One flag reads differently from JAX's: with ``--sync-path barrier`` the
JAX CLI runs one silo per local device, while the port runs ``--silos``
silos one after another on its one card, a virtual mesh of that many data
slots (``MeshConfig((silos,), ("data",))``), which gives the JAX result on
a mesh of that many devices.

``--wire-rounds N`` runs N rounds of the wire tier's component protocol
instead (:class:`repro_torch.api.CollaborativeSession` on MNIST-MLP3 at its
published width, ``--silos`` dataset owners, synthetic MNIST), as the JAX
CLI does: pipelined, or fault-tolerant with ``--round-timeout`` (a round's
deadline), ``--quorum`` (the responders a round needs, also the
membership floor), ``--chaos-seed`` (a seeded ``FaultPlan``) and
``--journal`` (a round journal, resumed from when the file exists). Under
``--round-timeout`` the plan's hangs are scaled to outlast the deadline
(``hang_s`` at least twice it; JAX keeps 0.5 s whatever the deadline).

Not ported yet, each raising ``NotImplementedError`` with its
``ROADMAP.md`` item: ``--checkpoint-dir``, ``--elastic``,
``--silo-epsilon-budget`` and ``--mask-mode admin``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.analysis.report import privacy_spend_table
from repro_torch.api import Session
from repro_torch.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro_torch.distributed.steps import effective_n_silos

FAULT_FLAGS = ("round_timeout", "quorum", "chaos_seed", "journal")
HANG_S = 0.5  # FaultPlan.from_seed's default hang


def drop_schedule(spec: str, n_silos: int):
    """``step:silo[:cooldown]`` triples -> a stateless step -> participation
    set function (silo out from ``step`` on, for ``cooldown`` steps when it
    is given); silos past the step's count are ignored with a warning."""
    drops = []
    for part in spec.split(","):
        fields = [int(x) for x in part.split(":")]
        step0, silo = fields[0], fields[1]
        cooldown = fields[2] if len(fields) > 2 else 0
        if silo >= n_silos:
            print(f"warning: --drop-silos silo {silo} ignored (step "
                  f"aggregates over {n_silos} silos)")
            continue
        drops.append((step0, silo, cooldown))

    def schedule(step: int) -> np.ndarray:
        active = np.ones(n_silos, bool)
        for step0, silo, cooldown in drops:
            if step >= step0 and (cooldown == 0 or step < step0 + cooldown):
                active[silo] = False
        return active

    return schedule


def run_wire(args):
    """The wire tier: ``args.wire_rounds`` component-protocol rounds of
    MNIST-MLP3 (published width) over ``args.silos`` owners of synthetic
    MNIST (1024 examples), the JAX CLI's setup: pipelined, or
    fault-tolerant under the fault flags. Returns the session and the
    per-round losses."""
    import os

    from repro_torch.api import CollaborativeSession, resolve_device
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.core.tee.faults import (FaultInjector, FaultPlan,
                                             RoundJournal)
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.models.small import build_small_model, value_and_grad

    n = args.silos
    train, _ = synthetic_mnist(n_train=1024, n_test=256)
    priv = PrivacyConfig(enabled=not args.no_privacy, sigma=args.sigma,
                         clip_bound=1.0)
    sm = build_small_model(MNIST_MLP3)
    dev = resolve_device(args.device)
    params = sm.init(torch.Generator(device=dev).manual_seed(1))
    sess = CollaborativeSession.from_silos(
        [{"x": s.x, "y": s.y} for s in train.split(n)], priv, device=dev,
        params_template=params)

    def update_fn(p, update, lr):
        return {k: v - lr * torch.as_tensor(update[k], device=v.device)
                for k, v in p.items()}

    chaos = None
    if args.chaos_seed is not None:
        quorum = args.quorum or max(2, (2 * n) // 3)
        hang_s = HANG_S if args.round_timeout is None \
            else max(HANG_S, 2 * args.round_timeout)
        plan = FaultPlan.from_seed(args.chaos_seed, n, args.wire_rounds,
                                   quorum=quorum, hang_s=hang_s)
        print(f"chaos plan seed={plan.seed} hang_s={hang_s}: {plan.counts()}")
        chaos = FaultInjector(plan)
    journal = None
    if args.journal:
        if os.path.exists(args.journal):
            journal = RoundJournal.load(args.journal)
            params = sess.resume(journal)
            print(f"resumed from {args.journal}: {journal.rounds_done} "
                  f"rounds already committed")
        else:
            journal = RoundJournal(path=args.journal)

    params, losses = sess.run(params, value_and_grad(sm.loss), update_fn,
                              args.lr, args.wire_rounds,
                              round_timeout_s=args.round_timeout,
                              quorum=args.quorum, chaos=chaos,
                              journal=journal)
    stats = sess.wire_stats
    print(f"wire tier: {len(losses)} rounds closed on {sess.device}, "
          f"final loss={losses[-1]:.4f}"
          + (f" eps={sess.epsilon():.3f}" if priv.enabled else "")
          + f" | bytes: broadcast {stats['broadcast_bytes']}, updates "
          f"{stats['update_bytes']}, resync {stats['resync_bytes']}")
    print("fault stats: " + ", ".join(
        f"{k}={len(v) if isinstance(v, list) else v}"
        for k, v in sorted(sess.fault_stats.items())))
    if args.spend_report:
        with open(args.spend_report, "w") as f:
            json.dump(sess.privacy_report(), f, indent=1)
        print(f"spend report written to {args.spend_report}")
    return sess, losses


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train through repro_torch's Session (the port of "
                    "repro.launch.train).")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sigma", type=float, default=0.5)
    ap.add_argument("--lam", type=float, default=0.0)
    ap.add_argument("--dynamic-clip", action="store_true")
    ap.add_argument("--no-privacy", action="store_true")
    ap.add_argument("--silos", type=int, default=4,
                    help="silos per step; with --sync-path barrier the port "
                         "runs them one after another on its one card, a "
                         "virtual mesh of this many data slots (the JAX CLI "
                         "takes one silo per local device there)")
    ap.add_argument("--sync-path", default="fused",
                    choices=("fused", "barrier"),
                    help="fused: the central aggregate; barrier: each silo "
                         "emits its own masked contribution (clip_mask)")
    ap.add_argument("--mask-mode", default="pairwise",
                    choices=("pairwise", "admin", "none"),
                    help="zero-sum mask construction: key-derived pairwise "
                         "(default) or none (confidentiality-only); admin "
                         "is not ported yet")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="not ported yet (ROADMAP.md queue 1, item 10)")
    ap.add_argument("--epsilon-budget", type=float, default=None,
                    help="global budget: stop once the session epsilon "
                         "reaches this")
    ap.add_argument("--silo-epsilon-budget", type=float, default=None,
                    help="not ported yet (ROADMAP.md queue 1, item 10)")
    ap.add_argument("--spend-report", default=None, metavar="PATH",
                    help="write the ledger's per-silo spend report JSON here "
                         "at exit")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--elastic", action="store_true",
                    help="not ported yet (ROADMAP.md queue 1, item 10)")
    ap.add_argument("--drop-silos", default=None,
                    help="deterministic dropout: comma-separated "
                         "step:silo[:cooldown] triples, e.g. '10:3:5,20:2' "
                         "(silo 3 out for steps 10-14, silo 2 out from 20 on)")
    ap.add_argument("--wire-rounds", type=int, default=None, metavar="N",
                    help="run N rounds of the wire tier's component "
                         "protocol (CollaborativeSession on MNIST-MLP3) "
                         "instead of the trainer; combine with "
                         "--round-timeout/--quorum/--chaos-seed/--journal "
                         "for fault-tolerant rounds")
    ap.add_argument("--round-timeout", type=float, default=None,
                    metavar="S",
                    help="wire tier: per-round deadline in seconds; the "
                         "round closes at the deadline once a quorum of "
                         "updates has landed, non-responders are dropped "
                         "and the round replays over the realized set")
    ap.add_argument("--quorum", type=int, default=None,
                    help="wire tier: minimum responders to close a round "
                         "(also the membership drop floor)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="wire tier: inject a seeded FaultPlan (crashes, "
                         "hangs, drops, corruption, KDS denials, updater "
                         "crashes)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="wire tier: crash-consistent round journal; if the "
                         "file exists the run resumes from it")
    args = ap.parse_args(argv)

    if args.wire_rounds is not None:
        return run_wire(args)
    if any(getattr(args, a) is not None for a in FAULT_FLAGS):
        raise SystemExit("--round-timeout/--quorum/--chaos-seed/--journal "
                         "are wire-tier options: add --wire-rounds N")

    mesh = MeshConfig((args.silos,), ("data",)) \
        if args.sync_path == "barrier" else None
    sess = Session.from_config(
        args.arch, full=args.full, device=args.device, mesh=mesh,
        privacy=PrivacyConfig(enabled=not args.no_privacy, sigma=args.sigma,
                              clip_bound=1.0, dynamic_clip=args.dynamic_clip,
                              noise_lambda=args.lam, n_silos=args.silos,
                              sync_path=args.sync_path,
                              mask_mode=args.mask_mode),
        optimizer=OptimizerConfig(name="adamw", lr=args.lr))
    schedule = drop_schedule(args.drop_silos,
                             effective_n_silos(sess.run_cfg)) \
        if args.drop_silos else None

    result = sess.train(steps=args.steps, batch_size=args.batch,
                        seq_len=args.seq, checkpoint_dir=args.checkpoint_dir,
                        log_every=10, epsilon_budget=args.epsilon_budget,
                        silo_epsilon_budget=args.silo_epsilon_budget,
                        elastic=args.elastic, silo_schedule=schedule)
    final = result.final
    print(f"done at step {result.step} on {sess.device} "
          f"({args.sync_path} tier): "
          f"loss={final.get('loss', float('nan')):.4f}"
          + (f" eps={final['epsilon']:.3f}" if "epsilon" in final else "")
          + (f" contributions={final['n_contributions']:.0f}"
             if "n_contributions" in final else ""))

    report = sess.privacy_report()
    if report is not None:
        print("\nprivacy spend report (per-silo ledger):")
        print(privacy_spend_table(report))
        if args.spend_report:
            with open(args.spend_report, "w") as f:
                json.dump(report, f, indent=1)
            print(f"spend report written to {args.spend_report}")
    return result


if __name__ == "__main__":
    main()
