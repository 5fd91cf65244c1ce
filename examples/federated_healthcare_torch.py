"""Federated healthcare on the PyTorch port: non-IID silos under per-silo
privacy budgets, on the card: the twin of ``federated_healthcare.py``.

Four hospitals train one diagnostic model without pooling records. Each
hospital sees a skewed slice of the label space (a cardiology center
mostly classes 0-2, a trauma center mostly 7-9, and so on), so no silo's
local distribution matches the global one and no silo could train this
model alone.

Two things to watch:

  * the DP aggregate still learns the global task although every (masked,
    clipped, noised) update comes from a biased shard;
  * privacy spend is per owner, not global: hospital 3 negotiated a tight
    epsilon budget, the ledger exhausts it mid-run and excludes the silo,
    and the final per-silo report shows each owner what their records
    paid, over their own participation history.

    PYTHONPATH=src python examples/federated_healthcare_torch.py
    PYTHONPATH=src python examples/federated_healthcare_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.analysis.report import privacy_spend_table
from repro_torch.api import CollaborativeSession, resolve_device
from repro_torch.configs.base import PrivacyConfig
from repro_torch.configs.paper_models import MNIST_MLP3
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.models.small import build_small_model, value_and_grad

N_SILOS = 4
SIGMA = 0.5
STEPS = 30
TIGHT_BUDGET_SILO = 3


def label_skewed_shards(y: np.ndarray, n_silos: int) -> list:
    """Silo s holds mostly classes [3s, 3s + 3) (each hospital's case
    mix); a thin uniform remainder (referrals) keeps every class
    represented, so local losses stay finite."""
    rng = np.random.default_rng(0)
    silo_idx: list = [[] for _ in range(n_silos)]
    for i, label in enumerate(y):
        if rng.random() < 0.85:  # dominant assignment by specialty
            s = min(int(label) // 3, n_silos - 1)
        else:                    # referral noise: anyone can see anything
            s = int(rng.integers(0, n_silos))
        silo_idx[s].append(i)
    return silo_idx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== federated healthcare: non-IID silos, per-silo budgets ===")
    train, test = synthetic_mnist(n_train=4096, n_test=1024)
    y = np.asarray(train.y)
    silos = []
    for s, idx in enumerate(label_skewed_shards(y, N_SILOS)):
        shard_y = y[idx]
        counts = np.bincount(shard_y, minlength=10)
        top = np.argsort(counts)[::-1][:3]
        print(f"hospital {s}: {len(idx):4d} records, dominant classes "
              f"{sorted(int(c) for c in top)} "
              f"({counts[top].sum() / max(len(idx), 1):.0%} of shard)")
        silos.append({"x": np.asarray(train.x)[idx], "y": shard_y})

    sess = CollaborativeSession.from_silos(
        silos, PrivacyConfig(enabled=True, sigma=SIGMA, clip_bound=1.0),
        session_id="healthcare", root_seed=0,
        silo_budgets={TIGHT_BUDGET_SILO: 60.0}, device=dev)
    print(f"{N_SILOS} hospitals attested on {dev}; hospital "
          f"{TIGHT_BUDGET_SILO} capped at eps=60")

    sm = build_small_model(MNIST_MLP3)
    grad_fn = value_and_grad(sm.loss)

    def update_fn(params, update, lr):
        return {k: p - lr * torch.as_tensor(update[k], device=p.device)
                for k, p in params.items()}

    params = sm.init(torch.Generator(device=dev).manual_seed(1))
    test_b = {"x": torch.as_tensor(test.x, device=dev),
              "y": torch.as_tensor(test.y, device=dev)}

    for step in range(args.steps):
        params, loss = sess.step(step, params, grad_fn, update_fn, lr=0.5)
        if step % 10 == 0 or step == args.steps - 1:
            acc = float(sm.accuracy(params, test_b))
            eps = " ".join(f"h{s}={sess.epsilon(s):.2f}"
                           for s in range(N_SILOS))
            print(f"step {step:3d} loss={loss:.4f} test_acc={acc:.3f} | "
                  f"per-silo eps: {eps}")

    if sess.membership.excluded:
        print(f"\nledger excluded hospital(s) "
              f"{sorted(sess.membership.excluded)} mid-run: their budget "
              f"ran out, training continued without them")

    # per-owner spend over each owner's own participation history: the
    # excluded hospital's epsilon froze at exclusion while the others kept
    # spending
    print("\nper-silo spend (the ledger each owner audits):")
    for s in range(N_SILOS):
        print(f"  hospital {s}: eps={sess.epsilon(s):.3f}"
              + ("  <- capped, excluded" if s in sess.membership.excluded
                 else ""))
    print(f"global (worst-case) eps={sess.epsilon():.3f} delta=1e-5")

    print("\nsigned admin report:")
    print(privacy_spend_table(sess.privacy_report(),
                              attestation=sess.service.attestation))


if __name__ == "__main__":
    main()
