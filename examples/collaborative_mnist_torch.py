"""End-to-end CITADEL++ collaborative training (paper Fig. 1 workflow) on
the PyTorch port, on the card: the twin of ``collaborative_mnist.py``.

  * 4 dataset owners (hospitals) + 1 model owner, mutually untrusted
  * the management service deploys attested components; the KDS releases
    keys only to components whose measurement matches the service code
  * the model owner's code runs inside the sandbox, on the card; each
    update crosses the privacy barrier (clip -> zero-sum DP mask, one
    ``clip_mask`` kernel launch) before it leaves its silo
  * the model updater only ever sees masked updates; the aggregate is
    DP-SGD-noisy; the ledger tracks each owner's (eps, delta) spend

All of that wiring lives in ``repro_torch.api.CollaborativeSession``; this
example supplies the data, the model owner's code and the training loop.

    PYTHONPATH=src python examples/collaborative_mnist_torch.py
    PYTHONPATH=src python examples/collaborative_mnist_torch.py --device cpu
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== CITADEL++ collaborative training (protocol tier, PyTorch) ===")
    train, test = synthetic_mnist(n_train=4096, n_test=1024)
    sess = CollaborativeSession.from_silos(
        [{"x": s.x, "y": s.y} for s in train.split(N_SILOS)],
        PrivacyConfig(enabled=True, sigma=SIGMA, clip_bound=1.0),
        session_id="demo", root_seed=0, device=dev)
    print(f"management service up; expected service-code measurement: "
          f"{sess.expected_measurement[:16]}…")
    print(f"{N_SILOS} data handlers attested on {dev}; keys released via KDS")

    # the model owner's confidential code (runs sandboxed in each handler)
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
            print(f"step {step:3d} loss={loss:.4f} test_acc={acc:.3f} "
                  f"eps={sess.epsilon():.3f}")

    # what did the updater see? masked noise, not gradients
    w = np.concatenate([np.asarray(x).ravel() for x in
                        sess.updater.received_updates[-1].values()])
    print(f"\nlast wire update: std={w.std():.2f} (raw clipped grad scale "
          f"~1e-3) -> the updater sees noise, the aggregate learns")
    print(f"privacy spent after {args.steps} steps: eps={sess.epsilon():.3f} "
          f"(delta=1e-5)")

    # pipelined rounds: the updater ingests each sealed update as it
    # arrives while the admin fans out the next round's keys, bit-identical
    # to the serial loop above
    params, losses = sess.run(params, grad_fn, update_fn, lr=0.5,
                              n_rounds=10, pipelined=True)
    print(f"\n10 pipelined rounds: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    stats = sess.wire_stats
    print(f"bytes on wire per round: broadcast "
          f"{stats['broadcast_bytes'] // stats['rounds']:,} (XOR delta, sent "
          f"once) + updates {stats['update_bytes'] // stats['rounds']:,}")

    # the admin plane: per-silo spend, HMAC-signed with a key derived from
    # the admin's attestation identity
    print("\nper-silo spend report (the ledger the admin surfaces to owners):")
    print(privacy_spend_table(sess.privacy_report(),
                              attestation=sess.service.attestation))


if __name__ == "__main__":
    main()
