"""Quickstart on the PyTorch port: train a model under the CITADEL++
privacy barrier, then serve it, on the card: the twin of ``quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.api import Session, resolve_device
from repro_torch.configs.base import OptimizerConfig, PrivacyConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. pick an architecture (any of the 10 ids; smoke-size here) and
    #    configure the privacy barrier: 4 dataset owners, DP noise, dynamic
    #    clipping, noise correction, all of paper section 4 in one dataclass
    sess = Session.from_config(
        "qwen2.5-3b",
        privacy=PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                              dynamic_clip=True, noise_lambda=0.7,
                              n_silos=4),
        optimizer=OptimizerConfig(name="adamw", lr=1e-3), device=dev)

    # 2. train: the Session owns model building, the DP engine and the
    #    step loop
    result = sess.train(steps=args.steps, batch_size=16, seq_len=64,
                        log_every=5)
    print("final loss:", round(result.final["loss"], 4),
          "| clip bound:", round(result.final["clip_bound"], 3))

    # 3. the same session serves: batched prefill + greedy decode
    gen = sess.serve(batch_size=2, prompt_len=16, max_new_tokens=8,
                     params=result.state.params)
    print("generated:", gen.tokens.tolist())


if __name__ == "__main__":
    main()
