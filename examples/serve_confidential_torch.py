"""Confidential serving on the PyTorch port: the twin of
``serve_confidential.py``. The model owner seals the weights into
untrusted storage; the serving component attests, gets the key from the
KDS, opens the weights inside its trust domain and serves them through
``Session.serve`` with the continuous-batching scheduler. Isolation between
requests is enforced in the paged-attention path (block-table indirection
and in-kernel zeroing of recycled pages), so slot recycling is safe rather
than forbidden. The wave baseline runs the same requests for comparison.

    PYTHONPATH=src python examples/serve_confidential_torch.py
    PYTHONPATH=src python examples/serve_confidential_torch.py --device cpu
"""
import argparse
import copy

from repro_torch.api import Session, resolve_device
from repro_torch.core.tee.attestation import LaunchPolicy
from repro_torch.core.tee.channels import derive_key, open_sealed, seal
from repro_torch.core.tee.components import (Component, ManagementService,
                                             _deser, _ser)
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.runtime.serving import zipf_requests


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sess = Session.from_config("qwen2.5-3b", device=dev)

    # --- model owner seals the weights into untrusted storage ------------
    svc = ManagementService()
    owner_key = derive_key(b"model-owner-master", "weights-v1")
    params = sess.init_params()
    svc.storage.put("model-v1", seal(owner_key,
                                     _ser(params_to_numpy(params))))
    svc.kds.upload_key("model-v1", owner_key, "model-owner",
                       svc.expected_measurement(), svc.policy.hash())
    print("encrypted model uploaded to untrusted storage")

    # --- the serving component attests, gets the key, opens the weights --
    server = Component("server-0", svc)
    server.attest(LaunchPolicy())
    key = svc.kds.request_key("model-v1", server.report)
    params = params_from_jax(_deser(open_sealed(key,
                                                svc.storage.get("model-v1"))),
                             sess.cfg, dev)
    print(f"server attested; weights decrypted inside the trust domain, "
          f"on {dev}")

    # --- serve through the session: continuous vs wave -------------------
    # a heavy-tailed workload: many short prompts, a few long ones
    reqs = zipf_requests(16, sess.cfg.vocab_size, max_len=48,
                         max_new_low=4, max_new_high=24, seed=7)
    res = sess.serve(scheduler="continuous", requests=copy.deepcopy(reqs),
                     params=params, max_batch=4, max_len=96)
    base = sess.serve(scheduler="wave", requests=copy.deepcopy(reqs),
                      params=params, max_batch=4, max_len=96)

    print(f"{len(reqs)} requests, 4 slots: continuous (paged, "
          f"slot-recycled) vs wave (fresh cache per wave):")
    for name, s in (("continuous", res.stats), ("wave", base.stats)):
        print(f"  {name:11s} utilization={s.utilization:.3f} "
              f"p50={s.p50_latency_steps:.0f} p99={s.p99_latency_steps:.0f} "
              f"steps ({s.useful_tokens} tokens)")
    print("generated (continuous):", res.tokens[:2, :8].tolist())


if __name__ == "__main__":
    main()
