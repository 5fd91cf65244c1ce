"""PyTorch + CUDA port of the CITADEL++ reproduction, beside the JAX package.

Module paths mirror ``src/repro/`` (``repro/models/attention.py`` pairs with
``repro_torch/models/attention.py``). The port imports ``torch`` and numpy
only: nothing of ``jax`` and nothing of ``repro``, so it keeps its own copies
of the configs and helpers it needs. Every TPU kernel on a ported path is a
hand-written CUDA kernel for ``sm_90a`` (``kernels/*/csrc``), built at first
use; a CPU tensor takes the kernel's plain PyTorch version instead.

Ported so far: confidential serving of the dense, ssm and hybrid families,
private collaborative training of the dense family on the fused and barrier
DP tiers (``Session.train``), the wire tier's serial and pipelined protocol
rounds on the paper's MNIST-MLP3 (``CollaborativeSession``), and the
serving and training launchers. The wire tier's speculative and
fault-tolerant rounds and the other families are still to port
(``ROADMAP.md``).
"""
