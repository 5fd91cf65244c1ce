"""The per-leaf ``jax.random.normal`` draw as one CUDA kernel (``ops``)
beside its plain PyTorch version (``ref``)."""
