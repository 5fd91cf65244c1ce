"""Plain PyTorch version of the masked-aggregate kernel.

``clip_accumulate_ref`` is the explicit left fold in silo order,
``acc = 0; acc = acc + g[i] * scale[i]``, one separate multiply and add per
row, as the CUDA kernel folds: on the card the two are bit-equal. The JAX
package's oracle (``repro/kernels/dp_clip/ref.py``) sums the same products
with ``jnp.sum``; the CPU tests hold this fold to it within fp32 rounding.
"""
from __future__ import annotations

import torch


def clip_accumulate_ref(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_i g[i] * scale[i]; g (n, P), scale (n,) -> (P,) fp32."""
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for i in range(g.shape[0]):
        acc = acc + g[i].float() * scale[i].float()
    return acc
