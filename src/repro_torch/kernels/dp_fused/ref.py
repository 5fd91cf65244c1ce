"""Plain PyTorch version of the corrected-noise kernel.

``noise_batch_ref`` regenerates every silo's xi_t and xi_{t-1} streams with
the plain threefry (``kernels/zsmask/threefry.py``) and folds the shares onto
the aggregate in silo order, each built as the JAX package builds it,
``(0 + s_i * xi_i) - lam_i * (s_prev * xp_i)``: separate ops, so on the card
it is bit-equal to the CUDA kernel. ``base`` offsets the counters, so a
window ``[base, base + len(g_sum))`` of a long buffer can be checked on its
own. On the CPU it is held to the JAX package's ``noise_batch_ref`` and the
Pallas kernel in interpret mode (equal bits up to libm's ``log``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zsmask.threefry import normal_stream


def noise_batch_ref(g_sum, key_xi, prev_key, noise_scales, lam_gates,
                    prev_noise_scale, use_prev: bool = True,
                    base: int = 0) -> torch.Tensor:
    """g_sum (P,); keys (k0, k1); noise_scales / lam_gates (n,) fp32 with
    the participation gates folded in; prev_noise_scale a float32 value.
    Returns fp32 ``g_sum + sum_i (s_i xi_t^i - lam_i s_prev xi_{t-1}^i)``."""
    P = g_sum.shape[0]
    idx = (torch.arange(P, dtype=torch.int64, device=g_sum.device) + base) \
        & 0xFFFFFFFF
    s_prev = float(prev_noise_scale)
    out = g_sum.float()
    for i in range(noise_scales.shape[0]):
        share = 0.0 + noise_scales[i] * normal_stream(key_xi[0], key_xi[1],
                                                      idx, i)
        if use_prev:
            xp = normal_stream(prev_key[0], prev_key[1], idx, i)
            share = share - lam_gates[i] * (s_prev * xp)
        out = out + share
    return out
