"""Plain PyTorch versions of the packed DP kernels.

``noise_batch_ref`` regenerates every silo's xi_t and xi_{t-1} streams with
the plain threefry (``kernels/zsmask/threefry.py``) and folds the shares onto
the aggregate in silo order, each built as the JAX package builds it,
``(0 + s_i * xi_i) - lam_i * (s_prev * xp_i)``. ``clip_mask_ref`` builds one
silo's contribution in the reference's order, ``g * scale``, then
``+ b * (r_i - r_nxt)``, then ``+ s * xi``, then ``- lam * (s_prev * xp)``,
xi and xp drawn or given (``noise_stream_ref``, one silo's stream).
Both take each multiply and add as a separate op, so on the card they are
bit-equal to their CUDA kernels. ``clip_sum_ref`` is the per-example clip
and sum of the packed (B, P) buffer: the rows' sums of squares (chunked
dot products), ``norms = sqrt(max(ss, 1e-30))``, ``scale = min(1, C /
norms)``, then ``clip_accumulate_ref``'s left fold: given the same norms it
is bit-equal to its CUDA kernel. ``base`` offsets the counters, so a window
``[base, base + len(g))`` of a long buffer can be checked on its own. On
the CPU they are held to the JAX package's oracles and Pallas kernels in
interpret mode (equal bits up to libm's ``log``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dp_clip.ref import (clip_accumulate_ref,
                                             per_example_sumsq_ref)
from repro_torch.kernels.zsmask.threefry import normal_stream


def _counters(g: torch.Tensor, base: int) -> torch.Tensor:
    """The uint32 global packed index of every element (held in int64)."""
    return (torch.arange(g.shape[0], dtype=torch.int64, device=g.device)
            + base) & 0xFFFFFFFF


def noise_batch_ref(g_sum, key_xi, prev_key, noise_scales, lam_gates,
                    prev_noise_scale, use_prev: bool = True,
                    base: int = 0) -> torch.Tensor:
    """g_sum (P,); keys (k0, k1); noise_scales / lam_gates (n,) fp32 with
    the participation gates folded in; prev_noise_scale a float32 value.
    Returns fp32 ``g_sum + sum_i (s_i xi_t^i - lam_i s_prev xi_{t-1}^i)``."""
    idx = _counters(g_sum, base)
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


def noise_stream_ref(key, silo: int, P: int, device, base: int = 0):
    """Silo ``silo``'s standard-normal stream under the raw key ``(k0, k1)``
    over the counters ``base .. base + P - 1``: (P,) fp32."""
    idx = (torch.arange(P, dtype=torch.int64, device=device) + base) \
        & 0xFFFFFFFF
    return normal_stream(key[0], key[1], idx, silo)


def clip_sum_scales(sumsq, clip_bound) -> tuple:
    """``(norms, scale)`` of ``clip_sum_ref`` from the rows' sums of
    squares: ``sqrt(max(ss, 1e-30))`` and ``min(1, C / norms)``, the
    division on the device."""
    norms = torch.sqrt(torch.clamp(sumsq, min=1e-30))
    c = _f32(clip_bound, norms.device).reshape(())
    return norms, torch.clamp(c / norms, max=1.0)


def clip_sum_ref(g, clip_bound) -> tuple:
    """g: (B, P) packed per-example grads. Returns ``(clipped sum (P,) fp32,
    per-example pre-clip norms (B,) fp32)``."""
    norms, scale = clip_sum_scales(per_example_sumsq_ref(g), clip_bound)
    return clip_accumulate_ref(g, scale), norms


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def clip_mask_defaults(silo: int, n_silos: int, sigma_c, device, nxt=None,
                       noise_scale=None, prev_noise_scale=None) -> tuple:
    """``(nxt, s, s_prev)`` with the static-ring defaults of
    ``clip_mask_pallas``: ``nxt = (silo + 1) % n``, ``s = sigma_c / sqrt(n)``
    (an fp32 division on ``device``), ``s_prev = s``."""
    if nxt is None:
        nxt = (int(silo) + 1) % n_silos
    if noise_scale is None:
        noise_scale = _f32(sigma_c, device) / torch.sqrt(
            _f32(float(n_silos), device))
    s = _f32(noise_scale, device)
    s_prev = s if prev_noise_scale is None else _f32(prev_noise_scale, device)
    return int(nxt), s, s_prev


def clip_mask_ref(g, scale, key_r, key_xi, prev_key, silo, n_silos, sigma_c,
                  b_scale, lam_gate, use_pairwise: bool = True,
                  use_prev: bool = True, *, nxt=None, noise_scale=None,
                  prev_noise_scale=None, xi=None, xp=None,
                  base: int = 0) -> torch.Tensor:
    """g: packed (P,) buffer. Returns fp32
    ``g*scale + b*(r_i - r_nxt) + s*xi_t - lam_gate*s_prev*xi_prev``, each
    stream the first normal of ``threefry2x32(key, (index, stream id))``,
    the stream id being ``silo`` for r_i, xi and xi_prev and ``nxt`` for
    r_nxt; ``xi`` / ``xp`` given as (P,) fp32 tensors take the place of
    those draws. Scalars are floats or 0-dim tensors, used as fp32."""
    dev = g.device
    nxt, s, s_prev = clip_mask_defaults(silo, n_silos, sigma_c, dev, nxt,
                                        noise_scale, prev_noise_scale)
    idx = _counters(g, base)
    silo = int(silo)
    out = g.float() * _f32(scale, dev)
    if use_pairwise:
        r_i = normal_stream(key_r[0], key_r[1], idx, silo)
        r_nxt = normal_stream(key_r[0], key_r[1], idx, nxt)
        out = out + _f32(b_scale, dev) * (r_i - r_nxt)
    if xi is None:
        xi = normal_stream(key_xi[0], key_xi[1], idx, silo)
    out = out + s * xi
    if use_prev:
        if xp is None:
            xp = normal_stream(prev_key[0], prev_key[1], idx, silo)
        out = out - _f32(lam_gate, dev) * (s_prev * xp)
    return out
