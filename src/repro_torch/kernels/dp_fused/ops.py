"""Public API of the packed DP kernels: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors (``kernels.dispatch.on_cuda``), and the
pack -> kernel -> unpack tree helpers of ``repro/kernels/dp_fused/ops.py``.
``clip_mask`` with external ``xi`` / ``xp`` streams goes to the
external-stream kernel on the card (JAX sends such calls to its jnp
reference; the port has no fallback), and ``noise_stream`` draws one
silo's stream for them."""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels.dispatch import check_tensor, on_cuda
from repro_torch.kernels.dp_fused import ref
from repro_torch.kernels.dp_fused.dp_fused import (check_stream,
                                                   clip_mask_cuda,
                                                   clip_mask_ext_cuda,
                                                   clip_sum_cuda,
                                                   noise_batch_cuda,
                                                   noise_stream_cuda)


def noise_batch(g_sum, key_xi, prev_key, noise_scales, lam_gates,
                prev_noise_scale, use_prev: bool = True):
    """The packed aggregate plus every silo's corrected-noise share, one
    dispatch: ``g_sum + sum_i (s_i xi_t^i - lam_i s_prev xi_{t-1}^i)``.
    Keys are raw ``(k0, k1)``; ``noise_scales`` / ``lam_gates`` are (n,)
    vectors with the caller's participation gates folded in."""
    if on_cuda(g_sum, noise_scales, lam_gates):
        return noise_batch_cuda(g_sum, key_xi, prev_key, noise_scales,
                                lam_gates, prev_noise_scale, use_prev)
    return ref.noise_batch_ref(g_sum, key_xi, prev_key, noise_scales,
                               lam_gates, prev_noise_scale, use_prev)


def clip_mask(g, scale, key_r, key_xi, prev_key, silo: int, n_silos: int,
              sigma_c, b_scale, lam_gate, use_pairwise: bool = True,
              use_prev: bool = True, *, nxt=None, noise_scale=None,
              prev_noise_scale=None, xi=None, xp=None, out=None):
    """One silo's contribution off its packed (P,) gradient, one dispatch:
    ``g*scale + b*(r_i - r_nxt) + s*xi_t - lam_gate*s_prev*xi_prev``.
    Defaults as ``clip_mask_pallas``: ``nxt = (silo + 1) % n_silos``,
    ``s = sigma_c / sqrt(n_silos)``, ``s_prev = s``; the barrier tier passes
    the active ring's neighbour and the per-stream stds of the active counts.
    Scalars are floats or 0-dim tensors (kept on the card: no host sync).
    ``xi`` / ``xp``: the silo's xi_t and xi_{t-1} streams, (P,) fp32 on
    ``g``'s device (``noise_stream``), in place of the in-kernel draws.
    ``out`` receives the result (``g`` itself to work in place)."""
    dev = g.device
    nxt, s, s_prev = ref.clip_mask_defaults(silo, n_silos, sigma_c, dev, nxt,
                                            noise_scale, prev_noise_scale)
    if not on_cuda(g):
        for name, x in (("xi", xi), ("xp", xp)):
            if x is not None:
                check_stream(name, x, g)
        res = ref.clip_mask_ref(g, scale, key_r, key_xi, prev_key, silo,
                                n_silos, sigma_c, b_scale, lam_gate,
                                use_pairwise, use_prev, nxt=nxt,
                                noise_scale=s, prev_noise_scale=s_prev,
                                xi=xi, xp=xp)
        return res if out is None else out.copy_(res)
    scalars = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                           device=dev).reshape(())
                           for x in (scale, s, b_scale, lam_gate, s_prev)])
    if xi is not None or xp is not None:
        return clip_mask_ext_cuda(g, xi, xp, scalars, key_r, key_xi,
                                  prev_key, int(silo), nxt, use_pairwise,
                                  use_prev, out=out)
    return clip_mask_cuda(g, scalars, key_r, key_xi, prev_key, int(silo), nxt,
                          use_pairwise, use_prev, out=out)


def noise_stream(key, silo: int, out):
    """Silo ``silo``'s standard-normal stream under the raw key ``(k0,
    k1)``, over the counters ``0 .. P-1``, into ``out`` ((P,) fp32): the
    xi stream ``clip_mask`` draws in the kernel for the same key and
    silo."""
    if on_cuda(out):
        return noise_stream_cuda(key, int(silo), out)
    check_tensor("out", out, torch.float32, 1, out.device)
    return out.copy_(ref.noise_stream_ref(key, silo, out.shape[0],
                                          out.device))


def clip_sum_packed(g, clip_bound):
    """g: (B, P) packed per-example grads -> (clipped sum (P,), pre-clip
    norms (B,)), one dispatch. ``clip_bound`` a float or a 0-dim tensor
    (a tensor on the card is read there: no host sync)."""
    if not on_cuda(g):
        return ref.clip_sum_ref(g, clip_bound)
    c = torch.as_tensor(clip_bound, dtype=torch.float32,
                        device=g.device).reshape(1)
    return clip_sum_cuda(g, c)


def packed_clip_and_sum(buf, clip_bound, layout):
    """Per-example clip over the (B, P) per-example buffer (one example's
    ``layout``) in one dispatch. Returns ``(clipped-sum tree fp32, views
    into one buffer; per-example norms)``."""
    summed, norms = clip_sum_packed(buf, clip_bound)
    return flatbuf.unpack(layout, summed, dtype=torch.float32), norms


def packed_mask_tree(grads, key_r, key_xi, silo: int, n_silos: int, sigma_c,
                     b_scale):
    """Pairwise zero-sum mask over a whole tree in one ``clip_mask``
    dispatch (scale 1, no correction term). Returns the masked tree, views
    into one fp32 buffer."""
    layout = flatbuf.layout_of(grads)
    packed = flatbuf.pack(layout, grads)
    masked = clip_mask(packed, 1.0, key_r, key_xi, key_xi, silo, n_silos,
                       sigma_c, b_scale, 0.0, use_pairwise=True,
                       use_prev=False, out=packed)
    return flatbuf.unpack(layout, masked)
