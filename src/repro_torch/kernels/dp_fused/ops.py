"""Public corrected-noise API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``)."""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.dp_fused import ref
from repro_torch.kernels.dp_fused.dp_fused import noise_batch_cuda


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
