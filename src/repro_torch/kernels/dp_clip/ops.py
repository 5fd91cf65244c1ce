"""Public masked-aggregate API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (``kernels.dispatch.on_cuda``)."""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.dp_clip import ref
from repro_torch.kernels.dp_clip.dp_clip import clip_accumulate_cuda


def clip_accumulate(g, scale):
    """sum_i g[i] * scale[i] over a stacked (n, P) buffer -> (P,) fp32: the
    fused tier's masked aggregate (n = silos, P = the packed length)."""
    if on_cuda(g, scale):
        return clip_accumulate_cuda(g, scale)
    return ref.clip_accumulate_ref(g, scale)
