"""Public per-leaf zero-sum mask API: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (``kernels.dispatch.on_cuda``)."""
from __future__ import annotations

from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.zsmask import ref
from repro_torch.kernels.zsmask.zsmask import zsmask_cuda


def apply_zsmask(g, key_r, key_xi, silo: int, n_silos: int, sigma_c,
                 b_scale, offset: int = 0, out=None):
    """g: flat (D,) -> ``g + m_silo`` (fp32), one dispatch; ``offset`` the
    counter of g's first element within its leaf (any offset, on either
    route; JAX's Pallas kernel takes whole flats only). ``out`` receives
    the result (``g`` itself to work in place)."""
    if not on_cuda(g):
        res = ref.zsmask_ref(g, key_r, key_xi, silo, n_silos, sigma_c,
                             b_scale, offset)
        return res if out is None else out.copy_(res)
    return zsmask_cuda(g, ref.scalars(sigma_c, b_scale, n_silos, g.device),
                       key_r, key_xi, int(silo), (int(silo) + 1) % n_silos,
                       int(offset) & 0xFFFFFFFF, out=out)
