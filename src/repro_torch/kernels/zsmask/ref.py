"""Plain PyTorch version of the per-leaf zero-sum mask kernel.

Port of ``repro/kernels/zsmask/ref.py``: the pairwise construction on a
static ring of n silos,

    g + (b * (r_silo - r_nxt) + s * xi_silo),   nxt = (silo + 1) % n,

``s = sigma_c / sqrt(n)`` in fp32, each stream the first normal of
``threefry2x32(key, (offset + index, stream id))`` (``kernels/zsmask/
threefry.py``), the stream id being ``silo`` for r_i and xi and ``nxt`` for
r_nxt. The r-terms telescope to zero over the ring. ``offset`` shifts the
uint32 counters (they wrap as JAX's do), so one tensor of a stacked leaf is
masked as that slice of the whole leaf. Each multiply and add is a separate
op in the reference's order: on the card this is bit-equal to the CUDA
kernel; on the CPU it is held to the JAX oracle and Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zsmask.threefry import M32, normal_stream


def _on(x, device) -> torch.Tensor:
    """An fp32 0-dim tensor on ``device``: a tensor moved, a number filled
    in (a fill kernel, not a copy from the host, which would wait for the
    stream: the perleaf mask makes these once per leaf tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def scalars(sigma_c, b_scale, n_silos: int, device) -> torch.Tensor:
    """``(s, b)`` as an fp32 (2,) tensor on ``device``: ``s = sigma_c /
    sqrt(n)``, an fp32 division on the device, as JAX divides."""
    s = _on(sigma_c, device) / torch.sqrt(_on(float(n_silos), device))
    return torch.stack([s, _on(b_scale, device)])


def zsmask_ref(g, key_r, key_xi, silo: int, n_silos: int, sigma_c, b_scale,
               offset: int = 0) -> torch.Tensor:
    """g: flat (D,) gradient slice; keys ``(k0, k1)``; scalars floats or
    0-dim tensors. Returns ``g + m_silo`` in fp32."""
    s, b = scalars(sigma_c, b_scale, n_silos, g.device).unbind(0)
    idx = (torch.arange(g.shape[0], dtype=torch.int64, device=g.device)
           + int(offset)) & M32
    silo = int(silo)
    nxt = (silo + 1) % n_silos
    r_i = normal_stream(key_r[0], key_r[1], idx, silo)
    r_nxt = normal_stream(key_r[0], key_r[1], idx, nxt)
    xi = normal_stream(key_xi[0], key_xi[1], idx, silo)
    return g.float() + (b * (r_i - r_nxt) + s * xi)
