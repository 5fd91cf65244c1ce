"""Public per-leaf zero-sum mask API: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (``kernels.dispatch.on_cuda``): one tensor
(:func:`apply_zsmask`) or every tensor of a packed buffer in one launch
(:func:`zsmask_buffer`; the bf16 leaves of a bf16 or mixed tree through
:func:`zsmask_buffer_bf16`). A CUDA tensor goes to its kernel or raises:
nothing there falls back to the plain version."""
from __future__ import annotations

from repro_torch.core import flatbuf
from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.zsmask import ref
from repro_torch.kernels.zsmask.zsmask import (zsmask_buffer_bf16_cuda,
                                               zsmask_buffer_cuda,
                                               zsmask_cuda)


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


def zsmask_buffer(buf, layout, key_r, key_xi, silo: int, n_silos: int,
                  sigma_c, b_scale, prev_key=None, lam=None, dtype=None):
    """The per-leaf mask of silo ``silo`` over every tensor of ``buf``, the
    packed (P,) fp32 buffer of ``layout``, in place, one dispatch: leaf i's
    keys folded from the raw step keys, each tensor at its counter offset
    in its leaf, the padding untouched. With ``prev_key`` (lambda > 0) the
    correction's pass is fused in: ``- lam * (s * xi_{t-1})`` with its r
    terms zeroed, as the per-leaf route's second pass. The scalars are
    floats or 0-dim tensors; on the card, tensors there are read in place
    (no launch to gather them). ``dtype`` (a name) masks only the tensors
    of that dtype's leaves (None: every tensor). Returns ``buf``."""
    if not on_cuda(buf):
        return ref.zsmask_buffer_ref(buf, flatbuf.leaf_table(layout, dtype),
                                     key_r, key_xi, silo, n_silos, sigma_c,
                                     b_scale, prev_key, lam)
    dev = buf.device
    return zsmask_buffer_cuda(
        buf, layout, ref._on(sigma_c, dev), ref._on(b_scale, dev), key_r,
        key_xi, int(silo), (int(silo) + 1) % n_silos, n_silos, prev_key,
        _lam(prev_key, lam, dev), dtype)


def zsmask_buffer_bf16(src, out, layout, key_r, key_xi, silo: int,
                       n_silos: int, sigma_c, b_scale, prev_key=None,
                       lam=None):
    """The per-leaf mask of silo ``silo`` over the bf16 leaves of
    ``layout``: ``src`` the packed (P,) bf16 buffer of the clipped leaves,
    ``out`` the (P,) fp32 contribution row, written over those leaves'
    tensors and returned, in JAX's barrier-step order over a bf16 leaf
    (``ref.zsmask_buffer_bf16_ref``); one dispatch, none without a bf16
    leaf. The rest as :func:`zsmask_buffer`."""
    if not on_cuda(out):
        return ref.zsmask_buffer_bf16_ref(
            src, out, flatbuf.leaf_table(layout, "bfloat16"), key_r, key_xi,
            silo, n_silos, sigma_c, b_scale, prev_key, lam)
    dev = out.device
    return zsmask_buffer_bf16_cuda(
        src, out, layout, ref._on(sigma_c, dev), ref._on(b_scale, dev),
        key_r, key_xi, int(silo), (int(silo) + 1) % n_silos, n_silos,
        prev_key, _lam(prev_key, lam, dev))


def _lam(prev_key, lam, dev):
    return None if prev_key is None else \
        ref._on(0.0 if lam is None else lam, dev)
