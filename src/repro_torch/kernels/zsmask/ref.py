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

:func:`zsmask_buffer_ref` is the plain version of the one-launch buffer
kernel (``zsmask_buffer``): the same mask over every tensor of a packed buffer,
walking the tensors' table (``core/flatbuf.leaf_table``) with leaf i's
keys folded in (``k + mult * (i + 1)`` on both uint32 words), and with a
``prev_key`` the lambda-correction's pass over zeros fused in: ``out - lam
* (0 + (0 * (r_i - r_nxt) + s * xp))``, r_i and r_nxt drawn once. Bit-equal
to the per-leaf route it replaces (a ``zsmask`` per tensor, a second over
zeros on ``prev_key`` with ``b = 0``, ``lam * prev`` and a subtraction).

:func:`zsmask_buffer_bf16_ref` is the plain version of the bf16
instantiation (``zsmask_buffer``'s ``bf16`` / ``bf16_prev`` variants): the
same streams over the bf16 leaves of a mixed or bf16 tree, in the order
the JAX package's barrier step evaluates its perleaf contribution over a
bf16 leaf (``repro/core/dp_pipeline.py:390-414``, ``masking.py:61``), as
XLA's CPU backend runs it inside the step's ``shard_map``, settled element
for element against JAX:

1. ``x = bf16(g * scale)``, the clipped leaf rounded to bf16 (the caller's
   bf16 source buffer);
2. ``m = bf16(x + (b * (r_i - r_nxt) + s * xi))``: the zsmask adds the
   fp32 mask to the widened leaf and rounds to the leaf's dtype;
3. with the correction (lambda > 0): ``p = bf16(0 + (0 * (r_i - r_nxt) +
   s * xp))``, the mask-only pass over fp32 zeros rounded to the leaf's
   dtype, and ``out = m - lam * p`` in fp32 with one rounding, XLA's fused
   multiply-add. Inside the step ``lam = lambda * hp * gate * pa_gate``
   is a strong fp32 (the gates are traced), so ``lam * p`` promotes to
   fp32 and the contribution leaf is fp32; (a direct call with a static
   ring would make ``lam`` weakly typed and round 0.7 to bf16 first: no
   step of either package does so). The fused multiply-add is computed in
   fp64 and rounded once: the product is exact there, and the difference
   too unless the two terms lie more than 21 binades apart;
4. without the correction ``out = m``: the contribution leaf is bf16, and
   JAX's ``psum`` of bf16 leaves adds them in fp32 in silo order and
   rounds the sum once (``DPPipeline.round_aggregate``).

``out`` is the fp32 contribution row; ``out`` and the source cover the
same layout, and only the bf16 leaves' ranges of ``out`` are written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zsmask.threefry import M32, normal_stream

# the per-leaf fold of the keys: key_r, and key_xi and prev_key
R_FOLD, XI_FOLD = 0x9E3779B9, 0x85EBCA6B
# elements of one tensor drawn at a time by the buffer's plain version
WINDOW = 1 << 22


def _on(x, device) -> torch.Tensor:
    """An fp32 0-dim tensor on ``device``: a tensor moved, a number filled
    in (a fill kernel, not a copy from the host, which would wait for the
    stream: a loop of launches must not idle the card between them)."""
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


def fold_key(key, mult: int, i: int) -> tuple:
    """Leaf i's key: ``key + mult * (i + 1)`` on both uint32 words."""
    d = (mult * (i + 1)) & M32
    return (int(key[0]) + d) & M32, (int(key[1]) + d) & M32


def zsmask_buffer_ref(buf, table, key_r, key_xi, silo: int, n_silos: int,
                      sigma_c, b_scale, prev_key=None,
                      lam=None) -> torch.Tensor:
    """``buf``: the packed fp32 buffer, masked in place and returned;
    ``table``: its tensors (``core/flatbuf.leaf_table``); keys raw
    ``(k0, k1)``, folded here per leaf; scalars floats or 0-dim tensors.
    With ``prev_key`` the correction's pass is fused in, times ``lam``."""
    s, b = scalars(sigma_c, b_scale, n_silos, buf.device).unbind(0)
    lam = _on(0.0 if lam is None else lam, buf.device)
    zero = torch.zeros((), dtype=torch.float32, device=buf.device)
    silo = int(silo)
    nxt = (silo + 1) % n_silos
    for off, numel, i, ctr, _ in table:
        kr = fold_key(key_r, R_FOLD, i)
        kx = fold_key(key_xi, XI_FOLD, i)
        for a in range(0, numel, WINDOW):
            z = min(a + WINDOW, numel)
            idx = (torch.arange(a, z, dtype=torch.int64, device=buf.device)
                   + ctr) & M32
            d = (normal_stream(kr[0], kr[1], idx, silo)
                 - normal_stream(kr[0], kr[1], idx, nxt))
            seg = buf[off + a:off + z]
            out = seg + (b * d + s * normal_stream(kx[0], kx[1], idx, silo))
            if prev_key is not None:
                kp = fold_key(prev_key, XI_FOLD, i)
                xp = normal_stream(kp[0], kp[1], idx, silo)
                prev = torch.zeros_like(d) + (zero * d + s * xp)
                out.sub_(lam * prev)
            seg.copy_(out)
    return buf


def zsmask_buffer_bf16_ref(src, out, table, key_r, key_xi, silo: int,
                           n_silos: int, sigma_c, b_scale, prev_key=None,
                           lam=None) -> torch.Tensor:
    """``src``: the packed bf16 buffer of the clipped leaves; ``out``: the
    fp32 contribution row, written over ``table``'s tensors (the bf16
    leaves' rows of ``core/flatbuf.leaf_table``) and returned; keys raw
    ``(k0, k1)``, folded per leaf; scalars floats or 0-dim tensors. The
    sequence is the module docstring's."""
    s, b = scalars(sigma_c, b_scale, n_silos, out.device).unbind(0)
    lam = _on(0.0 if lam is None else lam, out.device).double()
    zero = torch.zeros((), dtype=torch.float32, device=out.device)
    silo = int(silo)
    nxt = (silo + 1) % n_silos
    for off, numel, i, ctr, _ in table:
        kr = fold_key(key_r, R_FOLD, i)
        kx = fold_key(key_xi, XI_FOLD, i)
        for a in range(0, numel, WINDOW):
            z = min(a + WINDOW, numel)
            idx = (torch.arange(a, z, dtype=torch.int64, device=out.device)
                   + ctr) & M32
            d = (normal_stream(kr[0], kr[1], idx, silo)
                 - normal_stream(kr[0], kr[1], idx, nxt))
            x = src[off + a:off + z].float()
            m = (x + (b * d + s * normal_stream(kx[0], kx[1], idx, silo))) \
                .to(torch.bfloat16).float()
            if prev_key is not None:
                kp = fold_key(prev_key, XI_FOLD, i)
                xp = normal_stream(kp[0], kp[1], idx, silo)
                p = (torch.zeros_like(d) + (zero * d + s * xp)) \
                    .to(torch.bfloat16)
                m = (m.double() - lam * p.double()).float()
            out[off + a:off + z] = m
    return out
