"""Plain PyTorch versions of the paged-attention, page-reset and rollback
kernels.

Attention is computed in the vectorized form of the JAX package's
``paged_attention_gather``: gather the slot's pages into a contiguous view,
then one materialized masked softmax. Not bit-identical to the kernel's
online softmax (sums run in another order), equal within fp32 rounding.
Reset and rollback only write zeros, so kernel and plain version are
bit-equal; the card runs both as one batched kernel, whose plain version is
``pool_zero_ref``. The CPU tests hold them to the JAX Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels to them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, tables, q_start) -> torch.Tensor:
    """q (B, C, Hq, D); pools (N, P, Hkv, D); tables (B, nP) int;
    q_start (B,) int. Query row c of slot b sees pool positions
    ``<= q_start[b] + c`` of its own pages. Returns fp32 (B, C, Hq, D)."""
    B, C, Hq, D = q.shape
    _, P, Hkv, _ = k_pages.shape
    nP = tables.shape[1]
    G, S = Hq // Hkv, nP * P
    idx = tables.long()
    k = k_pages[idx].reshape(B, S, Hkv, D).float()  # (B, nP, P, Hkv, D) flat
    v = v_pages[idx].reshape(B, S, Hkv, D).float()
    qg = q.reshape(B, C, Hkv, G, D).float()
    scores = torch.einsum("bchgd,bkhd->bhgck", qg, k) * (1.0 / D ** 0.5)
    qpos = q_start.long()[:, None] + torch.arange(C, device=q.device)[None]
    kvpos = torch.arange(S, device=q.device)
    mask = kvpos[None, None] <= qpos[:, :, None]             # (B, C, S)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    # NEG_INF is finite: a fully masked row (inactive slot) is a finite
    # uniform average, as in the kernel
    out = torch.einsum("bhgck,bkhd->bchgd", p / l.clamp_min(1e-30), v)
    return out.reshape(B, C, Hq, D)


def paged_attention_split_ref(q, k_pages, v_pages, tables, q_start,
                              splits: int) -> torch.Tensor:
    """The CUDA kernel's own algorithm in plain torch, for the tests: the
    slot's nP pages in ``splits`` runs of ``pps = ceil(nP / splits)`` (a
    trailing run may be empty), each an online softmax page by page into a
    partial (m, l, acc) that starts at (NEG_INF, 0, 0); the runs merged in
    ascending order; ``acc / max(l, 1e-30)``. A page whose id is outside
    ``[0, N)`` is skipped, never read. When ``q_start[b] >= 0`` and page 0
    is named, every row sees position 0, and pages wholly past
    ``q_start[b] + C - 1`` are not walked; otherwise every named page is, so
    a fully masked row stays the uniform average over the named pages.
    Same arguments and result as :func:`paged_attention_ref`."""
    B, C, Hq, D = q.shape
    N, P, Hkv, _ = k_pages.shape
    nP = tables.shape[1]
    G = Hq // Hkv
    GC = G * C
    pps = -(-nP // splits)
    scale = 1.0 / D ** 0.5
    # fold: row r of kv head h is query head h*G + r // C at token r % C
    qf = q.float().reshape(B, C, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, GC, D)
    f32 = dict(dtype=torch.float32, device=q.device)
    crow = torch.arange(GC, device=q.device) % C
    out = torch.empty(B, Hkv, GC, D, **f32)
    ids = tables.tolist()
    for b in range(B):
        qs = int(q_start[b])
        named = [0 <= p < N for p in ids[b]]
        last = nP
        if qs >= 0 and named[0]:
            last = min(nP, (qs + C - 1) // P + 1)
        parts = []
        for s in range(splits):
            m = torch.full((Hkv, GC, 1), NEG_INF, **f32)
            l = torch.zeros(Hkv, GC, 1, **f32)
            acc = torch.zeros(Hkv, GC, D, **f32)
            for j in range(s * pps, min(nP, (s + 1) * pps, last)):
                if not named[j]:
                    continue
                k = k_pages[ids[b][j]].float().transpose(0, 1)   # (Hkv, P, D)
                v = v_pages[ids[b][j]].float().transpose(0, 1)
                sc = torch.einsum("hrd,hpd->hrp", qf[b], k) * scale
                pos = j * P + torch.arange(P, device=q.device)
                mask = pos[None] <= qs + crow[:, None]
                sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum("hrp,hpd->hrd", p, v)
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lt, at = torch.zeros_like(mx), torch.zeros(Hkv, GC, D, **f32)
        for m, l, acc in parts:  # ascending, as the combine kernel
            w = torch.exp(m - mx)
            lt = lt + l * w
            at = at + acc * w
        out[b] = at / lt.clamp_min(1e-30)
    return out.reshape(B, Hkv, G, C, D).permute(0, 3, 1, 2, 4).reshape(
        B, C, Hq, D)


# ---------------------------------------------------------------------------
# a model of the bf16 tensor-core kernel's arithmetic (tests only)

TC_TILE_KEYS = 16      # keys a tile (paged_attention.cu PTC_KEYS)
TC_WARP_TOKENS = 32    # tokens a warp walks: 2 tiles (PTC_TILES)
TC_CHUNK_TOKENS = 128  # tokens a block: 4 warps (PTC_CHUNK)


def paged_walk_end(qs: int, page0: int, C: int, N: int, S: int) -> int:
    """The end of a slot's walk (tokens ``[0, end)`` of its ``S``): when
    ``q_start >= 0`` and page 0 is named, every row sees position 0, so the
    keys past the last row's limit ``q_start + C - 1`` add exactly 0 and
    are not walked; otherwise every position is."""
    return min(S, qs + C) if qs >= 0 and 0 <= page0 < N else S


def split3_bf16(x: torch.Tensor) -> tuple:
    """The three-term split of an fp32 ``x`` (``csrc/mma_tile.cuh``
    ``split3``): ``hi = bf16_rn(x)``, ``mid = bf16_rn(x - hi)``, ``lo =
    bf16_rn(x - hi - mid)``, as fp32 values; each residual is exact and
    ``hi + mid + lo == x``."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def _merge(parts, D, f32):
    """(m, l, acc) partials merged in the order given: the largest m, then
    each weighed by ``exp(m - max)`` and summed."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lt = torch.zeros_like(mx)
    at = torch.zeros(*mx.shape, D, **f32)
    for m, l, acc in parts:
        w = torch.exp(m - mx)
        lt = lt + l * w
        at = at + acc * w[..., None]
    return mx, lt, at


def paged_attention_split_model(q, k_pages, v_pages, tables, q_start
                                ) -> torch.Tensor:
    """The bf16 kernel's arithmetic (``paged_attention_tc_kernel``) in plain
    torch, for the tests. Each slot walks its tokens ``[0, end)``
    (:func:`paged_walk_end`) in chunks of ``TC_CHUNK_TOKENS``: a chunk
    wholly past ``end`` is an empty partial (NEG_INF, 0, 0); otherwise each
    of its warps walks ``TC_WARP_TOKENS`` in tiles of ``TC_TILE_KEYS``, an
    online softmax from (NEG_INF, 0, 0) in which q, k and v enter as their
    bf16 values (exact products, fp32 sums) and each tile's p enters
    ``P V`` in three bf16 terms (:func:`split3_bf16`), ``acc = alpha acc +
    p_hi V + p_mid V + p_lo V``. A key past ``end``
    or on an unnamed page (an id outside ``[0, N)``, never read) scores
    -inf, a masked one NEG_INF. The block merges its warps in order, the
    combine the chunks in ascending order; ``acc / max(l, 1e-30)`` (one
    chunk: the block's own). Natural ``exp`` stands for the kernel's
    base-2 SFU exponentials. Same arguments and result as
    :func:`paged_attention_ref`."""
    B, C, Hq, D = q.shape
    N, P, Hkv, _ = k_pages.shape
    nP = tables.shape[1]
    G, S = Hq // Hkv, nP * P
    GC = G * C
    scale = 1.0 / D ** 0.5
    chunks = -(-S // TC_CHUNK_TOKENS)
    T = chunks * TC_CHUNK_TOKENS
    f32 = dict(dtype=torch.float32, device=q.device)
    qf = q.float().reshape(B, C, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, GC, D)
    crow = torch.arange(GC, device=q.device) % C
    pos = torch.arange(T, device=q.device)
    ids = tables.tolist()
    empty = (torch.full((Hkv, GC), NEG_INF, **f32), torch.zeros(Hkv, GC, **f32),
             torch.zeros(Hkv, GC, D, **f32))
    out = torch.empty(B, Hkv, GC, D, **f32)
    for b in range(B):
        qs = int(q_start[b])
        end = paged_walk_end(qs, ids[b][0], C, N, S)
        # the slot's keys in walk order, zero where not there
        page = torch.tensor(ids[b] + [-1], device=q.device)[
            torch.clamp(pos // P, max=nP)]
        there = (pos < end) & (page >= 0) & (page < N)
        k = torch.zeros(T, Hkv, D, **f32)
        v = torch.zeros(T, Hkv, D, **f32)
        k[there] = k_pages[page[there], pos[there] % P].float()
        v[there] = v_pages[page[there], pos[there] % P].float()
        lim = qs + crow
        parts = []
        for c0 in range(0, T, TC_CHUNK_TOKENS):
            if c0 >= end:
                parts.append(empty)
                continue
            warps = []
            for w0 in range(c0, c0 + TC_CHUNK_TOKENS, TC_WARP_TOKENS):
                m, l, acc = (t.clone() for t in empty)
                for k0 in range(w0, min(w0 + TC_WARP_TOKENS, end),
                                TC_TILE_KEYS):
                    ks = slice(k0, k0 + TC_TILE_KEYS)
                    sc = torch.einsum("hrd,khd->hrk", qf[b], k[ks]) * scale
                    sc = torch.where(pos[None, ks] <= lim[:, None], sc,
                                     torch.full_like(sc, NEG_INF))
                    sc = torch.where(there[ks], sc,
                                     torch.full_like(sc, float("-inf")))
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[..., None])
                    l = alpha * l + p.sum(-1)
                    acc = alpha[..., None] * acc
                    for t in split3_bf16(p):  # hi first
                        acc = acc + torch.einsum("hrk,khd->hrd", t, v[ks])
                    m = m_new
                warps.append((m, l, acc))
            parts.append(_merge(warps, D, f32))
        _, lt, at = _merge(parts, D, f32) if chunks > 1 else parts[0]
        out[b] = at / lt.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hkv, G, C, D).permute(0, 3, 1, 2, 4).reshape(
        B, C, Hq, D)


def paged_reset_ref(k_pages, v_pages, row) -> None:
    """Zero the pages named in ``row`` across every layer of the stacked
    (L, N, P, H, D) pools, in place. Repeated ids are fine."""
    idx = row.long()
    k_pages[:, idx] = 0.0
    v_pages[:, idx] = 0.0


def paged_rollback_ref(k_pages, v_pages, row, start: int, end: int) -> None:
    """Zero logical token positions ``[start, end)`` of ``row`` (nP,) int
    across every layer of the stacked (L, N, P, H, D) pools, in place.

    Page ``j`` of the row holds positions ``j*P .. j*P+P-1``; positions
    outside ``[0, nP*P)`` name no page and are skipped. The dead lanes get
    ``+0.0``, as the TPU kernel's ``jnp.where`` writes them (JAX's
    ``paged_rollback_ref`` multiplies by a 0/1 mask instead, which leaves
    ``-0.0`` for a negative value and NaN for a NaN). A repeated page id
    only zeroes the same lanes again."""
    P = k_pages.shape[2]
    lo, hi = max(int(start), 0), min(int(end), row.shape[0] * P)
    if hi <= lo:
        return
    pos = torch.arange(lo, hi, device=row.device)
    page, off = row.long()[pos // P], pos % P
    k_pages[:, page, off] = 0.0
    v_pages[:, page, off] = 0.0


def pool_zero_ref(pools, idx, slab: str) -> None:
    """The batched reset (``slab`` ``"page"``: page ids) and rollback
    (``"token"``: pool token indices ``page*P + t``): zero the slabs
    ``idx`` (host ints) in every layer of each ``(k_pages, v_pages)`` pair
    of ``pools`` (one or two stacked (L, N, P, H, D) pools sharing N, P, H
    and D), in place. Indices outside the pool (``[0, N)`` or
    ``[0, N*P)``) are skipped, as the kernel's guard skips them; repeats
    zero the same slab again. Writes +0.0."""
    if not 1 <= len(pools) <= 2:
        raise ValueError(f"pool_zero takes one or two pools, got {len(pools)}")
    if slab not in ("page", "token"):
        raise ValueError(f"slab {slab!r}: expected 'page' or 'token'")
    shapes = {tuple(t.shape[1:]) for kv in pools for t in kv}
    if len(shapes) != 1:
        raise ValueError(f"pools differ in (N, P, H, D): {sorted(shapes)}")
    N, P, H, D = shapes.pop()
    limit, width = (N, P * H * D) if slab == "page" else (N * P, H * D)
    ix = torch.as_tensor(idx, dtype=torch.long).reshape(-1)
    ix = ix[(ix >= 0) & (ix < limit)]
    for k, v in pools:
        for t in (k, v):
            t.view(t.shape[0], limit, width)[:, ix.to(t.device)] = 0.0
