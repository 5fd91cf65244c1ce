"""Plain PyTorch versions of the flash-attention kernels: the
materialized-scores form of the JAX package's ``attention_ref`` (causal /
bidirectional, GQA, fp32 softmax), which the serving forward's kernel
answers to, and the training pair the lse forward and the backward kernel
answer to: ``flash_forward_ref`` and ``flash_backward_ref``, the custom VJP
of ``repro/kernels/flash_attention/blocked.py`` (``_fwd`` :57-92,
``_bwd_vjp`` :100-140) with every key block at once.

Beside them, for the tests only (nothing on the main path calls them), a
plain model of the tensor-core kernels' arithmetic: ``split_bf16`` and
``flash_forward_split_model`` / ``flash_backward_split_model``, with
``terms=2`` for the bf16 pair (the forward's p as three bf16 terms, the
backward's p and ds as two) and ``terms=3`` for the fp32 pair (every
operand as three, ``split3_bf16``). The serving
forward is the lse forward's kernel without its lse, so its ``out`` is the
forward model's too."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import split3_bf16

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) with Hq % Hkv == 0. Returns
    (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, group, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (D ** 0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _scores(qg, k, causal: bool) -> torch.Tensor:
    """fp32 (B, Hkv, G, Sq, Sk) scores of grouped queries ``qg`` (B, Sq,
    Hkv, G, D), times 1/sqrt(D) (``blocked.py`` multiplies), NEG_INF above
    the diagonal. Query head h = hk * G + g reads KV head hk, as
    ``blocked.repeat_kv`` repeats it."""
    Sq, D, Sk = qg.shape[1], qg.shape[-1], k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / D ** 0.5)
    if causal:
        mask = (torch.arange(Sq, device=qg.device)[:, None]
                >= torch.arange(Sk, device=qg.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_forward_ref(q, k, v, causal: bool = True):
    """The training forward: (out (B, Sq, Hq, D) in q's dtype, lse (B, Hq,
    Sq) fp32). fp32 inside; ``lse = m + log(max(l, 1e-30))`` and ``out =
    acc / max(l, 1e-30)``, rounded once to q's dtype, as ``_fwd`` ends."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    s = _scores(q.reshape(B, Sq, Hkv, Hq // Hkv, D).float(), k, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B, Hq, Sq)
    return out.reshape(B, Sq, Hq, D).to(q.dtype), lse


def flash_backward_ref(q, k, v, out, lse, dout, causal: bool = True):
    """``_bwd_vjp``: (dq, dk, dv), each in its input's dtype, from the
    saved q, k, v, the rounded ``out``, the fp32 ``lse`` (B, Hq, Sq) and the
    cotangent ``dout``. fp32 inside: ``delta = sum(dout * out)`` over D from
    the rounded ``out``; ``p = exp(s - lse)``; ``ds = p * (dp - delta) *
    scale``; dk and dv summed over the G query heads of each KV head."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    grouped = lambda t: t.reshape(B, Sq, Hkv, G, D).float()  # noqa: E731
    qg, og, dog = grouped(q), grouped(out), grouped(dout)
    delta = (dog * og).sum(dim=-1).permute(0, 2, 3, 1)       # (B, Hkv, G, Sq)
    s = _scores(qg, k, causal)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq)[..., None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / D ** 0.5)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# a model of the tensor-core kernels' arithmetic (tests only)

TC_FWD_COLS = 64   # the bf16 lse forward's key tile (flash_attention.cu TC_COLS)
TC_DQ_KEYS = 64    # the bf16 dq pass's key tile (flash_attention_bwd.cu TB_K)
TC_DKDV_ROWS = 32  # the bf16 dk/dv pass's query tile (TB_QT)
X3_FWD_KEYS = 16   # the fp32 lse forward's key tile (X3_KEYS)
X3_WARP_ROWS = 16  # the fp32 passes: a warp's rows of a walked tile of 32
# (XB_WALK): the pair's first warp takes the even 16-row sub-tiles, the
# second the odd ones
# the five smaller term products of two three-term operands, smallest first
# (a's term, b's term; 0 hi, 1 mid, 2 lo), then hi hi (mma_tile.cuh mma_x5,
# mma_x6_add)
X3_ORDER = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-term split of an fp32 ``x``: ``hi = bf16_rn(x)``, ``lo =
    bf16_rn(x - hi)`` (``x - hi`` is exact in fp32), both as fp32 values;
    ``|x - hi - lo| <= 2^-16 |x|``."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_mm(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """``a`` (fp32) split in two, each term's product with ``b`` (bf16
    values in fp32) summed in fp32, hi first: two mma into one
    accumulator."""
    hi, lo = split_bf16(a)
    return torch.einsum(eq, hi, b) + torch.einsum(eq, lo, b)


def _x3_terms(a: torch.Tensor, b: torch.Tensor, eq: str) -> list:
    """The six products of ``a`` and ``b`` (fp32), each as its three bf16
    terms, in ``X3_ORDER``; the three dropped lie below 2^-24 of the
    product."""
    sa, sb = split3_bf16(a), split3_bf16(b)
    return [torch.einsum(eq, sa[i], sb[j]) for i, j in X3_ORDER]


def _x3_dot(a, b, eq: str) -> torch.Tensor:
    """A product from zero (the scores, dp): the five smaller terms summed
    in order, hi hi added last (the kernels keep them in two
    accumulators)."""
    t = _x3_terms(a, b, eq)
    small = t[0]
    for x in t[1:5]:
        small = small + x
    return small + t[5]


def _x3_acc(acc, a, b, eq: str) -> torch.Tensor:
    """One 16-row k-step of a sum that runs over many (P V, dV, dK, dQ):
    the six term products summed from zero in order, then added to
    ``acc`` (the kernels' ``mma_x6_add``)."""
    t = _x3_terms(a, b, eq)
    step = t[0]
    for x in t[1:]:
        step = step + x
    return acc + step


def _causal(s: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """``s`` with -inf where a key lies past its query (p = 0 there)."""
    return torch.where(rows[:, None] >= cols[None, :], s,
                       torch.full_like(s, float("-inf")))


def flash_forward_split_model(q, k, v, causal: bool = True, terms: int = 2):
    """The forward's arithmetic on the tensor cores (serving's and
    training's: one kernel a dtype). ``terms=2``, the bf16 kernel
    (``flash_fwd_lse_tc_kernel``): bf16 q, k, v enter as they are (their
    products exact, summed in fp32); the online softmax walks key tiles of
    ``TC_FWD_COLS`` in fp32, and each tile's p enters ``P V`` as three bf16
    terms (:func:`split3_bf16`), ``acc = alpha acc + p_hi V + p_mid V +
    p_lo V`` (the backward's p and ds stay two terms). ``terms=3``, the fp32
    kernel (``flash_fwd_lse_x3_kernel``): tiles of ``X3_FWD_KEYS``; q, k,
    p and v enter as three terms each, the scores as :func:`_x3_dot` and
    ``acc = alpha acc`` plus the tile's six products of p and v
    (:func:`_x3_acc`). Then ``lse = m + log(max(l, 1e-30))``, ``out = acc /
    max(l, 1e-30)`` rounded once to q's dtype. Natural ``exp`` stands for
    the kernels' base-2 SFU exponentials (within 2 ulp). Returns (out,
    lse) as ``flash_forward_ref`` does."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / D ** 0.5
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    rows = torch.arange(Sq)
    m = torch.full((B, Hkv, G, Sq), NEG_INF)
    l = torch.zeros(B, Hkv, G, Sq)
    acc = torch.zeros(B, Hkv, G, Sq, D)
    cols = TC_FWD_COLS if terms == 2 else X3_FWD_KEYS
    for k0 in range(0, Sk, cols):
        kt = k[:, k0:k0 + cols].float()
        vt = v[:, k0:k0 + cols].float()
        if terms == 2:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kt) * scale
        else:
            s = _x3_dot(qg, kt, "bqhgd,bkhd->bhgqk") * scale
        if causal:
            s = _causal(s, rows, torch.arange(k0, k0 + kt.shape[1]))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        if terms == 2:
            acc = alpha[..., None] * acc
            for t in split3_bf16(p):  # hi first
                acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", t, vt)
        else:
            acc = _x3_acc(alpha[..., None] * acc, p, vt, "bhgqk,bkhd->bhgqd")
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype), (m + torch.log(l)).reshape(B, Hq, Sq)


def flash_backward_split_model(q, k, v, out, lse, dout, causal: bool = True,
                               terms: int = 2):
    """The backward's arithmetic on the tensor cores, with the combine
    (``flash_bwd_combine_kernel``): delta from the rounded out; p = exp(s
    scale - lse) and ds = p (dp - delta) scale in fp32, 0 past the
    diagonal; the G heads' fp32 dk/dv partials of a KV head fold in
    ascending head order; each gradient is rounded once.

    ``terms=2``, the bf16 kernels (``flash_bwd_dq_tc_kernel``,
    ``flash_bwd_dkdv_tc_kernel``): s and dp from the bf16 inputs; dq sums
    key tiles of ``TC_DQ_KEYS`` in order, ``dq += ds_hi K + ds_lo K``; each
    query head's dk and dv sum query tiles of ``TC_DKDV_ROWS`` in order
    (``dv += p_hi^T dO + p_lo^T dO``, ``dk += ds_hi^T Q + ds_lo^T Q``).

    ``terms=3``, the fp32 kernels (``flash_bwd_dq_x3_kernel``,
    ``flash_bwd_dkdv_x3_kernel``): every operand as three terms; s and dp
    as :func:`_x3_dot`; dq sums the six products of ds and K
    (:func:`_x3_acc`) over key tiles of ``X3_WARP_ROWS``, the even tiles
    and the odd ones apart (a warp pair's two warps), then even + odd; dk
    and dv the same over query tiles. Returns (dq, dk, dv) as
    ``flash_backward_ref`` does."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / D ** 0.5
    grouped = lambda t: t.float().reshape(B, Sq, Hkv, G, D)  # noqa: E731
    qg, og, dog = grouped(q), grouped(out), grouped(dout)
    kf, vf = k.float(), v.float()
    delta = (dog * og).sum(dim=-1).permute(0, 2, 3, 1)       # (B, Hkv, G, Sq)
    lse_g = lse.reshape(B, Hkv, G, Sq)
    dot = (lambda a, b, eq: torch.einsum(eq, a, b)) if terms == 2 else _x3_dot

    def p_ds(qs, ks, q0, k0):
        """p and ds of query rows qs.. and keys ks.. (B, Hkv, G, q, k)."""
        qt, dot_ = qg[:, q0:q0 + qs], dog[:, q0:q0 + qs]
        kt, vt = kf[:, k0:k0 + ks], vf[:, k0:k0 + ks]
        s = dot(qt, kt, "bqhgd,bkhd->bhgqk") * scale
        if causal:
            s = _causal(s, torch.arange(q0, q0 + qt.shape[1]),
                        torch.arange(k0, k0 + kt.shape[1]))
        p = torch.exp(s - lse_g[..., q0:q0 + qt.shape[1], None])
        dp = dot(dot_, vt, "bqhgd,bkhd->bhgqk")
        return p, p * (dp - delta[..., q0:q0 + qt.shape[1], None]) * scale

    if terms == 2:
        dq = torch.zeros(B, Sq, Hkv, G, D)
        for k0 in range(0, Sk, TC_DQ_KEYS):
            _, ds = p_ds(Sq, TC_DQ_KEYS, 0, k0)
            dq += _split_mm(ds, kf[:, k0:k0 + TC_DQ_KEYS], "bhgqk,bkhd->bqhgd")
        dk_h = torch.zeros(B, Hkv, G, Sk, D)
        dv_h = torch.zeros(B, Hkv, G, Sk, D)
        for q0 in range(0, Sq, TC_DKDV_ROWS):
            p, ds = p_ds(TC_DKDV_ROWS, Sk, q0, 0)
            dv_h += _split_mm(p, dog[:, q0:q0 + TC_DKDV_ROWS],
                              "bhgqk,bqhgd->bhgkd")
            dk_h += _split_mm(ds, qg[:, q0:q0 + TC_DKDV_ROWS],
                              "bhgqk,bqhgd->bhgkd")
    else:
        w = X3_WARP_ROWS
        dqs = [torch.zeros(B, Sq, Hkv, G, D) for _ in range(2)]
        for i, k0 in enumerate(range(0, Sk, w)):
            _, ds = p_ds(Sq, w, 0, k0)
            dqs[i % 2] = _x3_acc(dqs[i % 2], ds, kf[:, k0:k0 + w],
                                 "bhgqk,bkhd->bqhgd")
        dq = dqs[0] + dqs[1]
        dks = [torch.zeros(B, Hkv, G, Sk, D) for _ in range(2)]
        dvs = [torch.zeros(B, Hkv, G, Sk, D) for _ in range(2)]
        for i, q0 in enumerate(range(0, Sq, w)):
            p, ds = p_ds(w, Sk, q0, 0)
            dvs[i % 2] = _x3_acc(dvs[i % 2], p, dog[:, q0:q0 + w],
                                 "bhgqk,bqhgd->bhgkd")
            dks[i % 2] = _x3_acc(dks[i % 2], ds, qg[:, q0:q0 + w],
                                 "bhgqk,bqhgd->bhgkd")
        dk_h, dv_h = dks[0] + dks[1], dvs[0] + dvs[1]
    dk, dv = dk_h[:, :, 0], dv_h[:, :, 0]
    for g in range(1, G):
        dk, dv = dk + dk_h[:, :, g], dv + dv_h[:, :, g]
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
