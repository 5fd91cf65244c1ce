"""Plain PyTorch versions of the flash-attention kernels: the
materialized-scores form of the JAX package's ``attention_ref`` (causal /
bidirectional, GQA, fp32 softmax), which the serving forward's kernel
answers to, and the training pair the lse forward and the backward kernel
answer to: ``flash_forward_ref`` and ``flash_backward_ref``, the custom VJP
of ``repro/kernels/flash_attention/blocked.py`` (``_fwd`` :57-92,
``_bwd_vjp`` :100-140) with every key block at once."""
from __future__ import annotations

import torch

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
