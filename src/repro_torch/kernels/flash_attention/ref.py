"""Plain PyTorch version of the flash-attention forward kernel: the
materialized-scores form of the JAX package's ``attention_ref`` (causal /
bidirectional, GQA, fp32 softmax)."""
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
