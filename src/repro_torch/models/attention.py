"""GQA attention with RoPE or M-RoPE: without a cache (training), over a
dense KV cache (direct serving) and over a paged KV pool (continuous
serving), causal or not (the encoder). Port of
``repro/models/attention.py``.

Prefill over the dense cache runs the flash-attention kernel; every paged
step runs the paged-attention kernel. Training attention is ``_sdpa``
(plain torch, as in the JAX package: einsum + softmax), or with
``use_flash`` (``registry.build_model(use_flash=True)``, as JAX's) the
flash kernels through ``flash_ops.FlashAttention``: the training forward
and the hand-written backward. Decode over the dense cache is
``_sdpa_masked``, plain torch as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import (_param, apply_rope, dense_init,
                                       mrope_sections_for)

NEG_INF = -1e30


class Attention(nn.Module):
    """wq/wk/wv/wo in ``(d_in, d_out)`` layout, plus bq/bk/bv when the
    config has a QKV bias (zeros at init, as in the JAX package)."""

    def __init__(self, cfg: ModelConfig, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if gen is None:  # shapes only: filled by a converter
            mk = lambda i, o: torch.empty(i, o, device=device, dtype=dtype)
        else:
            mk = lambda i, o: dense_init(gen, i, o, device, dtype)
        d = cfg.d_model
        self.wq = _param(mk(d, cfg.attn_inner))
        self.wk = _param(mk(d, cfg.kv_inner))
        self.wv = _param(mk(d, cfg.kv_inner))
        self.wo = _param(mk(cfg.attn_inner, d))
        if cfg.qkv_bias:
            z = lambda n: torch.zeros(n, device=device, dtype=dtype)
            self.bq = _param(z(cfg.attn_inner))
            self.bk = _param(z(cfg.kv_inner))
            self.bv = _param(z(cfg.kv_inner))


def _project_qkv(p: Attention, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope:
        sections = (mrope_sections_for(int(cfg.d_head * cfg.rope_pct))
                    if cfg.mrope else None)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct, sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct, sections)
    return q, k, v


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """Reference GQA attention over a whole sequence (``attention.py:55-74``
    of the JAX package): fp32 scores, finite NEG_INF mask, softmax."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, group, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / (Dh ** 0.5)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, Dh)


def _sdpa_masked(q, k, v, causal: bool, q_offset: int, valid_k):
    """Masked GQA attention over a whole cache: plain torch, as in the JAX
    package (no Pallas kernel there, so no CUDA kernel here)."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, group, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(q.dtype)).float()
    scores = scores / (Dh ** 0.5)
    mask = valid_k[None, :]
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = mask & (qpos[:, None] >= kpos[None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(q.dtype))
    return out.reshape(B, Sq, Hq, Dh)


def attn_apply(p: Attention, x, cfg: ModelConfig, positions,
               cache: Optional[dict] = None, layer: int = 0,
               use_flash: bool = False):
    """One layer's attention; returns the projected output.

    Without a cache (training): ``_sdpa`` over the sequence, or flash
    attention with ``use_flash`` (``repro/models/attention.py:102-106``).
    With the dense
    cache ``{'k', 'v': (L, B, S_max, Hkv, Dh), 'len': int}``: writes this
    layer's new K/V in place at position ``cache['len']``. A multi-token
    call is the initial prefill (``len == 0`` by construction): flash
    self-attention over the prompt. A one-token call is decode: masked
    attention over the whole cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if cache is None:
        if use_flash:
            out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=cfg.causal)
        else:
            out = _sdpa(q, k, v, cfg.causal)
        return out.reshape(B, S, cfg.attn_inner) @ p.wo.to(x.dtype)
    idx = cache["len"]
    ck, cv = cache["k"][layer], cache["v"][layer]
    ck[:, idx:idx + S] = k.to(ck.dtype)
    cv[:, idx:idx + S] = v.to(cv.dtype)
    if S > 1:
        if idx != 0:
            raise ValueError("multi-token steps need an empty cache (prefill)")
        out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=cfg.causal)
    else:
        valid = torch.arange(ck.shape[1], device=x.device) < idx + S
        out = _sdpa_masked(q, ck, cv, cfg.causal, idx, valid)
    out = out.reshape(B, S, cfg.attn_inner)
    return out @ p.wo.to(x.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_entries: int,
                  device, dtype=torch.float32) -> dict:
    """Stacked dense KV cache for ``n_entries`` layers; ``len`` is a host
    int (every row advances in lockstep), so reading it never waits on the
    device."""
    shape = (n_entries, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype),
            "len": 0}


# ---------------------------------------------------------------------------
# paged KV (serving): per-slot block tables over a shared page pool


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                    n_entries: int, device, dtype=torch.float32) -> dict:
    """Shared page pool for ``n_entries`` layers, ``(L, N, P, Hkv, Dh)``.
    Requests own disjoint page sets through block tables; a finished
    request's pages recycle into any slot after the in-kernel zeroing."""
    shape = (n_entries, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"k_pages": torch.zeros(shape, device=device, dtype=dtype),
            "v_pages": torch.zeros(shape, device=device, dtype=dtype)}


def paged_write_rows(tables, q_start, n_valid, chunk: int, page_size: int):
    """Where a (B, chunk) step's K/V rows land: ``(b, c, page, offset)``
    index tensors for the valid rows only (``c < n_valid[b]``).

    The JAX package sends rows at ``c >= n_valid`` to page id N and relies
    on ``mode="drop"`` (``attention.py:155-169``); torch raises on an
    out-of-range index, so those rows are filtered out instead. The index
    is the same for every layer, so ``forward_paged`` computes it once per
    step (one device sync, for the count of valid rows)."""
    c = torch.arange(chunk, device=tables.device)
    valid = c[None, :] < n_valid[:, None]                      # (B, C)
    b_idx, c_idx = valid.nonzero(as_tuple=True)
    pos = q_start.long()[b_idx] + c_idx
    page = tables.long()[b_idx, torch.clamp(pos // page_size, 0,
                                            tables.shape[1] - 1)]
    return b_idx, c_idx, page, pos % page_size


def paged_kv_write(k_pages, v_pages, k, v, rows) -> None:
    """Scatter a (B, C, Hkv, Dh) chunk of fresh K/V into one layer's
    (N, P, Hkv, Dh) pool in place, at the rows of ``paged_write_rows``."""
    b_idx, c_idx, page, off = rows
    k_pages[page, off] = k[b_idx, c_idx].to(k_pages.dtype)
    v_pages[page, off] = v[b_idx, c_idx].to(v_pages.dtype)


def attn_apply_paged(p: Attention, x, cfg: ModelConfig, positions, k_pages,
                     v_pages, tables, q_start, rows):
    """Paged attention step for one layer: write the chunk's K/V through
    the block table, then read the whole slot back through the paged
    kernel. The write comes first, so query row c at position
    ``q_start + c`` sees its own key (mask ``kvpos <= q_start + c``)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    paged_kv_write(k_pages, v_pages, k, v, rows)
    out = paged_ops.paged_attention(q.contiguous(), k_pages, v_pages, tables,
                                    q_start)
    out = out.to(x.dtype).reshape(B, S, cfg.attn_inner)
    return out @ p.wo.to(x.dtype)
