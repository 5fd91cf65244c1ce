"""Core layer primitives: dense init, RMSNorm, LayerNorm, RoPE (plain,
partial and M-RoPE), SwiGLU and the LM losses.

Port of ``repro/models/layers.py``. Weights keep the JAX package's
``x @ W`` layout, ``(d_in, d_out)``, so weights carried across need no
transpose and the two packages compute the same products. Parameters are
created without gradients, for serving; the training path makes them
trainable (``packing.pack_params``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _param(t: torch.Tensor, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, device,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=gen, device=device,
                    dtype=torch.float32) * (1.0 / d ** 0.5)
    return w.to(dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in fp32, eps 1e-6 (``layers.py:24-29``); returns x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device, dtype=torch.float32):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device, dtype=dtype))


class LayerNorm(nn.Module):
    """Scale (ones) and bias (zeros): ``layernorm_init`` of the JAX
    package."""

    def __init__(self, d: int, device, dtype=torch.float32):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device, dtype=dtype))
        self.bias = _param(torch.zeros(d, device=device, dtype=dtype))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm in fp32, eps 1e-5, population variance (``layers.py:36-42``
    of the JAX package); returns x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """x (B, S, H, Dh); positions (B, S) int, or (3, B, S) for M-RoPE.
    Rotates INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` like the JAX
    package (``layers.py:80-83``), not the rotate-half convention.

    M-RoPE (Qwen2-VL): with (3, B, S) positions and ``mrope_sections``, the
    d_rot/2 frequency bands split across the (t, h, w) axes, section i
    taking its angles from axis i. (3, B, S) positions without sections
    rotate by the t axis; sections with (B, S) positions rotate plainly."""
    dh = x.shape[-1]
    d_rot = int(dh * rope_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    inv = rope_freqs(d_rot, theta, x.device)                   # (d_rot/2,)
    if positions.dim() == 3 and mrope_sections is not None:
        ang_all = positions[..., None].float() * inv           # (3, B, S, d/2)
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(ang_all[i, ..., start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                         # (B, S, d_rot/2)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions[..., None].float() * inv               # (B, S, d_rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rot = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rot.to(x.dtype), x_pass], dim=-1)


def mrope_sections_for(d_rot: int) -> tuple[int, int, int]:
    """Qwen2-VL's (t, h, w) split of the d_rot/2 frequency bands: (16, 24,
    24) at d_rot 128."""
    half = d_rot // 2
    hw = half * 3 // 8
    return (half - 2 * hw, hw, hw)


class XlaSilu(torch.autograd.Function):
    """SiLU in bf16 as XLA evaluates ``jax.nn.silu`` (``x * logistic(x)``)
    on the JAX package's training path: the logistic expanded to
    ``1 / (1 + exp(-x))`` and every op rounded to bf16, then its
    derivative ``c * s + (c * x) * (s * (1 - s))``, each op rounded too.
    ``F.silu`` computes in fp32 and rounds once, forward and backward: one
    ulp apart on a quarter of the elements."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, c):
        x, s = ctx.saved_tensors
        return c * s + (c * x) * (s * (1 - s))


class XlaSigmoid(torch.autograd.Function):
    """The logistic in bf16 as XLA evaluates ``jax.nn.sigmoid`` on the JAX
    package's training path: ``1 / (1 + exp(-x))``, every op rounded to
    bf16, and its derivative ``c * (s * (1 - s))``, each op rounded too
    (:class:`XlaSilu`'s logistic). ``torch.sigmoid`` computes in fp32 and
    rounds once: one ulp apart on about a third of the elements."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, c):
        (s,) = ctx.saved_tensors
        return c * (s * (1 - s))


def xla_silu(x: torch.Tensor, train: bool) -> torch.Tensor:
    """SiLU: :class:`XlaSilu` on the bf16 training path, ``F.silu``
    otherwise."""
    return XlaSilu.apply(x) if train and x.dtype == torch.bfloat16 \
        else F.silu(x)


def xla_sigmoid(x: torch.Tensor, train: bool) -> torch.Tensor:
    """The logistic: :class:`XlaSigmoid` on the bf16 training path,
    ``torch.sigmoid`` otherwise."""
    return XlaSigmoid.apply(x) if train and x.dtype == torch.bfloat16 \
        else torch.sigmoid(x)


def swiglu_apply(p: "SwiGLU", x: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
    """``train``: the training forward, whose bf16 SiLU follows XLA's order
    (:class:`XlaSilu`); serving and fp32 keep ``F.silu``."""
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    return (xla_silu(g, train) * u) @ p.w_down.to(x.dtype)


class SwiGLU(nn.Module):
    """Gate, up and down projections, each ``(d_in, d_out)``."""

    def __init__(self, d: int, d_ff: int, device, dtype=torch.float32,
                 gen: torch.Generator | None = None):
        super().__init__()
        if gen is None:  # shapes only: filled by a converter
            mk = lambda i, o: torch.empty(i, o, device=device, dtype=dtype)
        else:
            mk = lambda i, o: dense_init(gen, i, o, device, dtype)
        self.w_gate = _param(mk(d, d_ff))
        self.w_up = _param(mk(d, d_ff))
        self.w_down = _param(mk(d_ff, d))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, fp32 logsumexp. logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def chunked_lm_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked LM cross-entropy, the sum over chunks divided by the
    token count (``layers.py`` of the JAX package). ``S % chunk != 0`` falls
    back to one chunk, as there. The label log-prob is a gather: the JAX
    one-hot einsum adds exact zeros to the same product, so they agree."""
    B, S, D = x.shape
    if S % chunk != 0:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        xs = x[:, c * chunk:(c + 1) * chunk]
        logits = (xs @ head.to(xs.dtype)).float()            # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels[:, c * chunk:(c + 1) * chunk, None].long())
        total = total + torch.sum(lse - ll[..., 0])
    return total / (B * S)
