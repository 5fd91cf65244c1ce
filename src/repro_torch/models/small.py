"""The paper's evaluation models (section 8, Appendix B): MNIST-MLP3,
CIFAR10-CNN6 and CIFAR10-WRN28. Port of ``repro/models/small.py``.

The wire tier ships a parameter tree, not a module, so the models are
functional: ``*_apply`` over a flat dict keyed by the JAX paths
(``"l0.w"``, ``"c0.w"``, ``"g0b0.gn1.s"``, ...), every leaf in JAX's shape:
matrices ``(d_in, d_out)``, convolution kernels HWIO ``(k, k, c_in,
c_out)``. Images come in NHWC ``(B, 32, 32, 3)`` as in JAX; the
convolutions run in NCHW through ``F.conv2d`` (torch's, cuDNN on the card:
the JAX package runs ``lax.conv_general_dilated``, no Pallas kernel) and
the features are put back in (H, W, C) order before a flatten. On the
card the convolutions run in fp32 without TF32 on deterministic cuDNN
algorithms (:func:`_exact_cudnn`), so that a training run repeats bit for
bit.
:class:`MLP3` wraps MLP3's tree in an ``nn.Module`` for the user.
``SmallModel.loss`` takes ``{'x': (B, ...), 'y': (B,) int}``.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_models import CNNConfig, MLPConfig, WRNConfig
from repro_torch.models.layers import cross_entropy


def _dims(cfg: MLPConfig) -> tuple:
    return (cfg.input_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)


def mlp3_init(gen: torch.Generator, cfg: MLPConfig,
              dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on its device: each matrix a standard
    normal times ``d_in ** -0.5`` (JAX's ``dense_init``), biases zero."""
    dims = _dims(cfg)
    dev = gen.device
    params = {}
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=gen, device=dev,
                        dtype=torch.float32) * (1.0 / dims[i]) ** 0.5
        params[f"l{i}.w"] = w.to(dtype)
        params[f"l{i}.b"] = torch.zeros(dims[i + 1], dtype=dtype, device=dev)
    return params


def mlp3_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"l{i}.w"] + params[f"l{i}.b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


class MLP3(nn.Module):
    """MNIST-MLP3 as a module: one weight and one bias per layer, named and
    shaped as the functional tree (:meth:`params` gives that tree)."""

    def __init__(self, cfg: MLPConfig, gen: torch.Generator):
        super().__init__()
        tree = mlp3_init(gen, cfg)
        self.layers = nn.ModuleList()
        for i in range(len(tree) // 2):
            layer = nn.Module()
            layer.w = nn.Parameter(tree[f"l{i}.w"])
            layer.b = nn.Parameter(tree[f"l{i}.b"])
            self.layers.append(layer)

    def params(self) -> dict:
        return {f"l{i}.{k}": getattr(layer, k)
                for i, layer in enumerate(self.layers) for k in ("w", "b")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp3_apply(self.params(), x)


# ---------------------------------------------------------------------------
# CIFAR10-CNN6


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int,
               dtype=torch.float32) -> torch.Tensor:
    """An HWIO kernel: a standard normal times ``(k * k * cin) ** -0.5``."""
    w = torch.randn(k, k, cin, cout, generator=gen, device=gen.device,
                    dtype=torch.float32) * (1.0 / (k * k * cin)) ** 0.5
    return w.to(dtype)


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial dim, ``(before, after)``: the
    output is ``ceil(size / stride)`` and the odd pixel goes after, so a
    3x3 kernel at stride 2 on 32 pixels pads ``(0, 1)``."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


_cudnn_lock = threading.Lock()
_cudnn_users = [0, None]  # blocks inside, and the flags they replaced


@contextlib.contextmanager
def _exact_cudnn():
    """cuDNN in fp32 without TF32 (the JAX package's precision) and on
    deterministic algorithms for the block: the fp32 algorithms cuDNN picks
    by default are not run-to-run identical on an H100 (``chip_smoke.py``
    phase 20), and resume == uninterrupted, pipelined == serial and the
    chaos oracles compare bits. Scoped to the convolutions of these
    models, not set for the process; the flags are global, so nested and
    concurrent blocks (the wire tier's handler threads) share one setting,
    restored when the last leaves."""
    b = torch.backends.cudnn
    with _cudnn_lock:
        if _cudnn_users[0] == 0:
            _cudnn_users[1] = (b.benchmark, b.deterministic, b.allow_tf32)
            b.benchmark, b.deterministic, b.allow_tf32 = False, True, False
        _cudnn_users[0] += 1
    try:
        yield
    finally:
        with _cudnn_lock:
            _cudnn_users[0] -= 1
            if _cudnn_users[0] == 0:
                b.benchmark, b.deterministic, b.allow_tf32 = _cudnn_users[1]


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (no bias, dilation 1, one group) whose forward and
    backward both run inside :func:`_exact_cudnn` on the card; the backward
    is the one autograd would run (``aten.convolution_backward``)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: tuple):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _exact_cudnn() if x.is_cuda else contextlib.nullcontext():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _exact_cudnn() if gy.is_cuda else contextlib.nullcontext():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [ctx.stride] * 2, list(ctx.padding), [1, 1],
                False, [0, 0], 1, mask)
        return gx, gw, None, None


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int,
            padding: tuple) -> torch.Tensor:
    return _Conv2d.apply(x, w, stride, padding)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """JAX's ``_conv`` on NCHW ``x``: ``w`` HWIO, "SAME" padding. A
    symmetric padding goes to the convolution; an asymmetric one (stride 2)
    through ``F.pad`` first, which ``F.conv2d`` cannot express."""
    k = w.shape[0]
    (ht, hb), (wl, wr) = (_same_pad(x.shape[2], k, stride),
                          _same_pad(x.shape[3], k, stride))
    pad = (ht, wl)
    if (ht, wl) != (hb, wr):
        x, pad = F.pad(x, (wl, wr, ht, hb)), (0, 0)
    return _conv2d(x, w.permute(3, 2, 0, 1), stride, pad)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC images as a contiguous NCHW tensor. Not a channels-last view:
    the CPU's ``group_norm`` backward on channels-last activations loses
    3e-4 relative once a group's mean is 30 of its std (a residual stream
    does that), where the contiguous one keeps 2e-7
    (``tools/cifar_conditioning.py --gn``)."""
    return x.permute(0, 3, 1, 2).contiguous()


def _channel(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCHW."""
    return v.view(1, -1, 1, 1)


def cnn6_init(gen: torch.Generator, cfg: CNNConfig,
              dtype=torch.float32) -> dict:
    chans = (cfg.in_channels,) + tuple(cfg.channels)
    dev = gen.device
    params = {}
    for i in range(len(cfg.channels)):
        params[f"c{i}.w"] = _conv_init(gen, 3, chans[i], chans[i + 1], dtype)
        params[f"c{i}.b"] = torch.zeros(chans[i + 1], dtype=dtype, device=dev)
    feat = (cfg.image_hw // 8) ** 2 * cfg.channels[-1]  # 3 pools: hw / 8
    params["fc.w"] = (torch.randn(feat, cfg.n_classes, generator=gen,
                                  device=dev, dtype=torch.float32)
                      * (1.0 / feat) ** 0.5).to(dtype)
    params["fc.b"] = torch.zeros(cfg.n_classes, dtype=dtype, device=dev)
    return params


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 windows at stride 2, VALID (JAX's ``reduce_window`` from -inf).
    After a ReLU a window may hold tied zeros: torch sends the gradient to
    one of them, XLA's ``select_and_scatter`` maybe to another, and the
    ReLU's zero derivative there cancels it either way, so the gradients
    agree."""
    return F.max_pool2d(x, 2, 2)


def cnn6_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith("c") and k.endswith(".w"))
    x = _nchw(x)
    for i in range(n):
        x = torch.relu(_conv(x, params[f"c{i}.w"]) + _channel(params[f"c{i}.b"]))
        if i % 2 == 1:  # pool after every conv pair
            x = _maxpool(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's NHWC flatten
    return x @ params["fc.w"] + params["fc.b"]


# ---------------------------------------------------------------------------
# CIFAR10-WRN28 (WideResNet, the group-norm variant of the DP literature)


def _gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """JAX's ``_gn``: ``groups`` groups of contiguous channels, the
    population variance, ``rsqrt(var + eps)``, then the per-channel scale
    and bias."""
    return F.group_norm(x, groups, eps=eps) * _channel(scale) + _channel(bias)


def _wrn_block_init(gen: torch.Generator, prefix: str, cin: int, cout: int,
                    dtype) -> dict:
    dev = gen.device
    p = {f"{prefix}.gn1.s": torch.ones(cin, dtype=dtype, device=dev),
         f"{prefix}.gn1.b": torch.zeros(cin, dtype=dtype, device=dev),
         f"{prefix}.conv1": _conv_init(gen, 3, cin, cout, dtype),
         f"{prefix}.gn2.s": torch.ones(cout, dtype=dtype, device=dev),
         f"{prefix}.gn2.b": torch.zeros(cout, dtype=dtype, device=dev),
         f"{prefix}.conv2": _conv_init(gen, 3, cout, cout, dtype)}
    if cin != cout:
        p[f"{prefix}.proj"] = _conv_init(gen, 1, cin, cout, dtype)
    return p


def _wrn_block_apply(params: dict, prefix: str, x: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """Pre-activation: with a projection the skip is ``proj(relu(gn1(x)))``
    at the block's stride, not ``x``."""
    p = lambda name: params[f"{prefix}.{name}"]
    h = torch.relu(_gn(x, p("gn1.s"), p("gn1.b")))
    skip = _conv(h, p("proj"), stride) if f"{prefix}.proj" in params else x
    h = _conv(h, p("conv1"), stride)
    h = torch.relu(_gn(h, p("gn2.s"), p("gn2.b")))
    return _conv(h, p("conv2"), 1) + skip


def wrn28_init(gen: torch.Generator, cfg: WRNConfig,
               dtype=torch.float32) -> dict:
    n = (cfg.depth - 4) // 6  # blocks per group
    widths = [16, 16 * cfg.widen, 32 * cfg.widen, 64 * cfg.widen]
    dev = gen.device
    params = {"stem": _conv_init(gen, 3, cfg.in_channels, widths[0], dtype)}
    cin = widths[0]
    for g in range(3):
        for b in range(n):
            params.update(_wrn_block_init(gen, f"g{g}b{b}", cin,
                                          widths[g + 1], dtype))
            cin = widths[g + 1]
    params["gn_f.s"] = torch.ones(cin, dtype=dtype, device=dev)
    params["gn_f.b"] = torch.zeros(cin, dtype=dtype, device=dev)
    params["fc.w"] = (torch.randn(cin, cfg.n_classes, generator=gen,
                                  device=dev, dtype=torch.float32)
                      * (1.0 / cin) ** 0.5).to(dtype)
    params["fc.b"] = torch.zeros(cfg.n_classes, dtype=dtype, device=dev)
    return params


def wrn28_apply(params: dict, x: torch.Tensor, depth: int = 28
                ) -> torch.Tensor:
    n = (depth - 4) // 6
    x = _conv(_nchw(x), params["stem"])
    for g in range(3):
        for b in range(n):
            x = _wrn_block_apply(params, f"g{g}b{b}", x,
                                 2 if (g > 0 and b == 0) else 1)
    x = torch.relu(_gn(x, params["gn_f.s"], params["gn_f.b"]))
    x = torch.mean(x, dim=(2, 3))
    return x @ params["fc.w"] + params["fc.b"]


@dataclass(frozen=True)
class SmallModel:
    name: str
    init: Callable[[torch.Generator], dict]
    apply: Callable[..., Any]

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        return cross_entropy(self.apply(params, batch["x"]), batch["y"])

    def accuracy(self, params: dict, batch: dict) -> torch.Tensor:
        logits = self.apply(params, batch["x"])
        return torch.mean((logits.argmax(-1) == batch["y"].long()).float())


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``, the twin of
    ``jax.value_and_grad``: the gradient of ``loss_fn`` with respect to every
    tensor of the flat ``params`` dict, by autograd on detached leaves (the
    caller's tensors are not touched)."""
    def grad_fn(params: dict, batch: dict):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))
    return grad_fn


def build_small_model(cfg) -> SmallModel:
    if isinstance(cfg, MLPConfig):
        return SmallModel(cfg.name, lambda gen: mlp3_init(gen, cfg),
                          mlp3_apply)
    if isinstance(cfg, CNNConfig):
        return SmallModel(cfg.name, lambda gen: cnn6_init(gen, cfg),
                          cnn6_apply)
    if isinstance(cfg, WRNConfig):
        return SmallModel(cfg.name, lambda gen: wrn28_init(gen, cfg),
                          lambda p, x: wrn28_apply(p, x, cfg.depth))
    raise TypeError(cfg)
