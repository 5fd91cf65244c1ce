"""Top-level session façade of the port: ``Session.from_config(...).serve(...)``.

    from repro_torch.api import Session

    sess = Session.from_config("qwen2.5-3b", full=True)   # on cuda
    gen = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16)
    print(gen.tokens[:2, :8])

Port of the serving half of ``repro/api.py``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a CUDA device and without
``device="cpu"`` they raise, never falling back to the CPU. On the CPU every
kernel runs its plain PyTorch version. Training is not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, resolve_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model


@dataclass
class ServeResult:
    """Greedy-decoded tokens + wall-clock timings."""

    tokens: np.ndarray  # (B, max_new_tokens) int32; -1-padded in scheduler mode
    prefill_s: float
    decode_s_per_token: float
    logits: Any = None  # final-step logits (B, V), on the session's device
    # scheduler mode only: the ServerStats and the completed Requests
    stats: Any = None
    requests: Any = None


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    device asked for (or the default) is CUDA and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Session:
    """A configured model on a device, ready to serve."""

    cfg: ModelConfig
    model: Model
    device: torch.device
    seed: int = 0

    @classmethod
    def from_config(cls, arch: Union[str, ModelConfig], *, full: bool = False,
                    compute_dtype=torch.float32, seed: int = 0,
                    device=None) -> "Session":
        """Build a session from an arch id (or a ready ModelConfig).
        ``full=False`` loads the reduced smoke config."""
        dev = resolve_device(device)
        if dev.type == "cuda":
            # the path is fp32 at full precision, as in the JAX package:
            # no TF32 in the fp32 matrix products
            torch.backends.cuda.matmul.allow_tf32 = False
        if isinstance(arch, ModelConfig):
            cfg = arch
        else:
            arch = resolve_arch(arch)
            cfg = get_config(arch) if full else get_smoke_config(arch)
        model = build_model(cfg, dev, compute_dtype=compute_dtype)
        return cls(cfg=cfg, model=model, device=dev, seed=seed)

    # ----------------------------------------------------------------- train
    def train(self, **kw):
        raise NotImplementedError(
            "Session.train is not ported yet: DP training is the next slice "
            "(ROADMAP.md queue 1, items 2-6)")

    # ----------------------------------------------------------------- serve
    def init_params(self):
        """Random weights from the session's seed, drawn on its device."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return self.model.init(gen)

    def serve(self, *, batch_size: int = 4, prompt_len: int = 32,
              max_new_tokens: int = 16, prompt=None, params=None,
              scheduler: Optional[str] = None, requests=None,
              max_batch: int = 8, max_len: int = 512, page_size: int = 16,
              prefill_chunk: int = 16, prefix_sharing: bool = False,
              speculative: bool = False,
              tenant_weights: Optional[dict] = None) -> ServeResult:
        """Greedy decoding, three ways.

        ``scheduler=None`` (default): direct batched prefill + decode over
        one dense cache, every row in lockstep, with wall-clock timings.
        ``scheduler='wave'``: the length-bucketed WaveServer baseline.
        ``scheduler='continuous'``: continuous batching over the paged,
        slot-recycled KV cache. Scheduler modes take a ``requests`` list
        (``runtime.serving.Request``); without one, ``batch_size`` uniform
        requests of ``prompt_len`` are synthesized.

        ``params`` brings weights from outside (e.g. carried across from
        JAX by ``models.convert.params_from_jax``); random otherwise."""
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        params = params if params is not None else self.init_params()
        if scheduler is not None:
            return self._serve_scheduled(
                scheduler, params, requests, batch_size=batch_size,
                prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                max_batch=max_batch, max_len=max_len, page_size=page_size,
                prefill_chunk=prefill_chunk, prefix_sharing=prefix_sharing,
                speculative=speculative, tenant_weights=tenant_weights)
        if prefix_sharing or speculative or tenant_weights:
            raise ValueError("prefix_sharing/speculative/tenant_weights "
                             "need scheduler='continuous'")
        if prompt is None:
            gen = torch.Generator().manual_seed(self.seed + 1)
            prompt = torch.randint(0, cfg.vocab_size, (batch_size, prompt_len),
                                   generator=gen)
        if not isinstance(prompt, torch.Tensor):
            prompt = torch.as_tensor(np.asarray(prompt))
        prompt = prompt.to(self.device, torch.long)
        batch_size, prompt_len = prompt.shape
        dev = self.device
        with torch.inference_mode():
            cache = self.model.init_cache(batch_size,
                                          prompt_len + max_new_tokens)
            _sync(dev)
            t0 = time.perf_counter()
            logits = self.model.prefill(params, prompt, cache)
            _sync(dev)
            prefill_s = time.perf_counter() - t0

            out = []
            tok = logits.argmax(-1)[:, None]
            t0 = time.perf_counter()
            for _ in range(max_new_tokens):
                out.append(tok[:, 0].cpu().numpy())
                logits = self.model.decode_step(params, tok, cache)
                tok = logits.argmax(-1)[:, None]
            _sync(dev)
            decode_s = (time.perf_counter() - t0) / max(max_new_tokens, 1)
        return ServeResult(tokens=np.stack(out, 1).astype(np.int32),
                           prefill_s=prefill_s, decode_s_per_token=decode_s,
                           logits=logits)

    def _serve_scheduled(self, scheduler: str, params, requests, *,
                         batch_size: int, prompt_len: int,
                         max_new_tokens: int, max_batch: int, max_len: int,
                         page_size: int, prefill_chunk: int,
                         prefix_sharing: bool = False,
                         speculative: bool = False,
                         tenant_weights: Optional[dict] = None) -> ServeResult:
        from repro_torch.runtime.serving import (ContinuousServer, Request,
                                                 WaveServer)

        if requests is None:
            rng = np.random.default_rng(self.seed + 1)
            requests = [Request(rid=i,
                                prompt=rng.integers(0, self.cfg.vocab_size,
                                                    prompt_len).astype(np.int32),
                                max_new_tokens=max_new_tokens)
                        for i in range(batch_size)]
        if scheduler == "wave":
            if prefix_sharing or speculative or tenant_weights:
                raise ValueError("prefix_sharing/speculative/tenant_weights "
                                 "need scheduler='continuous'")
            srv = WaveServer(self.model, params, max_batch=max_batch,
                             max_len=max_len)
        elif scheduler == "continuous":
            srv = ContinuousServer(self.model, params, max_batch=max_batch,
                                   max_len=max_len, page_size=page_size,
                                   prefill_chunk=prefill_chunk,
                                   prefix_sharing=prefix_sharing,
                                   speculative=speculative,
                                   tenant_weights=tenant_weights)
        else:
            raise ValueError(
                f"unknown scheduler {scheduler!r}: wave | continuous")
        for r in requests:
            srv.submit(r)
        t0 = time.perf_counter()
        stats = srv.run_until_drained()
        _sync(self.device)
        wall = time.perf_counter() - t0
        width = max((len(r.generated) for r in requests), default=0)
        tokens = np.full((len(requests), width), -1, np.int32)
        for i, r in enumerate(requests):
            tokens[i, :len(r.generated)] = r.generated
        return ServeResult(tokens=tokens, prefill_s=0.0,
                           decode_s_per_token=wall / max(stats.useful_tokens, 1),
                           stats=stats, requests=requests)

