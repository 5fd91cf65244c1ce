"""Top-level session façade of the port:
``Session.from_config(...).train(...)`` and ``.serve(...)``.

    from repro_torch.api import Session
    from repro_torch.configs.base import OptimizerConfig, PrivacyConfig

    sess = Session.from_config(
        "qwen2.5-3b",                                       # smoke size
        privacy=PrivacyConfig(sigma=0.3, dynamic_clip=True,
                              noise_lambda=0.7, n_silos=4),
        optimizer=OptimizerConfig(name="adamw", lr=1e-3))   # on cuda
    result = sess.train(steps=20, batch_size=16, seq_len=64)
    print(result.final["loss"], result.final["epsilon"])

    gen = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                     params=result.state.params)

Port of ``repro/api.py``: serving (the dense, ssm and hybrid families), and
training the dense family on the fused and barrier DP tiers
(``PrivacyConfig(sync_path="barrier")`` with ``mesh=MeshConfig((n,),
("data",))`` runs the paper's per-silo masked contributions over n silos,
one after another on the card).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without ``device="cpu"`` they raise, never falling
back to the CPU. On the CPU every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, resolve_arch
from repro_torch.configs.base import (MeshConfig, ModelConfig,
                                      OptimizerConfig, PrivacyConfig,
                                      RunConfig)
from repro_torch.core import prng
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.distributed import steps as steps_mod
from repro_torch.models.registry import Model, build_model, training_unported
from repro_torch.runtime.trainer import Trainer, TrainerConfig


@dataclass
class TrainResult:
    """What a training run hands back: final state + the metrics history."""

    state: Any
    step: int
    metrics: list
    trainer: Trainer

    @property
    def final(self) -> dict:
        return self.metrics[-1] if self.metrics else {}


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
    """A configured model on a device, ready to train or serve."""

    cfg: ModelConfig
    run_cfg: RunConfig
    model: Model
    device: torch.device
    seed: int = 0
    _last_trainer: Optional[Trainer] = None  # the most recent train() wiring

    @classmethod
    def from_config(cls, arch: Union[str, ModelConfig], *, full: bool = False,
                    privacy: Optional[PrivacyConfig] = None,
                    optimizer: Optional[OptimizerConfig] = None,
                    mesh: Optional[MeshConfig] = None,
                    compute_dtype=torch.float32, seed: int = 0,
                    device=None) -> "Session":
        """Build a session from an arch id (or a ready ModelConfig).
        ``full=False`` loads the reduced smoke config. Privacy is off unless
        a PrivacyConfig is passed; the optimizer defaults to AdamW; the mesh
        to one data slot, the card (JAX defaults to its local devices). The
        barrier tier runs one silo per data slot of ``mesh``."""
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
        rc = RunConfig(model=cfg, privacy=privacy if privacy is not None
                       else PrivacyConfig(enabled=False),
                       optimizer=optimizer or OptimizerConfig(),
                       mesh=mesh or MeshConfig(), seed=seed)
        return cls(cfg=cfg, run_cfg=rc, model=model, device=dev, seed=seed)

    # ----------------------------------------------------------------- train
    def init_state(self, params=None):
        """A fresh TrainState: ``params`` (a ``Transformer``, e.g. carried
        across from JAX) or random weights from the session's seed, moved
        into the packed master buffer; the noise state from
        ``fold_in(PRNGKey(seed), 0xD0)``, as in JAX."""
        training_unported(self.cfg)
        gen = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return steps_mod.init_train_state(self.model, self.run_cfg,
                                          prng.PRNGKey(self.seed),
                                          params=params, gen=gen)

    def trainer(self, *, total_steps: int = 50,
                checkpoint_dir: Optional[str] = None, log_every: int = 10,
                epsilon_budget: Optional[float] = None,
                silo_epsilon_budget: Optional[float] = None,
                silo_budgets: Optional[dict] = None,
                step_deadline_s: Optional[float] = None,
                next_batch: Optional[Callable[[], dict]] = None,
                batch_size: int = 8, seq_len: int = 128,
                elastic: bool = False,
                silo_schedule: Optional[Callable[[int], Any]] = None
                ) -> Trainer:
        """A wired Trainer; ``next_batch`` defaults to a synthetic LM stream.
        ``silo_schedule`` (step -> bool sequence) pins each step's
        participation set."""
        training_unported(self.cfg)
        tcfg = TrainerConfig(total_steps=total_steps,
                             checkpoint_dir=checkpoint_dir,
                             log_every=log_every,
                             epsilon_budget=epsilon_budget,
                             silo_epsilon_budget=silo_epsilon_budget,
                             silo_budgets=silo_budgets,
                             step_deadline_s=step_deadline_s,
                             elastic=elastic)
        next_batch = next_batch or self.synthetic_batches(batch_size, seq_len)
        return Trainer(self.model, self.run_cfg, tcfg, next_batch,
                       silo_schedule=silo_schedule)

    def train(self, *, steps: int = 50, batch_size: int = 8,
              seq_len: int = 128,
              next_batch: Optional[Callable[[], dict]] = None,
              checkpoint_dir: Optional[str] = None, log_every: int = 10,
              epsilon_budget: Optional[float] = None,
              silo_epsilon_budget: Optional[float] = None,
              silo_budgets: Optional[dict] = None,
              step_deadline_s: Optional[float] = None,
              elastic: bool = False,
              silo_schedule: Optional[Callable[[int], Any]] = None,
              state=None) -> TrainResult:
        """Run training on the fused or barrier DP tier (or without
        privacy). The root key of the step keys is ``PRNGKey(seed + 1)``, as
        in JAX."""
        trainer = self.trainer(total_steps=steps, checkpoint_dir=checkpoint_dir,
                               log_every=log_every,
                               epsilon_budget=epsilon_budget,
                               silo_epsilon_budget=silo_epsilon_budget,
                               silo_budgets=silo_budgets,
                               step_deadline_s=step_deadline_s,
                               next_batch=next_batch, batch_size=batch_size,
                               seq_len=seq_len, elastic=elastic,
                               silo_schedule=silo_schedule)
        state = state if state is not None else self.init_state()
        # registered before fit, so privacy_report() surfaces the spend of a
        # run that aborts mid-way
        self._last_trainer = trainer
        state, step = trainer.fit(state, prng.PRNGKey(self.seed + 1))
        return TrainResult(state=state, step=step,
                           metrics=trainer.metrics_log, trainer=trainer)

    def privacy_report(self) -> Optional[dict]:
        """The ledger's spend report of the most recent ``train`` run; None
        before the first run or with privacy off."""
        if self._last_trainer is None:
            return None
        return self._last_trainer.spend_report()

    def synthetic_batches(self, batch_size: int, seq_len: int,
                          pool: Optional[int] = None) -> Callable[[], dict]:
        """The JAX package's synthetic LM stream (same numpy draws), as
        int64 token tensors on the session's device."""
        toks = synthetic_tokens(pool or max(64, batch_size * 4), seq_len,
                                self.cfg.vocab_size)
        rng = np.random.default_rng(self.seed)
        dev = self.device

        def next_batch():
            idx = rng.integers(0, toks.shape[0], batch_size)
            t = torch.as_tensor(toks[idx], dtype=torch.long).to(dev)
            return {"tokens": t[:, :-1], "labels": t[:, 1:]}

        return next_batch

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
              speculative: bool = False, spec_k: int = 4,
              draft_layers: Optional[int] = None,
              tenant_weights: Optional[dict] = None) -> ServeResult:
        """Greedy decoding, three ways.

        ``scheduler=None`` (default): direct batched prefill + decode over
        one dense cache, every row in lockstep, with wall-clock timings.
        ``scheduler='wave'``: the length-bucketed WaveServer baseline.
        ``scheduler='continuous'``: continuous batching over the paged,
        slot-recycled KV cache. Scheduler modes take a ``requests`` list
        (``runtime.serving.Request``); without one, ``batch_size`` uniform
        requests of ``prompt_len`` are synthesized.

        Continuous-only layers: ``prefix_sharing`` maps same-tenant shared
        prompt pages read-only; ``speculative`` adds draft-propose/verify at
        ``spec_k`` tokens per tick (``draft_layers``: an early-exit draft of
        the target's first layers; None is the self-draft);
        ``tenant_weights`` sets the deficit-round-robin admission shares.

        ``params`` brings weights from outside (e.g. carried across from
        JAX by ``models.convert.params_from_jax``); random otherwise. In
        direct mode the ssm family prefills recurrently (decode over the
        prompt, as the JAX package does), so only the wave scheduler's
        prefill runs its WKV scan; the hybrid family prefills the whole
        prompt at once in both modes."""
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
                speculative=speculative, spec_k=spec_k,
                draft_layers=draft_layers, tenant_weights=tenant_weights)
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
            if cfg.family == "ssm":  # recurrent prefill: decode the prompt
                for t in range(prompt_len):
                    logits = self.model.decode_step(params,
                                                    prompt[:, t:t + 1], cache)
            else:
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
                         speculative: bool = False, spec_k: int = 4,
                         draft_layers: Optional[int] = None,
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
                                   speculative=speculative, spec_k=spec_k,
                                   draft_layers=draft_layers,
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

