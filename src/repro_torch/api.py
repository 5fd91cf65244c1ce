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

Port of ``repro/api.py``: serving and training every family of the JAX
package (dense, moe, vlm, ssm, hybrid; the encoder, hubert-xlarge, trains
and refuses to decode), training on the fused and barrier DP tiers
(``PrivacyConfig(sync_path="barrier")`` with ``mesh=MeshConfig((n,),
("data",))`` runs the paper's per-silo masked contributions over n silos,
one after another on the card), and the wire tier's protocol rounds,
serial, pipelined, speculative and fault-tolerant
(:class:`CollaborativeSession`, on the paper's small models).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without ``device="cpu"`` they raise, never falling
back to the CPU. On the CPU every kernel runs its plain PyTorch version.

Serving in bf16: ``Session.from_config(arch, compute_dtype=torch.bfloat16)``
(fp32 weights cast in the forward pass, the caches and page pools in bf16,
the attention and page-pool kernels' bf16 instantiations on the card), or
bf16 weights too through ``models.registry.build_model(cfg, device,
param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)`` in a
``Session``. The one-call :func:`train` and :func:`serve` split off
``from_config``'s keywords, as JAX's do.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, resolve_arch
from repro_torch.configs.base import (SHAPES, MeshConfig, ModelConfig,
                                      OptimizerConfig, PrivacyConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.core import prng
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.distributed import steps as steps_mod
from repro_torch.models.registry import Model, build_model
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
                    shape: Union[str, ShapeConfig] = "train_4k",
                    compute_dtype=torch.float32, seed: int = 0,
                    device=None) -> "Session":
        """Build a session from an arch id (or a ready ModelConfig).
        ``full=False`` loads the reduced smoke config. Privacy is off unless
        a PrivacyConfig is passed; the optimizer defaults to AdamW; the mesh
        to one data slot, the card (JAX defaults to its local devices). The
        barrier tier runs one silo per data slot of ``mesh``. ``shape`` (a
        name in ``SHAPES`` or a ``ShapeConfig``) is stored in
        ``run_cfg.shape``, as JAX's is; neither train nor serve reads it."""
        dev = resolve_device(device)
        if dev.type == "cuda":
            # the path is fp32 at full precision, as in the JAX package:
            # no TF32 in the fp32 matrix products and convolutions; and
            # cuBLAS's bf16 products reduce in fp32 and round once, as the
            # CPU's do
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        if isinstance(arch, ModelConfig):
            cfg = arch
        else:
            arch = resolve_arch(arch)
            cfg = get_config(arch) if full else get_smoke_config(arch)
        model = build_model(cfg, dev, compute_dtype=compute_dtype)
        rc = RunConfig(model=cfg,
                       shape=SHAPES[shape] if isinstance(shape, str)
                       else shape,
                       privacy=privacy if privacy is not None
                       else PrivacyConfig(enabled=False),
                       optimizer=optimizer or OptimizerConfig(),
                       mesh=mesh or MeshConfig(), seed=seed)
        return cls(cfg=cfg, run_cfg=rc, model=model, device=dev, seed=seed)

    def with_run_config(self, **overrides) -> "Session":
        """A copy of this session with RunConfig fields replaced."""
        return dataclasses.replace(self,
                                   run_cfg=self.run_cfg.replace(**overrides))

    # ----------------------------------------------------------------- train
    def init_state(self, params=None):
        """A fresh TrainState: ``params`` (the family's module, a
        ``Transformer``, ``RWKVStack`` or ``Hybrid``, e.g. carried across
        from JAX) or random weights from the session's seed, moved into the
        packed master buffer; the noise state from
        ``fold_in(PRNGKey(seed), 0xD0)``, as in JAX."""
        gen = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return steps_mod.init_train_state(self.model, self.run_cfg,
                                          prng.PRNGKey(self.seed),
                                          params=params, gen=gen)

    def trainer(self, *, total_steps: int = 50,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 25, log_every: int = 10,
                epsilon_budget: Optional[float] = None,
                silo_epsilon_budget: Optional[float] = None,
                silo_budgets: Optional[dict] = None,
                step_deadline_s: Optional[float] = None,
                next_batch: Optional[Callable[[], dict]] = None,
                batch_size: int = 8, seq_len: int = 128,
                elastic: bool = False,
                silo_schedule: Optional[Callable[[int], Any]] = None,
                silo_latency_hook: Optional[Callable[[int], Any]] = None
                ) -> Trainer:
        """A wired Trainer; ``next_batch`` defaults to a synthetic LM stream.

        ``checkpoint_dir`` checkpoints every ``checkpoint_every`` steps and
        at the end, and resumes from the latest checkpoint there (the state,
        the ledger, the metrics history). ``elastic=True`` lets straggler
        escalations drop a silo for a cooldown; ``silo_schedule`` (step ->
        bool sequence) pins each step's participation set.
        ``silo_epsilon_budget`` (uniform) / ``silo_budgets`` (per-silo
        overrides) arm the ledger's enforcement: an exhausted silo leaves
        the set with no rejoin until an operator override.
        ``step_deadline_s`` is the straggler deadline, and
        ``silo_latency_hook`` feeds per-silo latencies to the straggler
        attribution."""
        tcfg = TrainerConfig(total_steps=total_steps,
                             checkpoint_every=checkpoint_every,
                             checkpoint_dir=checkpoint_dir,
                             log_every=log_every,
                             epsilon_budget=epsilon_budget,
                             silo_epsilon_budget=silo_epsilon_budget,
                             silo_budgets=silo_budgets,
                             step_deadline_s=step_deadline_s,
                             elastic=elastic or silo_schedule is not None)
        next_batch = next_batch or self.synthetic_batches(batch_size, seq_len)
        return Trainer(self.model, self.run_cfg, tcfg, next_batch,
                       silo_schedule=silo_schedule,
                       silo_latency_hook=silo_latency_hook)

    def train(self, *, steps: int = 50, batch_size: int = 8,
              seq_len: int = 128,
              next_batch: Optional[Callable[[], dict]] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 25, log_every: int = 10,
              epsilon_budget: Optional[float] = None,
              silo_epsilon_budget: Optional[float] = None,
              silo_budgets: Optional[dict] = None,
              step_deadline_s: Optional[float] = None,
              elastic: bool = False,
              silo_schedule: Optional[Callable[[int], Any]] = None,
              silo_latency_hook: Optional[Callable[[int], Any]] = None,
              state=None) -> TrainResult:
        """Run (or resume, from ``checkpoint_dir``) training on the fused or
        barrier DP tier (or without privacy). The root key of the step keys
        is ``PRNGKey(seed + 1)``, as in JAX.

        ``synthetic_batches`` feeds tokens, as the JAX package's does; a
        ``next_batch`` of ``embeds`` (B, S, D) and ``labels``, with
        ``positions`` (B, S) or M-RoPE's (3, B, S), trains the vlm and the
        encoder on their frontends' embeddings: the batch passes through
        unchanged, each silo taking its rows."""
        trainer = self.trainer(total_steps=steps, checkpoint_dir=checkpoint_dir,
                               checkpoint_every=checkpoint_every,
                               log_every=log_every,
                               epsilon_budget=epsilon_budget,
                               silo_epsilon_budget=silo_epsilon_budget,
                               silo_budgets=silo_budgets,
                               step_deadline_s=step_deadline_s,
                               next_batch=next_batch, batch_size=batch_size,
                               seq_len=seq_len, elastic=elastic,
                               silo_schedule=silo_schedule,
                               silo_latency_hook=silo_latency_hook)
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

    # --------------------------------------------------------- introspection
    def kernel_impls(self) -> dict:
        """What dispatch can pick for each kernel: ``cuda`` (the
        hand-written kernel, for CUDA tensors) and ``plain`` (its plain
        PyTorch version, for CPU tensors) for every kernel of
        ``kernels.dispatch.KERNELS``, the hardware kernel first as in the
        JAX package's lists; and for the three tree-level policies the
        names ``resolve_tree`` takes (``packed``, ``perleaf`` and the legacy
        ``pallas`` and ``jnp``)."""
        from repro_torch.kernels import dispatch

        impls = {name: ["cuda", "plain"] for name in dispatch.KERNELS}
        impls.update({name: list(dispatch.TREE_IMPLS)
                      for name in dispatch.TREE_KERNELS})
        return dict(sorted(impls.items()))



@dataclass
class CollaborativeSession:
    """Protocol-tier façade (paper Fig. 1): a management service, KDS and
    attested components wired for one collaborative-training session. Port
    of ``repro.api.CollaborativeSession``, serial and pipelined rounds.

    ``from_silos`` does the setup: deploy the service, attest each dataset
    owner's data handler against the launch policy, release per-owner
    channel keys through the KDS and connect the model updater. Each round
    (:meth:`step`, or :meth:`run` for several) the admin distributes the
    keys, the participation set and the budget verdicts; each active handler
    computes its clipped, masked contribution on the session's device (one
    ``clip_mask`` launch on a card) and seals it; the updater decrypts and
    sums the contributions on the host (it only ever sees masked ones),
    divides by the contributors and runs the model owner's ``update_fn``;
    the ledger records the round's participation.

    The model owner's code: ``grad_fn(params, data) -> (loss, grads)`` on
    flat dicts of tensors on the device (``models.small.value_and_grad``),
    and ``update_fn(params, mean_update, lr) -> params`` where
    ``mean_update`` is a numpy tree the function moves onto the params'
    device. Membership is elastic: ``drop_silo`` / ``rejoin_silo`` change
    who contributes from the next round on; an exhausted budget excludes a
    silo until ``rejoin_silo(..., override=True)``; ``rejoin_silo_async``
    re-admits a dropped silo with a fresh attestation, key release and warm
    resync.

    :meth:`run` drives several rounds: serial, pipelined, speculative (the
    handlers' noise streams cached and prefetched on the card) or
    fault-tolerant (deadline and quorum closure, seeded chaos, a round
    journal that :meth:`resume` continues from; ``docs/failure_model.md``).
    Under ``mask_mode='admin'`` the admin draws each round's closing mask
    row once, on the session's device, and ships it to the closing handler;
    every other handler draws its own row.
    """

    service: Any
    privacy: PrivacyConfig
    handlers: list
    updater: Any
    admin: Any
    accountant: Any  # the session's PrivacyLedger (admin-owned)
    n_silos: int
    device: torch.device
    clip_bound: float = 1.0
    membership: Any = None
    telemetry: Any = None  # per-party round-trip attribution
    codec: str = "packed"  # packed flat buffers | legacy pickle
    batch_mac: bool = False  # a Merkle batch tag per round
    # the delta broadcast: the last broadcast's packed buffer and layout,
    # and the epoch (handlers resync on a gap)
    _bcast_buf: Any = None
    _bcast_layout: Any = None
    _bcast_epoch: int = 0
    wire_stats: Any = None  # bytes on the wire
    # the fault-tolerance plane (docs/failure_model.md): an optional
    # FaultInjector driving seeded chaos, and the session's fault counters
    chaos: Any = None
    fault_stats: Any = None

    def __post_init__(self):
        if self.wire_stats is None:
            self.wire_stats = {"rounds": 0, "broadcast_bytes": 0,
                               "resync_bytes": 0, "update_bytes": 0}
        if self.fault_stats is None:
            self.fault_stats = {"transient_retries": 0, "kds_retries": 0,
                                "integrity_failures": [],
                                "rounds_replayed": 0, "quorum_closures": 0,
                                "deadline_hits": 0, "updater_recoveries": 0}
        # silos dropped by deadline/quorum closure (silo -> the round it
        # went down), for rejoin; silo -> a worker still running past its
        # round's deadline
        self._downed: dict = {}
        self._inflight: dict = {}
        self._stats_lock = threading.Lock()

    @classmethod
    def from_silos(cls, silo_data: list, privacy: PrivacyConfig, *,
                   session_id: str = "session", root_seed: int = 0,
                   silo_epsilon_budget: Optional[float] = None,
                   silo_budgets: Optional[dict] = None,
                   codec: str = "packed", params_template=None,
                   batch_mac: Optional[bool] = None,
                   shard_workers: Optional[int] = None,
                   received_cap: Optional[int] = None,
                   device=None) -> "CollaborativeSession":
        """``silo_data``: one batch dict per dataset owner (numpy arrays or
        tensors), moved onto the session's device, where it stays.
        ``device``: ``cuda`` unless the caller names another; without a card
        and without ``device='cpu'`` this raises.

        ``silo_epsilon_budget`` / ``silo_budgets`` arm per-owner budgets
        (the ledger config joins the attestation measurement). ``codec``:
        ``'packed'`` (raw buffers, XOR-delta broadcast, the fast channel) or
        ``'pickle'`` (pickle+npz blobs, the per-block channel).
        ``params_template`` pins the packed layout's fingerprint into every
        component's measurement. ``batch_mac`` (default: on for the
        packed codec) authenticates each round's updates through the
        admin's Merkle batch tag, off by each message's HMAC.
        ``shard_workers``: the updater's accumulation threads (default 4
        from 32 silos up, serial below). ``received_cap``: the updater's
        audit trail of updates (default ``max(256, 2n)``; entries aged out
        are counted in ``truncated_entries``)."""
        from repro_torch.core import flatbuf, prng
        from repro_torch.core.privacy import PrivacyLedger
        from repro_torch.core.tee import wire
        from repro_torch.core.tee.channels import (VER_FAST, VER_LEGACY,
                                                   SecureChannel, derive_key)
        from repro_torch.core.tee.components import (Admin, DataHandler,
                                                     ManagementService,
                                                     ModelUpdater)
        from repro_torch.runtime.elastic import SiloMembership
        from repro_torch.runtime.straggler import SiloTelemetry

        dev = resolve_device(device)
        if dev.type == "cuda":
            # fp32 at full precision, as in the JAX package: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        n = len(silo_data)
        ledger = PrivacyLedger.from_privacy_config(
            privacy, n, epsilon_budget=silo_epsilon_budget,
            budgets=silo_budgets)
        svc = ManagementService()
        wire_config = {"codec": wire.WIRE_CODEC_ID if codec == "packed"
                       else "pickle-npz-v0"}
        if params_template is not None and codec == "packed":
            wire_config["layout"] = wire.layout_fingerprint(
                flatbuf.layout_of(params_template)).hex()
        svc.create_session(session_id, n, privacy,
                           ledger_config=ledger.config_dict(),
                           wire_config=wire_config)
        chan_ver = VER_FAST if codec == "packed" else VER_LEGACY
        handlers = []
        for i, data in enumerate(silo_data):
            local = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
            h = DataHandler(f"handler-{i}", svc, silo_idx=i, data=local,
                            codec=codec, device=dev)
            h.attest(svc.policy)
            svc.kds.upload_key(f"dk-{i}", derive_key(b"session-root",
                                                     f"dk-{i}"),
                               f"owner-{i}", svc.expected_measurement(),
                               svc.policy.hash())
            key = svc.kds.request_key(f"dk-{i}", h.report)
            h.channel = SecureChannel(key, h.name, version=chan_ver)
            handlers.append(h)
        updater = ModelUpdater("updater", svc)
        updater.attest(svc.policy)
        updater.shard_workers = shard_workers if shard_workers is not None \
            else (4 if n >= 32 else 0)
        updater.received_cap = received_cap if received_cap is not None \
            else max(256, 2 * n)
        for h in handlers:
            updater.channels[h.name] = SecureChannel(
                svc.kds._records[f"dk-{h.silo_idx}"].key, h.name,
                version=chan_ver)
        admin = Admin("admin", svc, root_key=prng.PRNGKey(root_seed),
                      n_silos=n, ledger=ledger)
        admin.attest(svc.policy)  # signs spend reports with this identity
        # the admin<->updater aggregation key for the batch tags, released
        # only against both components' measurements
        svc.kds.upload_key("dk-agg", derive_key(b"session-root", "dk-agg"),
                           "model-owner", svc.expected_measurement(),
                           svc.policy.hash())
        admin.agg_key = svc.kds.request_key("dk-agg", admin.report)
        updater.agg_key = svc.kds.request_key("dk-agg", updater.report)
        for h in handlers:
            h.admin = admin  # verdicts from the attested admin only
        return cls(service=svc, privacy=privacy, handlers=handlers,
                   updater=updater, admin=admin, accountant=ledger,
                   n_silos=n, device=dev, clip_bound=privacy.clip_bound,
                   membership=SiloMembership(n),
                   telemetry=SiloTelemetry(n), codec=codec,
                   batch_mac=batch_mac if batch_mac is not None
                   else codec == "packed")

    def drop_silo(self, silo: int, step: Optional[int] = None,
                  cooldown: Optional[int] = None) -> bool:
        """Remove a dataset owner from the next rounds (False when the
        quorum would break)."""
        step = self._next_round if step is None else step
        return self.membership.drop(silo, step, cooldown)

    def drop_slowest(self, step: Optional[int] = None,
                     cooldown: Optional[int] = None) -> Optional[int]:
        """Drop the silo whose handler round trips have been slowest."""
        step = self._next_round if step is None else step
        return self.membership.drop_one(step, cooldown,
                                        telemetry=self.telemetry)

    def rejoin_silo(self, silo: int, step: Optional[int] = None,
                    override: bool = False) -> bool:
        """Membership only: the handler resyncs with a full blob inside its
        first round back. A budget-excluded owner needs ``override``."""
        return self.membership.rejoin(
            silo, step=self._next_round if step is None else step,
            override=override)

    def rejoin_silo_async(self, silo: int, override: bool = False) -> bool:
        """Mid-round rejoin: the dropped owner's handler re-attests, gets
        its channel key re-released through the KDS and is warm-resynced to
        the current params epoch now, while a round in flight runs on
        without it; it contributes from the next round on (where
        :meth:`rejoin_silo` leaves the resync to its first round back).

        A transient KDS denial (``faults.KdsTransientDenial``) is retried
        with deterministic-jitter backoff; an attestation
        ``PermissionError`` is an integrity failure and propagates. The
        membership flips last, after attestation and key release, so a
        failure leaves it untouched; a budget-excluded owner is refused
        before any attestation or KDS traffic unless ``override``."""
        from repro_torch.core.tee.channels import (VER_FAST, VER_LEGACY,
                                                   SecureChannel)
        from repro_torch.core.tee.faults import Backoff, KdsTransientDenial

        if silo in self.membership.excluded and not override:
            # records the refusal, changes nothing
            return self.membership.rejoin(silo, step=self._next_round,
                                          override=False)
        h = self.handlers[silo]
        # a handler whose measurement drifted while it was out gets no key
        h.attest(self.service.policy)
        backoff = Backoff(seed=silo)
        while True:
            try:
                key = self.service.kds.request_key(f"dk-{silo}", h.report)
                break
            except KdsTransientDenial:
                with self._stats_lock:
                    self.fault_stats["kds_retries"] += 1
                if not backoff.sleep():
                    raise
        if not self.membership.rejoin(silo, step=self._next_round,
                                      override=override):
            return False
        ver = VER_FAST if self.codec == "packed" else VER_LEGACY
        # both channel ends anew: the replay counters restart in step
        h.channel = SecureChannel(key, h.name, version=ver)
        self.updater.channels[h.name] = SecureChannel(key, h.name, version=ver)
        if self._bcast_buf is not None:
            # warm resync at the current epoch: the next delta chains
            blob = self._resync_blob()
            self.wire_stats["resync_bytes"] += len(blob)
            h._sync_params(blob)
        return True

    def resume(self, journal):
        """Continue from a ``faults.RoundJournal`` after a driver restart:
        replay each committed round's participation set through the admin
        (the correction state and the ledger land where the crashed driver
        left them), re-drop the journaled downed silos, and return the
        journaled params as tensors on the session's device (None for an
        empty journal). The next :meth:`run` starts at the next round with
        a full broadcast, bit-identical from there on to a driver that never
        stopped: every stream is keyed by the round index."""
        from repro_torch.core.tee import wire
        from repro_torch.core.tee.components import _on_device

        for rec in journal.rounds:
            keys = self.admin.keys_for_step(rec["round"])
            self.admin.advance(keys, np.asarray(rec["active"], bool))
        nxt = journal.rounds[-1]["round"] + 1 if journal.rounds else 0
        for silo, rnd in journal.downed.items():
            if self.membership.drop(int(silo), step=nxt):
                self._downed[int(silo)] = int(rnd)
        if journal.params_blob is None:
            return None
        return _on_device(wire.decode_tree(journal.params_blob), self.device)

    @property
    def _next_round(self) -> int:
        return self.accountant.steps

    # ------------------------------------------------------------- wire plane
    def _admin_plane(self, step_idx: int) -> dict:
        """Round t's admin fan-out: step keys, budget verdicts, budget-driven
        exclusions, the participation set and the correction state."""
        keys = self.admin.keys_for_step(step_idx)
        verdicts = self.admin.verdicts()
        for silo in self.accountant.take_exclusions():
            self.membership.exclude(silo, step=step_idx, reason="budget")
        active = self.membership.active_at(step_idx) & verdicts
        return {"step": step_idx, "keys": keys, "verdicts": verdicts,
                "active": active, "noise_state": self.admin.state_for_step()}

    def _params_broadcast(self, params):
        """This round's params, encoded once. Packed: the XOR delta against
        the previous broadcast (a full message first or on a layout change),
        one broadcast for every handler; pickle: a full blob per handler.
        Returns (blob, is_broadcast)."""
        from repro_torch.core import flatbuf
        from repro_torch.core.tee import wire

        if self.codec != "packed" or not wire.packable(params):
            return wire.encode_tree(params, codec="pickle"), False
        layout = flatbuf.layout_of(params)
        new_buf = wire.pack_np(layout, params)
        self._bcast_epoch += 1
        if self._bcast_buf is None or self._bcast_layout != layout:
            blob = wire.encode_full(layout, new_buf, epoch=self._bcast_epoch)
        else:
            blob = wire.encode_delta(layout, self._bcast_buf, new_buf,
                                     epoch=self._bcast_epoch)
        self._bcast_buf, self._bcast_layout = new_buf, layout
        return blob, True

    def _resync_blob(self) -> bytes:
        """Full packed params at the current epoch, for a handler whose
        delta chain broke."""
        from repro_torch.core.tee import wire
        return wire.encode_full(self._bcast_layout, self._bcast_buf,
                                epoch=self._bcast_epoch)

    def _compute_one(self, h, blob: bytes, plan: dict, grad_fn: Callable,
                     admin_row=None) -> bytes:
        """One handler's round trip, with the full-resync retry on
        ``StaleParamsError``, timed into the straggler telemetry."""
        from repro_torch.core.tee import wire

        def call(b):
            return h.compute_update(b, grad_fn, self.privacy, plan["keys"],
                                    self.n_silos, clip_bound=self.clip_bound,
                                    active=plan["active"],
                                    noise_state=plan["noise_state"],
                                    verdicts=plan["verdicts"],
                                    admin_row=admin_row)

        t0 = time.perf_counter()
        try:
            u = call(blob)
        except wire.StaleParamsError:
            with self._stats_lock:
                full = self._resync_blob()
                self.wire_stats["resync_bytes"] += len(full)
            u = call(full)
        with self._stats_lock:
            self.telemetry.observe(h.silo_idx, time.perf_counter() - t0)
            self.wire_stats["update_bytes"] += len(u)
        return u

    def _admin_row(self, params, plan: dict):
        """Admin masks: the round's ``(closing, row)``, drawn once by the
        admin over the round's participation set (None otherwise, or when
        nobody contributes)."""
        active = plan["active"]
        if not (self.privacy.enabled and self.privacy.mask_mode == "admin"
                and bool(np.any(active))):
            return None
        return self.admin.closing_mask_row(
            self.privacy, params, plan["keys"], active, plan["noise_state"],
            self.clip_bound)

    def _collect_updates(self, params, plan: dict, grad_fn: Callable,
                         sink: Optional[Callable] = None) -> dict:
        """Distribute the params and collect the active handlers' sealed
        updates in silo order; ``sink(name, blob)`` streams each one out as
        it is produced (the pipelined runner's ingestion thread)."""
        blob, is_bcast = self._params_broadcast(params)
        active = plan["active"]
        self.wire_stats["broadcast_bytes"] += len(blob) if is_bcast \
            else len(blob) * int(np.sum(active))
        admin_row = self._admin_row(params, plan)
        updates = {}
        for h in self.handlers:
            if not active[h.silo_idx]:
                continue
            u = self._compute_one(h, blob, plan, grad_fn, admin_row)
            if sink is not None:
                sink(h.name, u)
            updates[h.name] = u
        if not updates:
            raise RuntimeError(
                "no silo may contribute this round (budgets exhausted or "
                "membership empty); DP forbids further training")
        return updates

    def _batch_tag(self, round_id: int, updates: dict) -> Optional[dict]:
        """The round's Merkle batch tag over the sealed updates' leaves (None
        with batch-MAC off: per-message HMAC)."""
        if not self.batch_mac:
            return None
        by_name = {h.name: h for h in self.handlers}
        return self.admin.batch_tag(
            [(name, by_name[name].last_leaf) for name in updates], round_id)

    def step(self, step_idx: int, params, grad_fn: Callable,
             update_fn: Callable, lr: float):
        """One round: the admin plane, the active silos' contributions, the
        updater's aggregate over the actual contributors, the admin's
        advance (the ledger records the round). Returns (params, loss)."""
        plan = self._admin_plane(step_idx)
        updates = self._collect_updates(params, plan, grad_fn)
        params, loss = self.updater.aggregate(
            updates, params, update_fn, lr=lr,
            batch=self._batch_tag(step_idx, updates))
        self.admin.advance(plan["keys"], plan["active"])
        self.wire_stats["rounds"] += 1
        return params, loss

    def run(self, params, grad_fn: Callable, update_fn: Callable, lr: float,
            n_rounds: int, pipelined: bool = True, speculative: bool = False,
            round_timeout_s: Optional[float] = None,
            quorum: Optional[int] = None, chaos: Any = None,
            journal: Any = None, rejoin_after: Optional[int] = 2):
        """``n_rounds`` rounds from the next one. Returns (params,
        [per-round mean losses]).

        ``pipelined=True`` streams each sealed update into the updater's
        ingestion thread as it is produced (one worker: the silo order of
        the sum is kept), and overlaps the admin plane (round t's ledger
        write, round t+1's keys, verdicts and state) with the updater's
        close of round t. The model owner's ``update_fn`` runs on the
        calling thread. Bit-identical to a loop of :meth:`step`.

        ``speculative=True`` (implies pipelined) also lets each handler
        reuse round t's xi stream as round t+1's xi_{t-1} (the admin's
        ``advance`` carries exactly that key forward) and draws round t+1's
        xi on the card while round t closes on the updater's thread. Every
        cached stream is tagged with its raw key and used only on an exact
        match; a miss draws it anew, so rekeys, resyncs and membership
        changes fall back to a fresh draw. Bit-identical to :meth:`step`.

        Fault-tolerant rounds (any of ``round_timeout_s``, ``quorum``,
        ``chaos``, ``journal``; ``docs/failure_model.md``): the active
        handlers run at once on worker threads, each on its own CUDA
        stream; a round closes once a quorum of updates has landed and the
        deadline has passed. Non-responders are dropped through the elastic
        membership and the round is replayed over the realized set, so it
        is bit-identical to a scheduled elastic round with that set.
        Transient faults (a dropped blob, a KDS denial, stale params) are
        retried with deterministic-jitter backoff; integrity failures (a bad
        MAC or Merkle leaf) never are: the silo is attributed and dropped.
        ``chaos``: a ``faults.FaultInjector``; ``journal``: a
        ``faults.RoundJournal`` (each committed round is journaled; an
        updater crash between ingest and close discards the partial round
        and replays it; :meth:`resume` continues from it after a driver
        restart). ``rejoin_after``: rounds a dropped silo sits out before
        :meth:`rejoin_silo_async` re-admits it (None: never)."""
        if round_timeout_s is not None or chaos is not None \
                or journal is not None or quorum is not None:
            if chaos is not None:
                self.chaos = chaos
            return self._run_tolerant(params, grad_fn, update_fn, lr,
                                      n_rounds, round_timeout_s, quorum,
                                      journal, rejoin_after)
        flags = [h.speculative for h in self.handlers]
        for h in self.handlers:
            h.speculative = speculative or h.speculative
        try:
            return self._run(params, grad_fn, update_fn, lr, n_rounds,
                             pipelined or speculative, speculative)
        finally:
            for h, f in zip(self.handlers, flags):
                h.speculative = f

    def _run(self, params, grad_fn: Callable, update_fn: Callable, lr: float,
             n_rounds: int, pipelined: bool, speculative: bool):
        losses = []
        start = self._next_round
        if not pipelined:
            for t in range(start, start + n_rounds):
                params, loss = self.step(t, params, grad_fn, update_fn, lr)
                losses.append(loss)
            return params, losses
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="updater") as ex:
            plan = self._admin_plane(start)
            for t in range(start, start + n_rounds):
                # batch-MAC: updates stream in before the admin has every
                # leaf, so the tag is issued after the last ingest and
                # checked when the round closes
                expected = [h.name for h in self.handlers
                            if plan["active"][h.silo_idx]]
                rs = self.updater.begin_round(params, expected=expected,
                                              batch_mode=self.batch_mac)
                ingests = []

                def sink(name, blob):
                    # fail fast on an ingest that already died
                    for ing in ingests:
                        if ing.done() and ing.exception() is not None:
                            raise RuntimeError(
                                f"updater ingestion thread failed mid-round "
                                f"(before {name}'s update was submitted)"
                            ) from ing.exception()
                    ingests.append(
                        ex.submit(self.updater.ingest, rs, name, blob))

                updates = self._collect_updates(params, plan, grad_fn,
                                                sink=sink)
                for ing in ingests:
                    ing.result()  # decode/auth errors before the advance
                fut = ex.submit(self.updater.close_round, rs,
                                self._batch_tag(t, updates))
                # overlapped with the close: the masked updates left the
                # handlers, so the privacy loss is incurred
                self.admin.advance(plan["keys"], plan["active"])
                self.wire_stats["rounds"] += 1
                next_plan = self._admin_plane(t + 1) \
                    if t + 1 < start + n_rounds else None
                if speculative and next_plan is not None:
                    # round t+1's xi drawn while round t closes; a wrong
                    # guess is a harmless miss
                    for h in self.handlers:
                        if next_plan["active"][h.silo_idx]:
                            h.prefetch_round(next_plan["keys"])
                mean_update, loss = fut.result()
                params = update_fn(params, mean_update, lr)
                losses.append(loss)
                plan = next_plan
        return params, losses

    # ------------------------------------------------ fault-tolerant rounds
    def _run_tolerant(self, params, grad_fn: Callable, update_fn: Callable,
                      lr: float, n_rounds: int,
                      round_timeout_s: Optional[float],
                      quorum: Optional[int], journal, rejoin_after):
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.core.tee import wire
        from repro_torch.core.tee.faults import RoundJournal

        journal = journal if journal is not None else RoundJournal()
        if self.chaos is not None:
            self.service.kds.fault_hook = self.chaos.kds_fault
        losses = []
        start = self._next_round
        old_min = self.membership.min_active
        if quorum is not None:
            # the membership floor and the closure quorum are one number
            self.membership.min_active = max(quorum, 1)
        ex = ThreadPoolExecutor(max_workers=max(self.n_silos, 1),
                                thread_name_prefix="collect")
        try:
            for t in range(start, start + n_rounds):
                self._rejoin_downed(t, rejoin_after)
                params, loss, active = self._step_tolerant(
                    t, params, grad_fn, update_fn, lr, round_timeout_s,
                    quorum, ex)
                losses.append(loss)
                journal.commit(t, active, wire.encode_tree(params),
                               downed=self._downed)
        finally:
            self.membership.min_active = old_min
            if self.chaos is not None:
                self.service.kds.fault_hook = None
            # waits for hung workers (bounded by the injected hangs); their
            # late results are discarded
            ex.shutdown(wait=True)
            self._inflight.clear()
        return params, losses

    def _rejoin_downed(self, t: int, rejoin_after: Optional[int]) -> None:
        """Re-admit the silos that deadline or quorum closure dropped, once
        they have sat out ``rejoin_after`` rounds, through
        :meth:`rejoin_silo_async`. A silo whose hung worker still runs is
        left until it resolves (its handler must not be touched
        concurrently)."""
        if rejoin_after is None:
            return
        for silo in sorted(self._downed):
            if t - self._downed[silo] < rejoin_after:
                continue
            fut = self._inflight.get(silo)
            if fut is not None and not fut.done():
                continue
            self._inflight.pop(silo, None)
            if self.chaos is not None:
                self.chaos.arm_kds(t)
            if self.rejoin_silo_async(silo):
                del self._downed[silo]

    def _step_tolerant(self, t: int, params, grad_fn: Callable,
                       update_fn: Callable, lr: float,
                       round_timeout_s: Optional[float],
                       quorum: Optional[int], ex):
        """One deadline/quorum round, replayed until it commits. Each
        attempt resolves the plan over the current membership and collects
        under the deadline; it commits when every expected silo responded
        and every update authenticated, else it shrinks the membership
        (non-responders dropped and penalized, integrity offenders
        attributed and dropped, never retried) and replays. Injected faults
        are one-shot, so replays converge; the attempt bound only guards a
        wedged deployment. Returns (params, loss, the realized set)."""
        from repro_torch.core.tee import wire
        from repro_torch.core.tee.faults import UpdaterCrashError

        for _attempt in range(2 * self.n_silos + 4):
            plan = self._admin_plane(t)
            active = plan["active"]
            n_active = int(np.sum(active))
            if n_active == 0:
                raise RuntimeError(
                    "no silo may contribute this round (budgets exhausted "
                    "or membership empty); DP forbids further training")
            q = n_active if quorum is None else min(quorum, n_active)
            responders, nonresponders = self._collect_tolerant(
                params, plan, grad_fn, round_timeout_s, q, t, ex)
            if nonresponders:
                with self._stats_lock:
                    self.fault_stats["quorum_closures"] += 1
                    self.fault_stats["rounds_replayed"] += 1
                for silo in nonresponders:
                    if self.membership.drop(silo, step=t):
                        self._downed[silo] = t
                    if round_timeout_s:
                        self.telemetry.penalize(silo, round_timeout_s)
                continue  # replay over the realized set
            # the tag over the leaves each worker digested when it sealed
            # (not last_leaf, which a late hung worker could overwrite), so
            # corruption in transit is a leaf mismatch at ingest, attributed
            names = [h.name for h in self.handlers if active[h.silo_idx]]
            batch = self.admin.batch_tag(
                [(n, responders[n][1]) for n in names], t) \
                if self.batch_mac else None
            rs = self.updater.begin_round(params, expected=names,
                                          batch=batch)
            bad = []
            for name in names:
                try:
                    self.updater.ingest(rs, name, responders[name][0])
                except (wire.WireFormatError, ValueError) as e:
                    bad.append((name, e))
            if bad:
                # integrity: fail closed, never retry these updates
                with self._stats_lock:
                    for name, e in bad:
                        self.fault_stats["integrity_failures"].append(
                            {"round": t, "silo": name, "error": str(e)})
                    self.fault_stats["rounds_replayed"] += 1
                by_name = {h.name: h.silo_idx for h in self.handlers}
                for name, _ in bad:
                    if self.membership.drop(by_name[name], step=t):
                        self._downed[by_name[name]] = t
                continue
            if self.chaos is not None:
                self.updater.fault_hook = \
                    lambda _t=t: self.chaos.updater_fault(_t)
            try:
                new_params, loss = self.updater.finish_round(
                    rs, update_fn, lr, batch)
            except UpdaterCrashError:
                # a crash between ingest and close: nothing committed or
                # journaled; the round replays bit-exactly (round-keyed
                # streams)
                with self._stats_lock:
                    self.fault_stats["updater_recoveries"] += 1
                    self.fault_stats["rounds_replayed"] += 1
                continue
            finally:
                self.updater.fault_hook = None
            self.admin.advance(plan["keys"], plan["active"])
            with self._stats_lock:
                self.wire_stats["rounds"] += 1
            return new_params, loss, np.asarray(plan["active"], bool)
        raise RuntimeError(
            f"round {t} failed to close after {2 * self.n_silos + 4} "
            f"attempts (persistent faults beyond the chaos model)")

    def _collect_tolerant(self, params, plan: dict, grad_fn: Callable,
                          round_timeout_s: Optional[float], q: int, t: int,
                          ex):
        """Every expected handler at once on a worker thread; after
        ``round_timeout_s`` the round closes if at least ``q`` responders
        have landed, else it waits on until they have or every worker has
        resolved (below the quorum would break the DP participation floor).
        Returns ``(responders, nonresponders)``: handler name -> (delivered
        sealed blob, its leaf digest when sealed), and the silos that
        crashed or still hang (their workers run on, their results
        discarded)."""
        import hashlib
        from concurrent.futures import wait

        from repro_torch.core.tee.faults import Backoff, SiloCrashError

        blob, is_bcast = self._params_broadcast(params)
        active = plan["active"]
        with self._stats_lock:
            self.wire_stats["broadcast_bytes"] += len(blob) if is_bcast \
                else len(blob) * int(np.sum(active))
        admin_row = self._admin_row(params, plan)
        handlers = [h for h in self.handlers if active[h.silo_idx]]
        chaos = self.chaos

        def worker(h):
            if chaos is not None:
                h.fault_hook = lambda silo, _t=t: chaos.handler_fault(_t,
                                                                      silo)
            try:
                u = self._compute_one(h, blob, plan, grad_fn, admin_row)
            finally:
                h.fault_hook = None
            leaf = hashlib.sha256(u).digest()
            delivered = u
            if chaos is not None:
                delivered = chaos.transit_fault(t, h.silo_idx, u)
                if delivered is None:
                    # a transient drop: the sender re-delivers the same
                    # sealed blob after backoff (a first delivery, not a
                    # replay, to the channel's counter)
                    with self._stats_lock:
                        self.fault_stats["transient_retries"] += 1
                    Backoff(seed=t * 1009 + h.silo_idx).sleep()
                    delivered = u
            return h.name, delivered, leaf

        futs = {ex.submit(worker, h): h for h in handlers}
        done, pending = wait(set(futs), timeout=round_timeout_s)
        if pending:
            with self._stats_lock:
                self.fault_stats["deadline_hits"] += 1
        while pending and \
                sum(1 for f in done if f.exception() is None) < q:
            d2, pending = wait(pending, timeout=0.02)
            done |= d2
        responders, nonresponders = {}, []
        for f in done:
            exc = f.exception()
            if exc is None:
                name, delivered, leaf = f.result()
                responders[name] = (delivered, leaf)
            elif isinstance(exc, SiloCrashError):
                nonresponders.append(futs[f].silo_idx)
            else:
                raise exc
        for f in pending:  # hung past the deadline with the quorum met
            silo = futs[f].silo_idx
            nonresponders.append(silo)
            self._inflight[silo] = f
        return responders, nonresponders

    def epsilon(self, silo: Optional[int] = None) -> float:
        """Spent epsilon: global, or one silo's over its own history."""
        return self.accountant.epsilon(silo)

    def privacy_report(self) -> dict:
        """The admin-plane spend report (per-silo spend, budgets, verdicts
        and round-trip EMAs), HMAC-signed with a key derived from the
        admin's attestation identity (verify with
        ``analysis.report.verify_spend_report``)."""
        return self.admin.sign_spend_report(
            round_trip_s=self.telemetry.snapshot())

    @property
    def expected_measurement(self) -> str:
        return self.service.expected_measurement()


# Session.from_config's keywords, split off by the one-call helpers
_CTOR_KEYS = ("full", "privacy", "optimizer", "mesh", "shape",
              "compute_dtype", "seed", "device")


def _split_ctor(kw: dict) -> dict:
    return {k: kw.pop(k) for k in _CTOR_KEYS if k in kw}


def train(arch: str, **kw) -> TrainResult:
    """One-call convenience: ``repro_torch.api.train("qwen2.5-3b",
    steps=10)``.

    :meth:`Session.from_config`'s keywords (full, privacy, optimizer,
    mesh, shape, compute_dtype, seed, device) are split off; the rest go
    to :meth:`Session.train`. ``shape`` is stored in the session's
    ``run_cfg``, as JAX's is, and read by neither package's train: batch
    size and sequence length are ``train``'s ``batch_size`` and
    ``seq_len``."""
    ctor = _split_ctor(kw)
    return Session.from_config(arch, **ctor).train(**kw)


def serve(arch: str, **kw) -> ServeResult:
    """One-call convenience: ``repro_torch.api.serve("qwen2.5-3b",
    max_new_tokens=8)``; bf16 serving with ``compute_dtype=torch.bfloat16``.
    The keywords split as in :func:`train` (``shape`` stored likewise: the
    prompt's shape is ``serve``'s ``batch_size`` and ``prompt_len``)."""
    ctor = _split_ctor(kw)
    return Session.from_config(arch, **ctor).serve(**kw)
