"""The CITADEL++ train step on the fused and barrier DP tiers. Port of
``repro/distributed/steps.py``.

``sync_path='fused'`` with ``silo_mode='vmap'``: every silo's gradient of
the model (the dense, ssm or hybrid family) is computed, packed into its
row of one stacked ``(n_silos, P)`` fp32 buffer (``core/flatbuf.py``), and
``DPPipeline.run_central`` turns the stack into
``sum_i clip(g_i) + sigma*C*(xi_t - lambda*xi_{t-1})`` through the
``clip_accumulate`` and ``noise_batch`` kernels.

``sync_path='barrier'``: the paper's protocol. Each silo emits
``DPPipeline.silo_contribution`` (clip, zero-sum mask over the active ring,
its noise share and its correction share, one ``clip_mask`` kernel) and the
sum of the contributions in silo order is the aggregate the model updater
sees. The JAX package runs one silo per ``(pod, data)`` slot of a device
mesh under ``shard_map``; the port runs the mesh's silos one after another
on one card, so its mesh is virtual: ``MeshConfig((n,), ("data",))`` gives
the result of the JAX package on an n-device mesh.

Either way the aggregate is divided by the silos that contributed and the
optimizer updates the packed master buffer, of which the model's fp32
parameters are views. JAX vmaps (or shard_maps) the silos; the port loops
over them, computing one silo's gradient with autograd, packing it into row
i and freeing the gradient tree before silo i+1, so only one gradient tree
lives at a time.

Training in bf16 takes JAX's two routes. (A) bf16 compute over fp32
weights: ``build_model(cfg, dev, compute_dtype=torch.bfloat16)``, the
weights cast in the forward pass, their gradients fp32. (B) bf16 weights
over an fp32 master: ``build_model(cfg, dev, param_dtype=torch.bfloat16,
compute_dtype=torch.bfloat16)``; the weights are views of one packed bf16
buffer (``TrainState.weights``), the optimizer's master is its widened
copy, and every update rewrites the bf16 buffer from the master, rounding
to nearest even (JAX's ``mst.astype(p.dtype)``). Either way each silo's
gradient is computed in bf16 and widened into its fp32 row (the scan
tier's accumulator is fp32, as JAX's ``gg.astype(jnp.float32)``), and the
DP stages and their kernels run in fp32 as they do in fp32 training. Every
family of JAX's ``build_model`` trains so, its tree fp32, bf16 or mixed
(route B keeps JAX's fp32 leaves fp32: the MoE router, rwkv6's decay and
bonus, mamba2's ``A_log``, ``D`` and ``dt_bias``; they view the master).
The paper's small models take no compute type in JAX and train in fp32
only (:func:`check_small_fp32`).

``silo_mode='scan'`` (the JAX package's silo-serial tier for large models):
no stacked buffer; each silo's gradient is clipped with the carried bound
C_t (dynamic clipping is stale by one step, as in JAX), gated and added into
one fp32 ``(P,)`` accumulator, and freed before the next silo runs; the
engine's ``corrected_noise_tree`` then adds the noise into the accumulator
in place (the per-leaf policy by default, drawn window by window). Five
P-sized fp32 buffers live at once (master, two moments, the accumulator,
one silo's gradient) against the vmap tier's seven.

Under the perleaf execution policy (``force_impl("perleaf",
kernel="dp_noise_tree")`` or ``REPRO_KERNEL_IMPL=dp_noise_tree=perleaf``)
the fused tier adds the per-leaf ``jax.random`` noise to the aggregate, and
the barrier tier masks each contribution leaf by leaf (``zsmask``) over the
full ring of the mesh, as JAX's steps do.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import MeshConfig, PrivacyConfig, RunConfig
from repro_torch.core import barrier as barrier_mod
from repro_torch.core import flatbuf, prng
from repro_torch.core.dp_pipeline import (DPPipeline, reduce_contributions,
                                          resolve_policy)
from repro_torch.core.flatbuf import PackedLayout
from repro_torch.core.noise_correction import NoiseState
from repro_torch.core.noise_correction import init_state as init_noise_state
from repro_torch.models import packing
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import constant


class TrainState(NamedTuple):
    params: Any            # the model's weights: views of opt_state["master"]
    #                        (fp32) or of ``weights`` (bf16)
    opt_state: dict
    noise_state: NoiseState
    step: int
    clip_bound: torch.Tensor  # current C_t, fp32 0-dim on the device
    layout: PackedLayout   # the packed layout of params, grads and moments
    # the packed bf16 weights the params view, rounded from the master after
    # every update; None when the params view the fp32 master
    weights: Optional[torch.Tensor] = None


class StageTimer:
    """Per-stage times of one step: CUDA events on the card (read after the
    step's final sync, so timing adds no sync of its own), host clock on
    the CPU. Stages that repeat (one per silo) accumulate."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._spans: list = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            yield
            t1.record()
            self._spans.append((name, t0, t1))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((name, t0, time.perf_counter()))

    def ms(self) -> dict:
        """Stage name -> milliseconds (synchronizes on the card)."""
        out: dict = {}
        if self.cuda and self._spans:
            self._spans[-1][2].synchronize()
        for name, t0, t1 in self._spans:
            dt = t0.elapsed_time(t1) if self.cuda else (t1 - t0) * 1e3
            out[name] = out.get(name, 0.0) + dt
        return out


def effective_n_silos(run_cfg: RunConfig) -> int:
    """The silo count a step aggregates over: an explicit ``priv.n_silos``
    wins; the scan tier defaults to the paper's 4 data owners; the mesh's
    silo extent is the fallback (one slot on one card)."""
    priv = run_cfg.privacy
    if priv.sync_path == "barrier" and priv.enabled:
        return run_cfg.mesh.n_silos
    if priv.n_silos:
        return priv.n_silos
    if priv.silo_mode == "scan":
        return 4
    return run_cfg.mesh.n_silos


def check_small_fp32(model, params) -> None:
    """Raise for a small model (MLP3, CNN6, WRN28; no ``cfg``) with bf16
    weights or bf16 compute: the JAX package's small models take no
    compute type (``repro/models/small.py``; its ``build_model`` builds
    only the transformer, ssm and hybrid families), so they train in fp32
    only, in both packages."""
    if getattr(model, "cfg", None) is not None:
        return
    weights = params.values() if isinstance(params, dict) \
        else params.parameters()
    if any(p.dtype == torch.bfloat16 for p in weights) or \
            getattr(model, "compute_dtype", torch.float32) == torch.bfloat16:
        raise NotImplementedError(
            "the paper's small models train in fp32 only: the JAX "
            "package's small models take no compute type")


def init_train_state(model: Model, run_cfg: RunConfig, key: tuple,
                     params=None, gen: Optional[torch.Generator] = None
                     ) -> TrainState:
    """``params`` (e.g. from ``models.convert.params_from_jax``) or random
    weights from ``gen``; either way they are moved into packed buffers
    (``packing.pack_train_params``). fp32 weights view the optimizer's
    fp32 master; bf16 weights view a packed bf16 buffer
    (``TrainState.weights``), of which the master holds the widened copy,
    as JAX's optimizer state. The noise state starts from ``fold_in(key,
    0xD0)``, as in JAX."""
    if params is None:
        params = model.init(gen)
    check_small_fp32(model, params)
    layout, master, weights = packing.pack_train_params(params)
    opt = make_optimizer(run_cfg.optimizer)
    return TrainState(
        params=params,
        opt_state=opt.init(master),
        noise_state=init_noise_state(prng.fold_in(key, 0xD0),
                                     n_silos=effective_n_silos(run_cfg)),
        step=0,
        clip_bound=torch.tensor(run_cfg.privacy.clip_bound,
                                dtype=torch.float32, device=master.device),
        layout=layout, weights=weights)


def _reshape_to_silos(batch: dict, n_silos: int) -> dict:
    """Silo i takes rows ``[i * B / n, (i + 1) * B / n)``. M-RoPE position
    ids (3, B, S) split on their batch axis, B, into (n, 3, B / n, S)."""
    out = {}
    for k, v in batch.items():
        mrope = k == "positions" and v.dim() == 3
        rows = v.shape[1] if mrope else v.shape[0]
        if rows % n_silos:
            raise ValueError(f"batch {k} of {rows} rows does not split "
                             f"over {n_silos} silos")
        if mrope:
            out[k] = v.reshape((3, n_silos, rows // n_silos)
                               + tuple(v.shape[2:])).transpose(0, 1)
        else:
            out[k] = v.reshape((n_silos, rows // n_silos) + tuple(v.shape[1:]))
    return out


@functools.lru_cache(maxsize=64)
def _gates(active: tuple, device: torch.device) -> torch.Tensor:
    """The fp32 0/1 gates of a participation set on ``device``, copied
    there once per set and device: a copy every step would wait for the
    stream."""
    return torch.tensor(active, dtype=torch.float32, device=device)


def _mean_loss(losses: list, pipe: DPPipeline, active) -> torch.Tensor:
    """``sum_i loss_i * gate_i / active_count`` in silo order (JAX's psum
    of the gated losses): dropped silos weigh nothing."""
    dev = losses[0].device
    gates = _gates(tuple(bool(a) for a in pipe._active_or_full(active)), dev)
    return torch.sum(torch.stack(losses) * gates) / torch.full(
        (), float(pipe.active_count(active)), dtype=torch.float32,
        device=dev)


def _fused_grads(model: Model, priv: PrivacyConfig, params, batch, n_silos,
                 keys, noise_state, clip_bound, clip_key, layout,
                 timer: StageTimer, active=None):
    """Per-silo grads packed as one stacked (n_silos, P) buffer, then the
    engine's ``run_central``, each stage timed by ``timer``. Returns
    ``(noisy (P,), loss, norms, new noise state, bound)``."""
    silo_batches = _reshape_to_silos(batch, n_silos)
    pipe = DPPipeline(priv, layout, n_silos)
    tensors = flatbuf.flat_tensors(layout, packing.param_tree(params))
    dev = tensors[0].device
    stacked = torch.empty((n_silos, layout.total), dtype=torch.float32,
                          device=dev)
    losses = []
    for i in range(n_silos):
        b = {k: v[i] for k, v in silo_batches.items()}
        with timer.stage("silo_grads"):
            loss = model.loss(params, b)
            # a weight the batch never reaches (the embedding, under
            # frontend embeds) takes a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, tensors,
                                        materialize_grads=True)
        with timer.stage("pack"):
            flatbuf.pack_tensors(layout, grads, out=stacked[i])
        del grads
        losses.append(loss.detach())
    with torch.no_grad():
        with timer.stage("norms"):
            norms = pipe.norms(stacked)
        if priv.enabled and pipe.policy.mode == "perleaf":
            # the per-leaf noise family: aggregate packed, then the noise
            # stage on the aggregate's tree (in place)
            with timer.stage("aggregate"):
                bound = pipe.dynamic_bound(norms, active, clip_key, clip_bound)
                noisy = pipe.masked_aggregate(
                    stacked, pipe.clip_scales(norms, bound, active))
            with timer.stage("noise"):
                pipe.corrected_noise_tree(
                    flatbuf.unpack(layout, noisy, dtype=torch.float32), keys,
                    noise_state, bound, active)
            new_ns = pipe.advance_state(keys, noise_state, active)
        else:
            noisy, new_ns, bound = pipe.run_central(
                stacked, norms, keys, noise_state, clip_bound, clip_key,
                active, timer)
        del stacked
    return noisy, _mean_loss(losses, pipe, active), norms, new_ns, bound


def _fused_grads_scan(model: Model, priv: PrivacyConfig, params, batch,
                      n_silos, keys, noise_state, clip_bound, clip_key,
                      layout, timer: StageTimer, active=None):
    """The silo-serial tier, JAX's ``_fused_grads_scan``: silo after silo,
    its gradient (``value_and_grad``), its norm off the gradient tree
    (``norm_tree``), its clip factor at the carried bound times its gate,
    ``acc + scale * g`` into the fp32 accumulator, the gradient freed;
    then the dynamic bound from every norm (used from the next step on) and
    ``corrected_noise_tree`` on the accumulator at the carried bound
    (per-leaf policy unless ``force_impl`` picks another). Returns
    ``(noisy (P,), loss, norms, new noise state, new bound)``, the
    accumulator being the noisy aggregate."""
    silo_batches = _reshape_to_silos(batch, n_silos)
    pipe = DPPipeline(priv, layout, n_silos, policy="perleaf")
    gates = [float(x) for x in pipe._active_or_full(active)]
    tensors = flatbuf.flat_tensors(layout, packing.param_tree(params))
    dev = tensors[0].device
    acc = torch.zeros(layout.total, dtype=torch.float32, device=dev)
    acc_tensors = flatbuf.flat_tensors(
        layout, flatbuf.unpack(layout, acc, dtype=torch.float32))
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    norms = []
    for i in range(n_silos):
        b = {k: v[i] for k, v in silo_batches.items()}
        with timer.stage("silo_grads"):
            loss = model.loss(params, b)
            grads = torch.autograd.grad(loss, tensors,
                                        materialize_grads=True)
        with torch.no_grad():
            with timer.stage("norms"):
                norm = pipe.norm_tree(grads)
            with timer.stage("accumulate"):
                scale = pipe.clip_scale(norm, clip_bound) if priv.enabled \
                    else torch.ones((), dtype=torch.float32, device=dev)
                scale = scale * gates[i]
                for a, g in zip(acc_tensors, grads):
                    # JAX's a + scale * g.astype(float32): a bf16 gradient
                    # widens first (fp32 is scaled in place)
                    a.add_(g.float().mul_(scale))
            loss_sum = loss_sum + loss.detach() * gates[i]
        del grads, loss
        norms.append(norm)
    with torch.no_grad():
        norms = torch.stack(norms)
        new_bound = pipe.dynamic_bound(norms, active, clip_key, clip_bound)
        if not priv.enabled:
            return acc, loss_sum / pipe.active_count(active), norms, \
                noise_state, new_bound
        with timer.stage("noise"):
            if pipe.policy.mode == "packed" and priv.mask_mode != "admin":
                acc = pipe.corrected_noise_packed(acc, keys, noise_state,
                                                  clip_bound, active)
            else:
                pipe.corrected_noise_tree(
                    flatbuf.unpack(layout, acc, dtype=torch.float32), keys,
                    noise_state, clip_bound, active)
    return acc, loss_sum / pipe.active_count(active), norms, \
        pipe.advance_state(keys, noise_state, active), new_bound


def _barrier_grads(model: Model, priv: PrivacyConfig, mesh_cfg: MeshConfig,
                   params, batch, keys, noise_state, clip_bound, clip_key,
                   layout, timer: StageTimer, active=None):
    """The barrier tier, one silo of the mesh after another: each silo's
    gradient and its norm off the gradient tree (``norm_tree``, as JAX),
    packed into its row; with every norm known (JAX's ``all_gather``) the
    dynamic bound, which every silo computes alike; each silo's
    ``silo_contribution`` written over its own row (a dropped silo's row
    zeroed instead, with no launch: every term of its contribution is gated
    to zero); the rows summed in silo order into row 0. Returns ``(aggregate (P,), loss, norms, new noise
    state, bound)``, the aggregate a view of the stacked buffer."""
    n_silos = mesh_cfg.n_silos
    silo_batches = _reshape_to_silos(batch, n_silos)
    pipe = DPPipeline(priv, layout, n_silos)
    if pipe.policy.mode == "perleaf":
        # the per-leaf mask family only builds the full static ring: the
        # step aggregates every silo whatever set it was given (as JAX's)
        active = pipe.full_active()
    tensors = flatbuf.flat_tensors(layout, packing.param_tree(params))
    dev = tensors[0].device
    stacked = torch.empty((n_silos, layout.total), dtype=torch.float32,
                          device=dev)
    losses, norms = [], []
    for i in range(n_silos):
        b = {k: v[i] for k, v in silo_batches.items()}
        with timer.stage("silo_grads"):
            loss = model.loss(params, b)
            grads = torch.autograd.grad(loss, tensors,
                                        materialize_grads=True)
        with torch.no_grad():
            with timer.stage("norms"):
                norms.append(pipe.norm_tree(grads))
            with timer.stage("pack"):
                flatbuf.pack_tensors(layout, grads, out=stacked[i])
        del grads
        losses.append(loss.detach())
    with torch.no_grad():
        norms = torch.stack(norms)
        with timer.stage("contributions"):
            bound = pipe.dynamic_bound(norms, active, clip_key, clip_bound)
            scales = pipe.clip_scale(norms, bound)
            rows = stacked.unbind(0)
            for i, row in enumerate(rows):
                if active is not None and not active[i]:
                    row.zero_()
                    continue
                pipe.silo_contribution(row, i, scales[i], active, keys,
                                       noise_state, bound, out=row)
        with timer.stage("reduce"):
            # bf16 leaves round as JAX's (DPPipeline.round_aggregate): the
            # +-B*r masks then cancel only up to those roundings
            agg = pipe.round_aggregate(reduce_contributions(rows))
    return agg, _mean_loss(losses, pipe, active), norms, \
        pipe.advance_state(keys, noise_state, active), bound


def build_train_step(model: Model, run_cfg: RunConfig, lr_schedule=None,
                     elastic: bool = False):
    """``train_step(state, batch, root_key, active=None, *, timer)`` ->
    ``(new_state, metrics)``: ``active`` is the (n_silos,) bool
    participation set of this step (None = every silo); dropped silos
    contribute neither gradient, noise share nor divisor weight. ``timer``
    (a :class:`StageTimer`) times the step's stages. The master buffer, and
    with it ``state.params``, is updated in place. ``sync_path='barrier'``
    with privacy on runs :func:`_barrier_grads` over the mesh's silos;
    otherwise ``silo_mode='scan'`` runs :func:`_fused_grads_scan`.
    ``elastic=True`` says the caller will pass partial sets: refused on the
    barrier tier under the perleaf policy, whose mask family only builds
    the full ring (a direct call with a partial set there aggregates every
    silo and still divides by the set's count, as JAX's step does)."""
    priv = run_cfg.privacy
    barrier = priv.enabled and priv.sync_path == "barrier"
    if elastic and barrier and resolve_policy("packed").mode == "perleaf":
        raise ValueError(
            "elastic membership on the barrier tier needs the packed mask "
            "engine (the per-leaf family only builds the full static ring); "
            "lift the dp_noise_tree=perleaf override")
    opt = make_optimizer(run_cfg.optimizer)
    lr_schedule = lr_schedule or constant(run_cfg.optimizer.lr)
    n_silos = effective_n_silos(run_cfg)

    def train_step(state: TrainState, batch: dict, root_key: tuple,
                   active=None, *, timer: StageTimer):
        keys = barrier_mod.step_keys(root_key, state.step)
        # as in JAX, None is every silo: the carried state records the set
        active = np.ones(n_silos, bool) if active is None \
            else np.asarray(active, bool)
        if active.shape != (n_silos,):
            raise ValueError(
                f"participation set has shape {active.shape}, but this step "
                f"aggregates over {n_silos} silos"
                + (" (the barrier tier pins the count to the mesh's silo-axis "
                   "extent, not priv.n_silos)" if barrier else ""))
        if barrier:
            noisy, loss, norms, new_ns, bound = _barrier_grads(
                model, priv, run_cfg.mesh, state.params, batch, keys,
                state.noise_state, state.clip_bound, keys.key_clip,
                state.layout, timer, active=active)
        elif priv.silo_mode == "scan":
            noisy, loss, norms, new_ns, bound = _fused_grads_scan(
                model, priv, state.params, batch, n_silos, keys,
                state.noise_state, state.clip_bound, keys.key_clip,
                state.layout, timer, active=active)
        else:
            noisy, loss, norms, new_ns, bound = _fused_grads(
                model, priv, state.params, batch, n_silos, keys,
                state.noise_state, state.clip_bound, keys.key_clip,
                state.layout, timer, active=active)
        dev = noisy.device
        n_contrib = torch.full((), float(max(int(active.sum()), 1)),
                               dtype=torch.float32, device=dev)
        lr = lr_schedule(state.step)
        with timer.stage("optimizer"), torch.no_grad():
            # the aggregate over its contributors; the padding, which the
            # noise reached, stays zero in the master buffer and moments
            grad = flatbuf.zero_padding(state.layout, noisy.div_(n_contrib))
            opt_state = opt.update(
                state.opt_state, grad, lr, weights=state.weights,
                runs=flatbuf.dtype_runs(state.layout, "bfloat16"))
        del noisy, grad
        gates = _gates(tuple(bool(a) for a in active), dev)
        metrics = {"loss": loss, "grad_norm_mean":
                   torch.sum(norms * gates) / n_contrib,
                   "clip_bound": bound, "lr": lr, "n_contributions": n_contrib}
        return TrainState(state.params, opt_state, new_ns, state.step + 1,
                          bound, state.layout, state.weights), metrics

    return train_step
