"""The privacy barrier (paper section 4): keys, the per-silo gradient at
each clipping granularity, the dynamic bound, and the tree-level
corrected-noise kernel. Port of ``repro/core/barrier.py``.

* ``BarrierKeys`` / ``step_keys``: the admin's 32 bytes of keys per step,
  ``split(fold_in(root, step), 3)``, bit-equal to JAX (``core/prng.py``).
* ``silo_grad``: one silo's gradient under ``priv.clip_mode``
  (``per_example``, ``per_microbatch`` or ``per_silo``), as JAX's; no step
  function calls it there either.
* ``dynamic_bound_from_percentiles``: the percentile bound selection.
* ``fused_noise`` (tree-level kernel ``dp_noise_tree``): corrected noise on
  an aggregate, ``packed`` through ``fused_noise_packed`` (one
  ``clip_mask`` launch with ``n_silos = 1`` and no pairwise terms) or
  ``perleaf`` through ``noise_correction.corrected_noise``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import clipping, flatbuf, noise_correction, prng
from repro_torch.core.noise_correction import NoiseState
from repro_torch.kernels.dispatch import on_cuda, resolve_tree
from repro_torch.kernels.dp_fused import ops as fused_ops
from repro_torch.models import packing


class BarrierKeys(NamedTuple):
    """Per-step keys owned by the admin, each a raw ``(k0, k1)`` pair."""

    key_r: tuple     # pairwise zero-sum streams
    key_xi: tuple    # DP noise streams (step t)
    key_clip: tuple  # dynamic-clipping DP noise


def step_keys(root_key: tuple, step: int) -> BarrierKeys:
    kr, kx, kc = prng.split(prng.fold_in(root_key, int(step)), 3)
    return BarrierKeys(kr, kx, kc)


def silo_grad(loss_fn, params, batch_local: dict, priv: PrivacyConfig,
              clip_bound) -> tuple:
    """``(clipped gradient sum or the silo's gradient (a flat tree), norms,
    loss)`` at ``priv.clip_mode``; without privacy the plain gradient and
    its norm."""
    if priv.enabled and priv.clip_mode == "per_example":
        return clipping.per_example_clipped_grad(loss_fn, params, batch_local,
                                                 clip_bound)
    if priv.enabled and priv.clip_mode == "per_microbatch":
        return clipping.per_microbatch_clipped_grad(
            loss_fn, params, batch_local, clip_bound, n_micro=4)
    tree = packing.param_tree(params)
    layout = flatbuf.layout_of(tree)
    tensors = flatbuf.flat_tensors(layout, tree)
    with clipping.trainable(tensors):
        loss = loss_fn(params, batch_local)
        grads = torch.autograd.grad(loss, tensors,
                                    materialize_grads=True)
    with torch.no_grad():
        g = flatbuf.unpack(layout, flatbuf.pack_tensors(layout, grads))
        if not priv.enabled:
            return g, clipping.global_norm(g)[None], loss.detach()
        # per_silo: one clipped contribution per silo
        g, norm = clipping.clip_tree(g, clip_bound)
    return g, norm[None], loss.detach()


def dynamic_bound_from_percentiles(percentiles_all, priv: PrivacyConfig, key):
    """percentiles_all: (n_silos, n_pct). The noisy r-th percentile bound,
    capped at ``clip_percentile_max``."""
    return clipping.select_clip_bound(
        percentiles_all, priv.clip_percentile, key,
        dp_noise_scale=0.05 * priv.clip_bound,
        upper_bound=priv.clip_percentile_max)


# ---------------------------------------------------------------------------
# post-aggregate corrected noise (the dp_noise_tree kernel)

NOISE = "dp_noise_tree"


def fused_noise_packed(g_packed, priv: PrivacyConfig, keys: BarrierKeys,
                       noise_state: NoiseState, clip_bound) -> tuple:
    """Corrected DP noise added to a packed (P,) buffer in one ``clip_mask``
    dispatch: the ``key_xi`` stream of silo 0 of 1 at scale sigma * C, no
    pairwise terms. Returns ``(noisy (P,), new state)``."""
    dev = g_packed.device
    sigma_c = priv.sigma * torch.as_tensor(clip_bound, dtype=torch.float32,
                                           device=dev)
    lam_gate = torch.tensor(priv.noise_lambda if noise_state.has_prev
                            else 0.0, dtype=torch.float32, device=dev)
    kx = tuple(keys.key_xi)
    noisy = fused_ops.clip_mask(
        g_packed, 1.0, kx, kx, noise_state.prev_key, 0, 1, sigma_c, 0.0,
        lam_gate, use_pairwise=False, use_prev=priv.noise_lambda > 0.0)
    return noisy, NoiseState(prev_key=kx, has_prev=True)


def _noise_perleaf(g_sum: dict, priv: PrivacyConfig, keys: BarrierKeys,
                   noise_state: NoiseState, clip_bound) -> tuple:
    first = flatbuf.flat_tensors(flatbuf.layout_of(g_sum), g_sum)[0]
    sigma_c = priv.sigma * torch.as_tensor(clip_bound, dtype=torch.float32,
                                           device=first.device)

    def f32(g):
        return g.to(torch.float32, copy=True)

    noisy = {k: [f32(g) for g in v] if isinstance(v, list) else f32(v)
             for k, v in g_sum.items()}
    noisy, new_state = noise_correction.corrected_noise(
        noisy, keys.key_xi, noise_state, sigma_c, priv.noise_lambda)

    def back(n, g):
        return n.to(g.dtype)

    noisy = {k: [back(n, g) for n, g in zip(v, g_sum[k])]
             if isinstance(v, list) else back(v, g_sum[k])
             for k, v in noisy.items()}
    return noisy, new_state


def fused_noise(g_sum: dict, priv: PrivacyConfig, keys: BarrierKeys,
                noise_state: NoiseState, clip_bound, impl: str = "auto"):
    """``g_sum`` (an aggregated clipped-gradient tree) plus corrected DP
    noise ``xi_t - lam * xi_{t-1}`` at scale sigma * C. Returns
    ``(noisy tree, new state)``."""
    layout = flatbuf.layout_of(g_sum)
    first = flatbuf.flat_tensors(layout, g_sum)[0]
    if resolve_tree(NOISE, impl, on_cuda(first)) == "perleaf":
        return _noise_perleaf(g_sum, priv, keys, noise_state, clip_bound)
    noisy, new_state = fused_noise_packed(flatbuf.pack(layout, g_sum), priv,
                                          keys, noise_state, clip_bound)
    return flatbuf.unpack(layout, noisy), new_state
