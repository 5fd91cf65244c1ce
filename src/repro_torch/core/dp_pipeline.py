"""The DP aggregation engine of the fused and barrier tiers. Port of
``repro/core/dp_pipeline.py``.

The model updater only ever sees

    sum_i clip(g_i) + sigma*C*(xi_t - lambda*xi_{t-1})

Two tiers build it. The fused tier's :meth:`DPPipeline.run_central` takes
the stacked ``(n, P)`` packed per-silo gradients in the JAX package's stage
order,

    norms -> dynamic_bound -> clip_scales -> masked_aggregate -> corrected_noise

``masked_aggregate`` being the ``clip_accumulate`` kernel and
``corrected_noise_packed`` the ``noise_batch`` kernel; it elides the
zero-sum masks (they cancel in the aggregate by construction), so mask
modes ``pairwise`` and ``none`` run the same graph there. The barrier tier
is the paper's protocol: each silo emits :meth:`DPPipeline.silo_contribution`
(its clipped gradient, a zero-sum pairwise mask over the ring of active
silos, its noise share and its lambda-correction share, one ``clip_mask``
kernel), and :func:`reduce_contributions` sums the contributions in silo
order; only that sum is ever seen in the clear.

Every stage takes ``active``, the ``(n_silos,)`` bool participation set (a
host array; None means all silos): dropped silos contribute no gradient,
no mask and no noise share, each active silo's share has std
``sigma_c/sqrt(k)``, and the ``lambda``-correction share of silo i applies
iff it was active at t-1 and is active now.

The execution policy (:func:`resolve_policy`: ``packed`` | ``perleaf``) is
resolved once per pipeline through ``kernels.dispatch.resolve_tree`` on
``dp_noise_tree``, so ``force_impl("perleaf", kernel="dp_noise_tree")`` or
``REPRO_KERNEL_IMPL=dp_noise_tree=perleaf`` select it; one policy governs
both the mask and the noise construction, as in JAX. Under ``perleaf`` the
barrier tier's contribution is a tree masked leaf by leaf by the ``zsmask``
kernel (``core/masking.py``; the full static ring only: a partial set
raises), and the fused tier's noise is ``noise_correction.corrected_noise``
(per-leaf ``jax.random`` normals, plain torch threefry: no TPU kernel
behind it). The wire tier's speculative rounds pass a silo's xi_t and
xi_{t-1} into ``silo_contribution`` as (P,) streams drawn by
:meth:`DPPipeline.noise_stream` (the ``noise_stream`` kernel on the card),
which the external-stream ``clip_mask`` reads from memory.

Mask mode ``admin`` is the paper-faithful construction (``core/masking.py``):
the admin draws every mask row, dropped silos get zero rows, the last active
silo's row closes the sum to ``xi_t - lam * xi_{t-1}`` (the correction
rides in that row: the admin owns every stream, so there are no per-silo
shares). The fused tier's ``run_central`` aggregates with
``clip_accumulate`` and adds the exact xi the mask set telescopes to
(:meth:`DPPipeline.admin_noise_tree`, plain torch threefry, as JAX's is
jnp: no TPU kernel behind it); the barrier and wire tiers' contribution is
``g * scale + row * gate``, each silo drawing its own row (the port's silos
are concrete) or taking the closing row the admin drew once
(:meth:`DPPipeline.admin_closing_row`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import clipping, flatbuf, masking, noise_correction
from repro_torch.core.barrier import BarrierKeys, dynamic_bound_from_percentiles
from repro_torch.core.flatbuf import PackedLayout
from repro_torch.core.noise_correction import NoiseState
from repro_torch.kernels.dispatch import resolve_tree
from repro_torch.kernels.dp_clip import ops as clip_ops
from repro_torch.kernels.dp_fused import ops as fused_ops

NOISE_TREE = "dp_noise_tree"


def is_static_full(active) -> bool:
    """True iff the participation set is all-active (``None`` or all True)."""
    return active is None or bool(np.all(np.asarray(active)))


@dataclass(frozen=True)
class ExecutionPolicy:
    """``packed``: every stage on the flat buffer through the packed
    kernels; ``perleaf``: the per-leaf mask (``zsmask``) and noise
    (``jax.random``) families. The tensor-level kernels follow the tensors'
    device either way."""

    mode: str  # 'packed' | 'perleaf'


def resolve_policy(request: str = "packed") -> ExecutionPolicy:
    """The execution policy, once per pipeline: ``force_impl`` and
    ``REPRO_KERNEL_IMPL`` on ``dp_noise_tree`` override ``request``; the
    legacy names map onto the two modes (pallas -> packed, jnp ->
    perleaf); ``auto`` is packed, the card's choice."""
    return ExecutionPolicy(resolve_tree(NOISE_TREE, request, cuda=True))


class DPPipeline:
    """The DP stage graph of both tiers over a packed layout."""

    def __init__(self, priv: PrivacyConfig, layout: PackedLayout,
                 n_silos: int, policy: str = "packed"):
        if priv.mask_mode not in ("pairwise", "admin", "none"):
            raise ValueError(f"DPPipeline supports mask_mode pairwise|admin|"
                             f"none, got {priv.mask_mode!r}")
        self.priv = priv
        self.layout = layout
        self.n_silos = int(n_silos)
        self.policy = resolve_policy(policy)

    # -- participation set --------------------------------------------------
    def full_active(self) -> np.ndarray:
        return np.ones(self.n_silos, bool)

    def active_count(self, active) -> float:
        """Number of contributing silos (>= 1), the aggregate's divisor."""
        if is_static_full(active):
            return float(self.n_silos)
        return max(float(np.sum(np.asarray(active))), 1.0)

    def next_active(self, silo: int, active) -> int:
        """The next active silo after ``silo`` in the ring, the pairwise
        mask's neighbour: skipping dropped silos keeps the r-terms
        telescoping to zero over any participation set. With no other
        active silo the ring closes on ``silo`` itself (its mask is 0)."""
        act = self._active_or_full(active)
        for off in range(1, self.n_silos + 1):
            cand = (int(silo) + off) % self.n_silos
            if act[cand]:
                return cand
        return (int(silo) + 1) % self.n_silos  # nobody active: JAX's argmax

    def prev_active(self, state: NoiseState) -> np.ndarray:
        pa = state.prev_active
        if pa is None or np.asarray(pa).shape != (self.n_silos,):
            return self.full_active()  # legacy state: all silos contributed
        return np.asarray(pa, bool)

    def advance_state(self, keys: BarrierKeys, state: NoiseState,
                      active) -> NoiseState:
        """The state carried to step t+1: the key that generated xi_t and
        the set it was drawn over (None, read as all silos, when ``active``
        is None or the state is the legacy two-field one)."""
        pa = None if state.prev_active is None or active is None \
            else np.asarray(active, bool)
        return NoiseState(prev_key=tuple(keys.key_xi), has_prev=True,
                          prev_active=pa)

    # -- per-stream noise scales --------------------------------------------
    def _stream_scales(self, bound: torch.Tensor, active, state: NoiseState):
        """(s_t, s_prev, prev_active): per-silo noise stds at steps t and
        t-1, as fp32 0-dim tensors on the bound's device. k active streams at
        sigma_c/sqrt(k) sum to std exactly sigma_c."""
        sc = self.priv.sigma * bound.float()
        f32 = dict(dtype=torch.float32, device=bound.device)
        s = sc / torch.sqrt(torch.tensor(self.active_count(active), **f32))
        pa = self.prev_active(state)
        k_prev = max(float(np.sum(pa)), 1.0)
        return s, sc / torch.sqrt(torch.tensor(k_prev, **f32)), pa

    # -- admin mask construction (the paper-faithful O(n P) baseline) --------
    def _sigma_c(self, bound, device) -> torch.Tensor:
        return self.priv.sigma * torch.as_tensor(bound, dtype=torch.float32,
                                                 device=device)

    def _admin_correction(self, state: NoiseState, sigma_c):
        """The admin-owned ``lam * xi_{t-1}`` (``admin_xi`` of the carried
        key, drawn window by window where it is subtracted), or None when
        the correction is off. ``lam`` is 0 before the first step, as
        JAX's ``lambda * has_prev``."""
        if not self.priv.noise_lambda > 0.0:
            return None
        lam = torch.full((), self.priv.noise_lambda * (
            1.0 if state.has_prev else 0.0), dtype=torch.float32,
            device=sigma_c.device)
        return masking.XiCorrection(tuple(state.prev_key), sigma_c, lam)

    def _admin_mask_set(self, template, active, keys: BarrierKeys,
                        state: NoiseState, bound) -> dict:
        """The stacked ``(n_silos, ...)`` mask trees of one step: zero rows
        for dropped silos, the active rows telescoping to
        ``xi_t - lam * xi_{t-1}``. ``template`` gives the shapes only."""
        dev = flatbuf.flat_tensors(self.layout, template)[0].device
        sigma_c = self._sigma_c(bound, dev)
        return masking.admin_masks(
            keys.key_xi, template, self.n_silos, sigma_c,
            self.priv.mask_scale * sigma_c, active=active,
            correction=self._admin_correction(state, sigma_c))

    def admin_noise_tree(self, g_sum_tree: dict, keys: BarrierKeys,
                         state: NoiseState, bound) -> dict:
        """The central tiers' aggregate noise under admin masks: the exact
        ``xi_t - lam * xi_{t-1}`` the distributed mask set telescopes to,
        added into ``g_sum_tree``'s fp32 tensors in place (returned)."""
        dev = flatbuf.flat_tensors(self.layout, g_sum_tree)[0].device
        sigma_c = self._sigma_c(bound, dev)
        return masking.add_admin_noise(
            g_sum_tree, keys.key_xi, sigma_c,
            self._admin_correction(state, sigma_c))

    def admin_closing_row(self, template, active, keys: BarrierKeys,
                          state: NoiseState, bound, out=None) -> tuple:
        """The closing silo's mask row, the one O(k P) row of the set,
        drawn once by the admin and shipped to that silo alone, so every
        handler's work stays O(P). Returns ``(closing, row)``, the row a
        packed (P,) fp32 buffer on the template's device (``out`` when
        given): the same ``admin_mask_row`` call a handler would make, so
        a handler using it is bit-identical to one drawing it."""
        act, closing = masking._closing(self.n_silos, active)
        first = flatbuf.flat_tensors(self.layout, template)[0]
        sigma_c = self._sigma_c(bound, first.device)
        if out is None:
            out = torch.empty(self.layout.total, dtype=torch.float32,
                              device=first.device)
        masking.admin_mask_row(
            keys.key_xi, template, self.n_silos, closing, sigma_c,
            self.priv.mask_scale * sigma_c, active=act,
            correction=self._admin_correction(state, sigma_c), out=out)
        return closing, out

    def _contribution_admin(self, packed, silo: int, scaled, active,
                            keys: BarrierKeys, state: NoiseState, bound,
                            admin_row=None, out=None) -> torch.Tensor:
        """The admin branch of :meth:`silo_contribution`, for a concrete
        silo: ``g * scale * gate + row * gate`` over the packed buffer,
        the row this silo's own (its ``admin_mask_row``; the correction
        only in the closing row) or, for the closing silo, the admin's
        ``admin_row``."""
        act, closing = masking._closing(self.n_silos, active)
        gate = float(act[silo])
        dev = packed.device
        if admin_row is not None and silo == closing:
            row = admin_row
        else:
            sigma_c = self._sigma_c(bound, dev)
            corr = self._admin_correction(state, sigma_c) \
                if silo == closing else None
            row = torch.empty(self.layout.total, dtype=torch.float32,
                              device=dev)
            masking.admin_mask_row(
                keys.key_xi, flatbuf.unpack(self.layout, packed,
                                            dtype=torch.float32),
                self.n_silos, silo, sigma_c, self.priv.mask_scale * sigma_c,
                active=act, correction=corr, out=row)
        res = torch.mul(packed, scaled, out=out)
        return res.add_(row if gate == 1.0 else row * gate)  # x * 1 == x

    # -- stages ---------------------------------------------------------------
    def norms(self, stacked: torch.Tensor) -> torch.Tensor:
        """Per-silo global norms off a stacked (n, P) packed buffer (padding
        is exactly zero): ``sqrt(sum(g * g))`` per row, as JAX computes it,
        by ``clipping.sumsq`` (chunked dot products, no temporary)."""
        return torch.stack([torch.sqrt(clipping.sumsq(row)) for row in stacked])

    def norm_tree(self, tree) -> torch.Tensor:
        """One silo's global norm off its gradient tree (the barrier tier's
        norm: per-leaf sums added in leaf order, not the packed row's)."""
        return clipping.global_norm(tree)

    def dynamic_bound(self, norms, active, clip_key, fallback) -> torch.Tensor:
        """The percentile protocol over the active silos' norms; ``fallback``
        (the carried bound) when dynamic clipping is off."""
        if not (self.priv.enabled and self.priv.dynamic_clip):
            return torch.as_tensor(fallback, dtype=torch.float32,
                                   device=norms.device)
        mask = torch.as_tensor(self._active_or_full(active), device=norms.device)
        pcts = clipping.local_percentiles(norms, mask=mask)
        return dynamic_bound_from_percentiles(pcts[None], self.priv, clip_key)

    def clip_scale(self, norm, bound) -> torch.Tensor:
        return clipping.clip_scale(norm, bound)

    def clip_scales(self, norms, bound, active) -> torch.Tensor:
        """DP-SGD clip factors, zeroed for dropped silos."""
        scales = clipping.clip_scale(norms, bound) if self.priv.enabled \
            else torch.ones_like(norms, dtype=torch.float32)
        if is_static_full(active):
            return scales
        return scales * self._gates(active, norms.device)

    def masked_aggregate(self, stacked, scales) -> torch.Tensor:
        """sum_i scales_i * g_i over the stacked buffer: one kernel launch."""
        return clip_ops.clip_accumulate(stacked, scales)

    def corrected_noise_packed(self, g_sum, keys: BarrierKeys,
                               state: NoiseState, bound, active) -> torch.Tensor:
        """Aggregate plus every silo's corrected-noise share, accumulated in
        silo order by one ``noise_batch`` launch. The xi_{t-1} streams are
        drawn whenever lambda > 0, even on the first step, where the gates
        are 0."""
        priv = self.priv
        s, s_prev, pa = self._stream_scales(bound, active, state)
        dev = g_sum.device
        gates = self._gates(active, dev)
        pa_gates = torch.as_tensor(pa.astype(np.float32), device=dev)
        hp = 1.0 if state.has_prev else 0.0
        noise_scales = s * gates
        lam_gates = priv.noise_lambda * torch.tensor(hp, dtype=torch.float32,
                                                     device=dev) \
            * gates * pa_gates
        return fused_ops.noise_batch(g_sum, keys.key_xi, state.prev_key,
                                     noise_scales.contiguous(),
                                     lam_gates.contiguous(), s_prev.item(),
                                     use_prev=priv.noise_lambda > 0.0)

    def noise_stream(self, key, silo: int, device) -> torch.Tensor:
        """Silo ``silo``'s (P,) standard-normal stream under the raw key
        ``key`` on ``device``: the values ``clip_mask`` draws in the kernel
        for xi (the step's key) or xi_{t-1} (the carried ``prev_key``), the
        ``noise_stream`` kernel on a card."""
        out = torch.empty(self.layout.total, dtype=torch.float32,
                          device=device)
        return fused_ops.noise_stream(key, silo, out)

    def silo_contribution(self, g, silo: int, scale, active, keys: BarrierKeys,
                          state: NoiseState, bound, admin_row=None, xi=None,
                          xp=None, out=None) -> torch.Tensor:
        """One silo's wire contribution: its clipped gradient plus the
        zero-sum mask ``b * (r_silo - r_nxt)`` over the active ring, its
        ``sigma_c/sqrt(k)`` noise share and its lambda-correction share, one
        ``clip_mask`` dispatch. Summing every silo's output in silo order
        (:func:`reduce_contributions`) gives
        ``sum_i clip(g_i) + sigma*C*(xi_t - lam*xi_{t-1})``.

        ``g`` is the silo's gradient, a tree or its packed (P,) buffer;
        ``scale`` its clip factor (a 0-dim tensor); ``admin_row`` (mask
        mode ``admin``) the closing row the admin distributed, a packed
        (P,) buffer, read only by the closing silo (:meth:`_contribution_admin`:
        under ``admin`` the contribution is ``g * scale + row``, the row
        the admin's, whatever the policy); ``xi`` / ``xp`` its
        xi_t and xi_{t-1} streams from :meth:`noise_stream` (packed
        pairwise only; None draws them in the kernel); ``out`` receives the
        packed result (``g`` itself to work in place). Under the perleaf
        policy the result is a tree (views of that buffer), masked leaf by
        leaf (:meth:`_contribution_perleaf`). A dropped silo's
        contribution is zero: its scale, ``b``, ``s`` and ``lam`` are all
        gated. Mask mode ``none`` returns the clipped gradient with no DP
        terms at all, as the JAX package's barrier tier does (its fused
        tier adds the noise under ``none``). The fp32 scalars are made on
        the bound's device in the reference's order: ``sigma_c = sigma*C``,
        ``b = mask_scale*sigma_c*gate``, ``s*gate``,
        ``lam = lambda*hp*gate*pa_gate`` (the JAX package's gates are traced
        inside its shard_map, so it always multiplies by them: by 1.0 or
        0.0, exactly)."""
        priv = self.priv
        if (xi is not None or xp is not None) and (
                priv.mask_mode != "pairwise" or self.policy.mode != "packed"):
            raise ValueError(
                "external xi/xp streams only apply to the packed pairwise "
                "construction (admin/none/perleaf draw their own)")
        silo = int(silo)
        packed = g if isinstance(g, torch.Tensor) \
            else flatbuf.pack(self.layout, g)
        gate = float(self._active_or_full(active)[silo])
        scaled = scale * gate
        if priv.mask_mode == "none":
            # confidentiality-only sync: clipped gradient, no DP terms; a
            # bf16 leaf's clipped gradient rounded to bf16, as JAX's
            # ``(x * scaled).astype(x.dtype)``
            return self._round_bf16(torch.mul(packed, scaled, out=out))
        if priv.mask_mode == "admin":
            return self._contribution_admin(packed, silo, scaled, active,
                                            keys, state, bound, admin_row,
                                            out)
        if self.policy.mode == "perleaf":
            return self._contribution_perleaf(packed, silo, scale, active,
                                              keys, state, bound, out)
        dev = packed.device
        bound = torch.as_tensor(bound, dtype=torch.float32, device=dev)
        sigma_c = priv.sigma * bound
        s, s_prev, pa = self._stream_scales(bound, active, state)
        hp = torch.full((), 1.0 if state.has_prev else 0.0,
                        dtype=torch.float32, device=dev)
        lam_gate = priv.noise_lambda * hp * gate * float(pa[silo])
        return fused_ops.clip_mask(
            packed, scaled, keys.key_r, keys.key_xi, state.prev_key, silo,
            self.n_silos, sigma_c, priv.mask_scale * sigma_c * gate, lam_gate,
            use_pairwise=True, use_prev=priv.noise_lambda > 0.0,
            nxt=self.next_active(silo, active), noise_scale=s * gate,
            prev_noise_scale=s_prev, xi=xi, xp=xp, out=out)

    def _contribution_perleaf(self, packed, silo: int, scale, active,
                              keys: BarrierKeys, state: NoiseState, bound,
                              out=None) -> dict:
        """The perleaf branch of :meth:`silo_contribution`, as JAX builds
        it: the clipped gradient ``g * scale``; per leaf i (per tensor of a
        stacked leaf, at its counter offset) the ``zsmask`` of the full
        static ring over it, ``b = mask_scale * sigma_c``; and, with
        lambda > 0, the mask-only pass over zeros on ``prev_key`` with
        ``b = 0`` (the xi_{t-1} share, r streams drawn and zeroed),
        subtracted times ``lam = lambda * hp * pa_gate``. All of it in
        place over the packed buffer, one ``zsmask_buffer`` dispatch
        (:func:`masking.mask_buffer`), then the tree as views. A partial
        participation set raises: the per-leaf ring would leave
        uncancelled ``+-b * r`` terms in the aggregate."""
        if not is_static_full(active):
            raise ValueError(
                "the per-leaf mask family only builds the full static ring; "
                "dropping silos needs the packed policy (lift the "
                "dp_noise_tree=perleaf override for elastic runs)")
        priv = self.priv
        buf = torch.mul(packed, scale, out=out)
        dev = buf.device
        half = None
        if self.bf16_runs:
            # JAX's (x * scale).astype(x.dtype): the clipped bf16 leaves,
            # which the bf16 instantiation reads
            half = torch.empty(self.layout.total, dtype=torch.bfloat16,
                               device=dev)
            for a, z in self.bf16_runs:
                half[a:z].copy_(buf[a:z])
        bound = torch.as_tensor(bound, dtype=torch.float32, device=dev)
        sigma_c = priv.sigma * bound
        hp = torch.full((), 1.0 if state.has_prev else 0.0,
                        dtype=torch.float32, device=dev)
        lam_gate = priv.noise_lambda * hp * float(self.prev_active(state)[silo])
        masking.mask_buffer(buf, self.layout, keys.key_r, keys.key_xi, silo,
                            self.n_silos, sigma_c, priv.mask_scale * sigma_c,
                            state.prev_key if priv.noise_lambda > 0.0
                            else None, lam_gate, half=half)
        return flatbuf.unpack(self.layout, buf, dtype=torch.float32)

    @property
    def bf16_runs(self) -> tuple:
        """The bf16 leaves' ranges of the packed buffer
        (``flatbuf.dtype_runs``): empty for an fp32 tree."""
        return flatbuf.dtype_runs(self.layout, "bfloat16")

    def _round_bf16(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` (P,) fp32 with its bf16 leaves' ranges rounded to bf16
        (and widened back), in place."""
        for a, z in self.bf16_runs:
            buf[a:z] = buf[a:z].to(torch.bfloat16)
        return buf

    def bf16_contributions(self) -> bool:
        """Whether the barrier tier's contributions hold bf16 leaves: mask
        mode ``none``, or the perleaf policy without the lambda correction
        (with it, ``m - lam * p`` promotes a bf16 leaf to fp32: the strong
        fp32 ``lam`` of JAX's step). The packed policy and the admin
        masks contribute fp32."""
        if not self.bf16_runs:
            return False
        return self.priv.mask_mode == "none" or (
            self.priv.mask_mode == "pairwise"
            and self.policy.mode == "perleaf"
            and not self.priv.noise_lambda > 0.0)

    def round_aggregate(self, agg: torch.Tensor) -> torch.Tensor:
        """JAX's ``psum`` over the silo mesh of contributions with bf16
        leaves (:meth:`bf16_contributions`), on XLA's CPU backend: the
        leaves added in fp32 in silo order (:func:`reduce_contributions`)
        and the sum rounded to bf16 once, which ``finalize`` widens; in
        place. The identity otherwise."""
        return self._round_bf16(agg) if self.bf16_contributions() else agg

    def finalize(self, agg) -> dict:
        """The aggregated contribution -> the fp32 gradient tree: views into
        a packed ``agg``; a tree (the perleaf policy's) as it is."""
        if isinstance(agg, torch.Tensor):
            return flatbuf.unpack(self.layout, agg, dtype=torch.float32)
        return agg

    def corrected_noise_tree(self, g_sum_tree: dict, keys: BarrierKeys,
                             state: NoiseState, bound, active) -> dict:
        """Tree-level corrected noise for the central tiers. Admin masks:
        :meth:`admin_noise_tree`, in place. Packed: through
        :meth:`corrected_noise_packed` (a new tree, views of one buffer).
        Perleaf: ``noise_correction.corrected_noise``, one stream at full
        ``sigma_c`` (its std does not depend on the active count), added in
        place into ``g_sum_tree``'s fp32 tensors, which are returned."""
        if self.priv.mask_mode == "admin":
            return self.admin_noise_tree(g_sum_tree, keys, state, bound)
        if self.policy.mode == "packed":
            packed = flatbuf.pack(self.layout, g_sum_tree)
            return flatbuf.unpack(self.layout, self.corrected_noise_packed(
                packed, keys, state, bound, active), dtype=torch.float32)
        first = flatbuf.flat_tensors(self.layout, g_sum_tree)[0]
        sigma_c = self.priv.sigma * torch.as_tensor(
            bound, dtype=torch.float32, device=first.device)
        return noise_correction.corrected_noise(
            g_sum_tree, keys.key_xi, state, sigma_c,
            self.priv.noise_lambda)[0]

    # -- composed run -----------------------------------------------------------
    def run_central(self, g_stacked, norms, keys: BarrierKeys,
                    state: NoiseState, bound, clip_key, active, timer):
        """The whole stage graph over a stacked (n, P) packed buffer.
        Returns ``(noisy (P,) fp32, new_state, bound)``; ``flatbuf.unpack``
        gives the tree as views. ``timer`` (``distributed.steps.StageTimer``)
        times the ``aggregate`` and ``noise`` stages."""
        with timer.stage("aggregate"):
            bound = self.dynamic_bound(norms, active, clip_key, bound)
            scales = self.clip_scales(norms, bound, active)
            g_sum = self.masked_aggregate(g_stacked, scales)
        if not self.priv.enabled:
            return g_sum, state, bound
        with timer.stage("noise"):
            if self.priv.mask_mode == "admin":
                self.admin_noise_tree(flatbuf.unpack(self.layout, g_sum,
                                                     dtype=torch.float32),
                                      keys, state, bound)
                noisy = g_sum
            else:
                noisy = self.corrected_noise_packed(g_sum, keys, state,
                                                    bound, active)
        return noisy, self.advance_state(keys, state, active), bound

    # -- helpers ------------------------------------------------------------------
    def _active_or_full(self, active) -> np.ndarray:
        return self.full_active() if active is None else \
            np.asarray(active, bool)

    def _gates(self, active, device) -> torch.Tensor:
        return torch.as_tensor(self._active_or_full(active).astype(np.float32),
                               device=device)


def reduce_contributions(updates) -> torch.Tensor:
    """The model updater's aggregation: the sum of the packed per-silo
    contributions in silo order, the fused tier's noise-accumulation order
    (under the perleaf policy, the buffers the contribution trees view:
    summing them sums the trees leaf for leaf).
    Accumulates in place into the first contribution, which becomes the
    aggregate (the barrier tier reads no contribution again)."""
    it = iter(updates)
    total = next(it)
    for u in it:
        total.add_(u)
    return total
