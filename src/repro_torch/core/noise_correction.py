"""DP noise correction (paper section 4.4, Appendix A). Port of
``repro/core/noise_correction.py``.

Noise added at step t is ``xi_t - lambda * xi_{t-1}`` with per-step scale
``sigma = sigma_tilde / (1 - lambda)``. The state carries only the 32-byte
key that generated ``xi_{t-1}`` (not the O(P) tensor): the packed kernels
regenerate ``xi_{t-1}`` from it on the fly, and the per-leaf family
(:func:`corrected_noise`) redraws it with ``jax.random.normal``
(``core/prng.py``), one ``split`` of the key per leaf, a stacked leaf's
counters running across its tensors, and adds the noise into the aggregate
in place: one ``normal_combine`` launch per leaf tensor on the card
(``kernels/prng``), its plain version a window at a time on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import flatbuf, prng
from repro_torch.kernels.prng import ops as prng_ops
from repro_torch.kernels.zsmask.ref import _on


class NoiseState(NamedTuple):
    prev_key: tuple    # (k0, k1): the key that generated xi_{t-1}
    has_prev: bool     # the first step has no xi_{t-1}
    # (n_silos,) bool: which silos contributed xi_{t-1}; None = all of them
    prev_active: Optional[np.ndarray] = None


def init_state(key: tuple, n_silos: int = 0) -> NoiseState:
    """``n_silos > 0`` allocates the participation memory; 0 keeps the
    legacy two-field state (all silos implicitly active)."""
    prev_active = np.ones(n_silos, bool) if n_silos else None
    return NoiseState(prev_key=(int(key[0]), int(key[1])), has_prev=False,
                      prev_active=prev_active)


def corrected_noise(tree: dict, key_t: tuple, state: NoiseState, sigma_c,
                    lam: float) -> tuple:
    """Add ``xi_t - lam * xi_{t-1}`` into ``tree``'s fp32 tensors in place
    and return ``(tree, new state)``; both streams have std ``sigma_c``
    (= sigma * C). Leaf i draws ``normal(split(key, n_leaves)[i])`` over
    its whole (stacked) shape, as JAX's ``corrected_noise`` does: each
    tensor of it, at its counter offset, gets ``xi_t * sigma_c - (xi_{t-1}
    * sigma_c) * gate`` added in one ``normal_combine`` (no noise tree,
    no temporary on the card), the values JAX's noise tree holds at those
    positions (JAX returns the tree; adding it into zeros gives it). The
    gate is ``lam`` once the state has a previous step, else 0; with
    ``lam == 0`` only xi_t is drawn."""
    layout = flatbuf.layout_of(tree)
    keys_t = prng.split(key_t, layout.n_leaves)
    keys_p = prng.split(state.prev_key, layout.n_leaves) if lam != 0.0 \
        else None
    scalars: dict = {}
    for i, offset, t in flatbuf.leaf_slices(layout, tree):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("corrected_noise adds into contiguous fp32 "
                             "tensors")
        dev = t.device
        if dev not in scalars:  # fills, not host copies (no stream wait)
            scalars[dev] = (_on(sigma_c, dev), torch.full(
                (), lam if state.has_prev else 0.0, dtype=torch.float32,
                device=dev))
        sc, gate = scalars[dev]
        prng_ops.normal_combine(t, keys_t[i], None if keys_p is None
                                else keys_p[i], offset, sc, sc, gate,
                                accumulate=True)
    return tree, NoiseState(prev_key=tuple(key_t), has_prev=True)


def effective_sigma(sigma_tilde: float, lam: float) -> float:
    """Per-step noise scale that keeps the Thm.-1 guarantee at sigma_tilde."""
    return sigma_tilde / (1.0 - lam)
