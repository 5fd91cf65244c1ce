"""DP noise correction (paper section 4.4, Appendix A). Port of
``repro/core/noise_correction.py``.

Noise added at step t is ``xi_t - lambda * xi_{t-1}`` with per-step scale
``sigma = sigma_tilde / (1 - lambda)``. The state carries only the 32-byte
key that generated ``xi_{t-1}`` (not the O(P) tensor): the packed kernels
regenerate ``xi_{t-1}`` from it on the fly, and the per-leaf family
(:func:`corrected_noise`) redraws it with ``jax.random.normal``
(``core/prng.py``), one ``split`` of the key per leaf, a stacked leaf's
counters running across its tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import flatbuf, prng


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


def _noise_like(key: tuple, tree: dict, scale) -> dict:
    """``normal(split(key, n_leaves)[i], leaf.shape) * scale`` for every
    leaf i of ``tree`` (fp32, on each tensor's device)."""
    layout = flatbuf.layout_of(tree)
    keys = prng.split(key, layout.n_leaves)

    def one(i, offset, t):
        z = prng.normal(keys[i], tuple(t.shape), offset, t.device)
        return z * torch.as_tensor(scale, dtype=torch.float32, device=t.device)

    return flatbuf.map_leaf_slices(layout, tree, one)


def corrected_noise(tree_template: dict, key_t: tuple, state: NoiseState,
                    sigma_c, lam: float) -> tuple:
    """``(noise tree = xi_t - lam * xi_{t-1}, new state)``; both streams
    have std ``sigma_c`` (= sigma * C). The gate is ``lam`` once the state
    has a previous step, else 0; with ``lam == 0`` only xi_t is drawn."""
    xi_t = _noise_like(key_t, tree_template, sigma_c)
    new_state = NoiseState(prev_key=tuple(key_t), has_prev=True)
    if lam == 0.0:
        return xi_t, new_state
    xi_prev = _noise_like(state.prev_key, tree_template, sigma_c)
    gate = lam if state.has_prev else 0.0

    def sub(a, b):
        return a - torch.tensor(gate, dtype=torch.float32, device=a.device) * b

    noise = {k: [sub(a, b) for a, b in zip(v, xi_prev[k])]
             if isinstance(v, list) else sub(v, xi_prev[k])
             for k, v in xi_t.items()}
    return noise, new_state


def effective_sigma(sigma_tilde: float, lam: float) -> float:
    """Per-step noise scale that keeps the Thm.-1 guarantee at sigma_tilde."""
    return sigma_tilde / (1.0 - lam)
