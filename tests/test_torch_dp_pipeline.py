"""``DPPipeline.run_central``, the fused tier's whole DP stage graph, against
the JAX package on identical stacked (n, P) packed buffers, norms and keys:
static and partial participation sets, dynamic clipping on and off, a first
step (no xi_{t-1}) and a later one, and the pairwise and none mask modes.

The carried noise key and participation set must be equal. The bound goes
through ``erfinv`` (equal in these cases; held to 1e-6 relative, the erfinv
difference being up to 4.8e-7 absolute, ``test_torch_threefry.py``); the
noisy aggregate through libm's ``log`` and a reordered fp32 sum (measured
max 2.4e-7 on values up to 2.8; held to 4e-6).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro.core.barrier import BarrierKeys as JaxKeys
from repro.core.dp_pipeline import DPPipeline as JaxPipeline
from repro.core.noise_correction import NoiseState as JaxNoiseState
from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import clipping, flatbuf
from repro_torch.core.barrier import BarrierKeys
from repro_torch.core.dp_pipeline import DPPipeline
from repro_torch.core.noise_correction import NoiseState
from repro_torch.distributed.steps import StageTimer

NOISY_ATOL = 4e-6
BOUND_RTOL = 1e-6
KEYS = ((3704974950, 1863054868), (2705940334, 2639757084),
        (788428910, 4288801516))
PREV_KEY = (4086990474, 1067026239)
SHAPES = {"a": (37,), "b": (3, 50), "c": {"d": (129,)}, "e": (2, 2, 64)}


def _layouts():
    jtree = {k: (jnp.zeros(v) if isinstance(v, tuple)
                 else {kk: jnp.zeros(vv) for kk, vv in v.items()})
             for k, v in SHAPES.items()}
    ttree = {"a": torch.zeros(37), "b": torch.zeros(3, 50),
             "c.d": torch.zeros(129), "e": [torch.zeros(2, 64)] * 2}
    jl, tl = jflat.layout_of(jtree), flatbuf.layout_of(ttree)
    assert (jl.offsets, jl.total) == (tl.offsets, tl.total)
    return jl, tl


def _stacked(n, jl, seed):
    """(n, P) packed rows with zero padding and norms spread over [0.5, 3]."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        tree = {k: (jnp.asarray(rng.standard_normal(v), jnp.float32)
                    if isinstance(v, tuple) else
                    {kk: jnp.asarray(rng.standard_normal(vv), jnp.float32)
                     for kk, vv in v.items()}) for k, v in SHAPES.items()}
        row = np.asarray(jflat.pack(jl, tree))
        rows.append(row * (0.5 + 2.5 * i / max(n - 1, 1)) / np.linalg.norm(row))
    g = np.stack(rows).astype(np.float32)
    return g, np.sqrt((g.astype(np.float64) ** 2).sum(-1)).astype(np.float32)


CASES = [
    # n, active, dynamic_clip, has_prev, prev_active, mask_mode
    (4, None, True, False, None, "pairwise"),
    (4, None, True, True, None, "pairwise"),
    (4, None, False, True, None, "none"),
    (4, [1, 0, 1, 1], True, True, [1, 1, 1, 1], "pairwise"),
    (4, [1, 0, 1, 1], False, True, [1, 1, 0, 1], "pairwise"),
    (5, [1, 1, 0, 1, 0], True, True, [0, 1, 1, 1, 1], "none"),
    (5, [1, 1, 1, 1, 1], True, False, [1, 1, 1, 1, 1], "pairwise"),
]


@pytest.mark.parametrize("n,active,dyn,has_prev,prev_active,mode", CASES)
def test_run_central_matches_jax(n, active, dyn, has_prev, prev_active, mode):
    jl, tl = _layouts()
    g, norms = _stacked(n, jl, seed=n + 3 * dyn + 5 * has_prev)
    priv = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=dyn,
                noise_lambda=0.7, n_silos=n, mask_mode=mode)
    pa = np.ones(n, bool) if prev_active is None else np.asarray(prev_active,
                                                                 bool)
    act = None if active is None else np.asarray(active, bool)

    jpipe = JaxPipeline(JaxPrivacy(**priv), jl, n)
    jkeys = JaxKeys(*(jnp.asarray(k, jnp.uint32) for k in KEYS))
    jstate = JaxNoiseState(jnp.asarray(PREV_KEY, jnp.uint32),
                           jnp.asarray(has_prev), jnp.asarray(pa))
    jnoisy, jns, jbound = jpipe.run_central(
        jnp.asarray(g), jnp.asarray(norms), jkeys, jstate,
        jnp.asarray(1.0, jnp.float32), jkeys.key_clip,
        None if act is None else jnp.asarray(act))

    pipe = DPPipeline(PrivacyConfig(**priv), tl, n)
    state = NoiseState(PREV_KEY, has_prev, pa)
    noisy, ns, bound = pipe.run_central(
        torch.from_numpy(g), torch.from_numpy(norms), BarrierKeys(*KEYS),
        state, torch.tensor(1.0), KEYS[2], act, StageTimer("cpu"))

    np.testing.assert_allclose(float(bound), float(jbound), rtol=BOUND_RTOL)
    if dyn:
        assert float(bound) != 1.0  # the percentile protocol ran
    want = np.asarray(jflat.pack(jl, jnoisy))
    got = flatbuf.zero_padding(tl, noisy).numpy()
    np.testing.assert_allclose(got, want, atol=NOISY_ATOL, rtol=0)
    assert ns.prev_key == tuple(int(x) for x in np.asarray(jns.prev_key))
    assert ns.has_prev and bool(jns.has_prev)
    np.testing.assert_array_equal(ns.prev_active, np.asarray(jns.prev_active))


def test_privacy_off_is_the_plain_aggregate():
    jl, tl = _layouts()
    g, norms = _stacked(4, jl, seed=0)
    pipe = DPPipeline(PrivacyConfig(enabled=False, n_silos=4), tl, 4)
    state = NoiseState(PREV_KEY, False, np.ones(4, bool))
    out, ns, bound = pipe.run_central(
        torch.from_numpy(g), torch.from_numpy(norms), BarrierKeys(*KEYS),
        state, torch.tensor(1.0), KEYS[2], None, StageTimer("cpu"))
    assert ns is state and float(bound) == 1.0
    np.testing.assert_allclose(out.numpy(), g.sum(0), atol=1e-6)


def test_norms_stage_matches_float64():
    jl, tl = _layouts()
    g, norms = _stacked(3, jl, seed=1)
    pipe = DPPipeline(PrivacyConfig(n_silos=3), tl, 3)
    np.testing.assert_allclose(pipe.norms(torch.from_numpy(g)).numpy(), norms,
                               rtol=1e-6)


def test_global_norm_matches_float64():
    """The repaired ``global_norm``: chunked dot products per leaf, no
    tensor of squares, within 1e-6 of float64 on a leaf of a few million
    elements on one thread as on many (measured 3.5e-8; torch's CPU
    ``vector_norm`` loses 6e-5 there, a single MKL dot on one thread
    3e-6)."""
    threads = torch.get_num_threads()
    rng = np.random.default_rng(3)
    big = rng.standard_normal(3_000_001).astype(np.float32) * 0.01
    small = rng.standard_normal((7, 33)).astype(np.float32)
    tree = {"w": torch.from_numpy(big), "layers.x": [torch.from_numpy(small)] * 2}
    want = np.sqrt((big.astype(np.float64) ** 2).sum()
                   + 2 * (small.astype(np.float64) ** 2).sum())
    try:
        for n in (1, threads):
            torch.set_num_threads(n)
            np.testing.assert_allclose(float(clipping.global_norm(tree)),
                                       want, rtol=1e-6)
    finally:
        torch.set_num_threads(threads)
    clipped, norm = clipping.clip_tree(tree, 1.0)
    np.testing.assert_allclose(float(clipping.global_norm(clipped)), 1.0,
                               rtol=1e-6)
    assert float(norm) == float(clipping.global_norm(tree))


def test_unported_constructions_raise():
    _, tl = _layouts()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DPPipeline(PrivacyConfig(mask_mode="admin"), tl, 4)
    pipe = DPPipeline(dataclasses.replace(PrivacyConfig(), n_silos=4), tl, 4)
    g = torch.zeros(tl.total)
    args = (g, 0, torch.tensor(1.0), None, BarrierKeys(*KEYS),
            NoiseState(PREV_KEY, False, None), torch.tensor(1.0))
    # external streams (item 8b, ported): only the packed pairwise
    # construction takes them
    none = DPPipeline(dataclasses.replace(PrivacyConfig(), n_silos=4,
                                          mask_mode="none"), tl, 4)
    with pytest.raises(ValueError, match="packed pairwise"):
        none.silo_contribution(*args, xi=g)
    xi = pipe.noise_stream(KEYS[1], 0, "cpu")
    assert torch.equal(pipe.silo_contribution(*args, xi=xi),
                       pipe.silo_contribution(*args))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 9"):
        pipe.silo_contribution(*args, admin_row=g)
