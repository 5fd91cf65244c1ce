"""The MoE layer (``models/moe.py``) against the JAX package's
``repro/models/moe.py`` at the MoE archs' smoke widths in fp32, from the
same weights (JAX's ``moe_init``, carried across as numpy).

* The routing, from the same router logits: ``idx``, ``pos`` and ``keep``
  bit-equal at capacity factors 4.0 (the smoke configs' dropless setting)
  and 1.25 (the published one, where tokens drop), and on rows of equal
  logits, where ``jax.lax.top_k`` puts the lower index first.
* ``_moe_tokens`` end to end: the output and the aux load-balance loss at
  both capacity factors (at 1.25 some token is dropped), with a zero
  token row among the inputs (all-equal router probabilities).
* ``moe_apply_dense_ref`` against the dispatch path, dropless.
* The gradient through the dispatch (of the output and the aux term)
  against ``jax.grad``, for every weight and the input, at 1.25.

Tolerances: the output, the aux term and the gradients within 1e-5
(absolute and relative): fp32 products in another order (measured on this
CPU: the output at most 3.1e-6 off at magnitudes up to 9.2, the aux term
4.8e-7; 17 and 29 picks of 96 dropped at 1.25).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
TOL = 1e-5
T = 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0):
    """(port cfg, JAX cfg, JAX params, port MoE, tokens (T, D) numpy): the
    tokens lean toward one direction, so the router favours some experts
    and the published capacity factor drops tokens; row 5 is zero."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = jax.jit(lambda k: jmoe.moe_init(k, jcfg, jnp.float32))(
        jax.random.PRNGKey(seed))
    layer = moe.MoE(cfg, "cpu")
    with torch.no_grad():
        for name, t in layer.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    x += 1.5 * rng.standard_normal(cfg.d_model).astype(np.float32)
    x[5] = 0.0
    return cfg, jcfg, jp, layer, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_routing_bit_equal(arch, cf):
    cfg, jcfg, jp, layer, x = _setup(arch)
    logits = np.array(jnp.asarray(x) @ jp["router"])
    capacity = moe.capacity_of(T, cfg, cf)
    assert capacity == int(max(jcfg.top_k, T * jcfg.top_k / jcfg.n_experts
                               * cf))
    jg, jidx = jmoe._topk_gates(jnp.asarray(logits), jcfg.top_k)
    jpos, jkeep = jmoe._positions_in_expert(jidx, jcfg.n_experts, capacity)
    tg, tidx = moe._topk_gates(torch.from_numpy(logits), cfg.top_k)
    tpos, tkeep = moe._positions_in_expert(tidx, cfg.n_experts, capacity)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)
    # the zero row: all-equal probabilities, the lowest indices first
    np.testing.assert_array_equal(tidx[5].numpy(), np.arange(cfg.top_k))
    dropped = int((~tkeep).sum())
    assert (dropped > 0) == (cf < 4.0), dropped  # dropless at 4.0
    # route() is the same routing from the tokens
    _, gates, idx, pos, keep = moe.route(torch.from_numpy(x), layer.router,
                                         cfg, capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert bool((gates[~keep] == 0).all())


def test_equal_logits_take_the_lower_index_first():
    """Rows with ties anywhere: the order of ``jax.lax.top_k``."""
    logits = np.array([[0.0, 0.0, 0.0, 0.0],
                       [1.0, 2.0, 2.0, 1.0],
                       [3.0, 1.0, 3.0, 3.0],
                       [-1.0, 5.0, -1.0, 5.0]], np.float32)
    for k in (1, 2, 3):
        jg, jidx = jmoe._topk_gates(jnp.asarray(logits), k)
        tg, tidx = moe._topk_gates(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL)
    _, idx = moe._topk_gates(torch.from_numpy(logits), 2)
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2], [1, 3]]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_moe_tokens_match_jax(arch, cf):
    cfg, jcfg, jp, layer, x = _setup(arch, seed=1)
    jout, jaux = jax.jit(lambda p, xx: jmoe._moe_tokens(p, xx, jcfg, cf))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        out, aux = moe._moe_tokens(layer, torch.from_numpy(x), cfg, cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    assert np.abs(np.asarray(jout)).max() > 0.1
    assert np.all(out[5].numpy() == 0.0)  # a zero row maps to zero
    _, _, _, _, keep = moe.route(torch.from_numpy(x), layer.router, cfg,
                                 moe.capacity_of(T, cfg, cf))
    if cf < 4.0:  # dropped picks: some token lost an expert's output
        assert int((~keep).sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_reference_matches_dispatch_dropless(arch):
    cfg, jcfg, jp, layer, x = _setup(arch, seed=2)
    xb = torch.from_numpy(x).reshape(2, T // 2, cfg.d_model)
    with torch.no_grad():
        out, _ = moe.moe_apply(layer, xb, cfg, float(cfg.n_experts))
        ref = moe.moe_apply_dense_ref(layer, xb, cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    jref = jmoe.moe_apply_dense_ref(jp, jnp.asarray(xb.numpy()), jcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_through_dispatch_matches_jax_grad(arch):
    """d/d(weights, x) of sum(out * w) + aux at capacity factor 1.25, where
    tokens drop: the scatter, the gather and the gates' renormalization
    differentiated as JAX differentiates them."""
    cfg, jcfg, jp, layer, x = _setup(arch, seed=3)
    cf = 1.25
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe._moe_tokens(p, xx, jcfg, cf)
        return jnp.sum(out * jnp.asarray(w)) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe._moe_tokens(layer, xt, cfg, cf)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    for name, t in layer.named_parameters():
        want = np.asarray(jgp[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(jgx)).max())


def test_published_decode_step_drops_at_capacity_two():
    """phi3.5-moe's published capacity at a decode step of 4 slots is
    max(2, 4 * 2 / 16 * 1.25) = 2 (the JAX package's formula)."""
    from repro_torch.configs import get_config
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    assert moe.capacity_of(4, cfg, cfg.moe_capacity_factor) == 2
    small = dataclasses.replace(get_smoke_config(ARCHS[0]),
                                moe_capacity_factor=1.25)
    assert moe.capacity_of(4, small, small.moe_capacity_factor) == 2
