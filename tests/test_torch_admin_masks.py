"""The admin masks and the integer-ring masks (``core/masking.py``) and the
admin mask mode on every tier (the fused and barrier tiers of
``distributed/steps.py``, the wire tier of ``api.CollaborativeSession``),
against the JAX package on the same keys and numpy inputs.

* ``admin_masks``, ``admin_mask_row``, ``admin_xi``, ``apply_admin_mask``:
  every draw is a ``jax.random.normal``, which the port's ``prng.normal``
  gives within ``ERFINV_ATOL`` of a standard normal
  (``tests/test_torch_threefry.py``); a mask element sums a few scaled
  draws, so it is held to ``ERFINV_ATOL`` times the sum of the draws'
  scales, plus one fp32 rounding of the largest value per term. Within the
  port a row equals its row of the stacked set element for element, with
  and without correction, full and partial sets, as JAX guarantees (its
  ``tests/test_dp_pipeline.py``); the correction drawn window by window
  (``XiCorrection``) equals the correction tree bit for bit.
* The ring masks: bit-equal to JAX's, and the masks of a ring sum to zero
  mod 2**32.
* The tiers under admin masks (JAX's ``test_admin_mask_mode_parity_wire_vs_
  fused`` and ``test_admin_closing_row_distribution_bit_identical``): the
  fused tier's aggregate against JAX's ``_fused_grads`` (``NOISY_ATOL``,
  ``tests/test_torch_training.py``); the barrier tier's and the wire tier's
  summed contributions against the fused aggregate and the clipped sum plus
  ``xi_t - lam xi_{t-1}``, within the masks' fp32 residue (``MASK_ATOL_PER_B``
  units of B); the admin's distributed closing row bit-equal to the row the
  closing handler draws; 3 wire rounds with a drop against JAX's session
  (``tests/test_torch_wire.py``'s tolerances); 3 ``Session.train`` steps
  against JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CollaborativeSession as JSession
from repro.api import Session as JaxSession
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.configs.paper_models import MNIST_MLP3 as JMLP3
from repro.core import flatbuf as jflat
from repro.core import masking as jmask
from repro.core.barrier import step_keys as jax_step_keys
from repro.core.noise_correction import NoiseState as JaxNoiseState
from repro.data.synthetic import synthetic_mnist as jmnist
from repro.distributed import steps as jsteps
from repro.models.small import build_small_model as jbuild
from repro_torch.api import CollaborativeSession, Session
from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                      PrivacyConfig)
from repro_torch.configs.paper_models import MNIST_MLP3
from repro_torch.core import clipping, flatbuf, masking, prng
from repro_torch.core.barrier import step_keys
from repro_torch.core.dp_pipeline import DPPipeline, reduce_contributions
from repro_torch.core.noise_correction import NoiseState
from repro_torch.core.tee import wire
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.packing import param_tree
from repro_torch.models.small import build_small_model, value_and_grad

ERFINV_ATOL = 2e-6   # prng.normal vs jax.random.normal, a standard normal
NOISY_ATOL = 4e-6    # the fused tier's noisy aggregate vs JAX's
RTOL = 1e-5          # loss, norms, bound: fp32 sums in another order
# a sum of contributions carrying +-B r terms that cancel: 8 ulps of 20 B
MASK_ATOL_PER_B = 8 * 2.0 ** -23 * 20
# the wire tier's rounds (tests/test_torch_wire.py)
W_SIGMA, W_LR, LOSS_RTOL, PARAM_ATOL = 0.05, 0.5, 1e-5, 1e-6
ARCH = "qwen2.5-3b"
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4, mask_mode="admin")
KEY, PREV = (0, 7), (4086990474, 1067026239)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(fill=0.0):
    """A port tree with a stacked leaf and the JAX tree of its shapes."""
    t = {"w": torch.full((4096,), fill), "b": torch.full((64,), fill),
         "e": [torch.full((3, 5), fill) for _ in range(2)]}
    j = {"w": jnp.full((4096,), fill), "b": jnp.full((64,), fill),
         "e": jnp.full((2, 3, 5), fill)}
    return t, j


def _stack(leaf, axis=0):
    return torch.stack(leaf, axis) if isinstance(leaf, list) else leaf


CASES = [dict(active=None, corr=False), dict(active=[1, 0, 1, 1], corr=False),
         dict(active=[1, 1, 1, 1], corr=True), dict(active=[0, 1, 1, 0],
                                                    corr=True)]


@pytest.mark.parametrize("case", CASES)
def test_admin_masks_and_rows_match_jax(case):
    n, sc, b = 4, 1.5, 8.0 * 1.5
    act = None if case["active"] is None else np.asarray(case["active"], bool)
    t, j = _trees()
    corr = jcorr = None
    if case["corr"]:
        corr, jcorr = _trees(0.25)
    masks = masking.admin_masks(KEY, t, n, sc, b, active=act, correction=corr)
    want = jmask.admin_masks(jax.random.PRNGKey(7), j, n, sc, b, active=act,
                             correction=jcorr)
    for k in t:
        got, w = _stack(masks[k], 1).numpy(), np.asarray(want[k])
        tol = ERFINV_ATOL * (n * b + sc) + (n + 2) * np.spacing(
            np.float32(np.abs(w).max()))
        np.testing.assert_allclose(got, w, atol=tol, rtol=0, err_msg=k)
    for i in range(n):
        row = masking.admin_mask_row(KEY, t, n, i, sc, b, active=act,
                                     correction=corr)
        for k in t:
            assert torch.equal(_stack(row[k]), _stack(masks[k], 1)[i]), (k, i)
    # the active rows telescope to xi - correction; dropped rows are zero
    xi = masking.admin_xi(KEY, t, sc)
    gates = np.ones(n, bool) if act is None else act
    for k in t:
        rows = _stack(masks[k], 1)
        assert not rows[~torch.from_numpy(gates)].any()
        total = rows.sum(0) - (_stack(xi[k]) - (0.25 if corr else 0.0))
        assert total.abs().max() <= n * 8 * np.spacing(np.float32(b * 6))


def test_admin_xi_and_apply_match_jax():
    t, j = _trees(0.5)
    xi = masking.admin_xi(KEY, t, 1.5)
    want = jmask.admin_xi(jax.random.PRNGKey(7), j, 1.5)
    for k in t:
        np.testing.assert_allclose(_stack(xi[k]).numpy(), np.asarray(want[k]),
                                   atol=ERFINV_ATOL * 1.5, rtol=0)
    masks = masking.admin_masks(KEY, t, 3, 1.5, 12.0)
    out = masking.apply_admin_mask(t, masks, 2)
    for k in t:
        assert torch.equal(_stack(out[k]), _stack(t[k]) + _stack(masks[k],
                                                                 1)[2])


@pytest.mark.parametrize("has_prev", [True, False])
def test_windowed_correction_equals_the_correction_tree(has_prev,
                                                        monkeypatch):
    """``XiCorrection`` (lam * admin_xi of the carried key, drawn window
    by window) gives the rows the tree gives, bit for bit, at any window;
    ``add_admin_noise`` adds ``xi - correction`` in place."""
    lam = torch.tensor(0.7 if has_prev else 0.0)
    t, _ = _trees()
    sc = torch.tensor(1.5)
    xp = masking.admin_xi(PREV, t, sc)
    tree = {k: [x * lam for x in v] if isinstance(v, list) else v * lam
            for k, v in xp.items()}
    lazy = masking.XiCorrection(PREV, sc, lam)
    want = masking.admin_mask_row(KEY, t, 4, 3, sc, 12.0, correction=tree)
    monkeypatch.setattr(masking, "WINDOW", 1000)  # leaves past one window
    got = masking.admin_mask_row(KEY, t, 4, 3, sc, 12.0, correction=lazy)
    noisy = masking.add_admin_noise(_trees(0.5)[0], KEY, sc, lazy)
    xi = masking.admin_xi(KEY, t, sc)
    for k in t:
        assert torch.equal(_stack(got[k]), _stack(want[k]))
        assert torch.equal(_stack(noisy[k]),
                           0.5 + (_stack(xi[k]) - _stack(tree[k])))


def test_ring_masks_bit_equal_jax_and_cancel():
    rng = np.random.default_rng(0)
    g = {"w": rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64),
         "e": rng.integers(-2 ** 31, 2 ** 31, (2, 3, 5), dtype=np.int64)}
    g = {k: v.astype(np.int32) for k, v in g.items()}
    tg = {"w": torch.from_numpy(g["w"]),
          "e": [torch.from_numpy(x) for x in g["e"]]}
    jg = jax.tree.map(jnp.asarray, g)
    zeros = {"w": torch.zeros(4096, dtype=torch.int32),
             "e": [torch.zeros(3, 5, dtype=torch.int32)] * 2}
    total = None
    for silo in range(3):
        got = masking.ring_mask_tree(tg, (3, 4), silo, 3)
        want = jmask.ring_mask_tree(jg, jnp.asarray([3, 4], jnp.uint32),
                                    silo, 3)
        for k in g:
            assert np.array_equal(_stack(got[k]).numpy(), np.asarray(want[k]))
        m = masking.ring_mask_tree(zeros, (3, 4), silo, 3)
        m = {k: _stack(v).to(torch.int64) for k, v in m.items()}
        total = m if total is None else {k: total[k] + m[k] for k in m}
    assert all(not ((v & 0xFFFFFFFF).any()) for v in total.values())
    x = torch.linspace(-2.0, 2.0, 1001)
    r = masking.to_ring(x, 1.5)
    assert r.dtype == torch.int32
    assert np.array_equal(r.numpy(),
                          np.asarray(jmask.to_ring(jnp.asarray(x.numpy()),
                                                   1.5)))
    assert np.array_equal(masking.from_ring(r, 1.5).numpy(), np.asarray(
        jmask.from_ring(jnp.asarray(r.numpy()), 1.5)))


# ---------------------------------------------------------------------------
# the tiers under admin masks, at the qwen2.5-3b smoke config


@pytest.fixture(scope="module")
def weights():
    model = transformer.init(torch.Generator().manual_seed(0),
                             Session.from_config(ARCH, device="cpu").cfg,
                             "cpu")
    return params_to_numpy(model)


def _port(weights, mesh=None, **priv):
    ts = Session.from_config(
        ARCH, device="cpu", privacy=PrivacyConfig(**{**QUICKSTART, **priv}),
        optimizer=OptimizerConfig(name="adamw", lr=1e-3), mesh=mesh)
    return ts, ts.init_state(params=params_from_jax(weights, ts.cfg, "cpu"))


def _jax(weights, **priv):
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**{**QUICKSTART,
                                                           **priv}),
                                optimizer=JaxOptimizer(name="adamw", lr=1e-3))
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, weights))
    return js, jsteps.init_train_state(jmodel, js.run_cfg,
                                       jax.random.PRNGKey(0))


def _batch(js):
    batch = js.synthetic_batches(16, 16)()
    return batch, {k: torch.as_tensor(np.array(v), dtype=torch.long)
                   for k, v in batch.items()}


@pytest.mark.parametrize("active", [None, [True, False, True, True]])
def test_fused_and_barrier_tiers_match_jax(weights, active):
    """One primed step: the port's fused aggregate against JAX's
    ``_fused_grads`` under admin masks; the port's barrier aggregate (each
    silo's ``g * scale + row``, the closing row carrying xi_t and the
    correction) against the fused one within the masks' residue; and both
    against the clipped sum plus ``xi_t - lam xi_{t-1}``."""
    js, jstate = _jax(weights)
    ts, tstate = _port(weights)
    batch, tbatch = _batch(js)
    act = None if active is None else np.asarray(active)
    jkeys, tkeys = jax_step_keys(jax.random.PRNGKey(1), 0), \
        step_keys(prng.PRNGKey(1), 0)
    jns = JaxNoiseState(jnp.asarray(PREV, jnp.uint32), jnp.asarray(True),
                        jnp.ones(4, bool))
    tns = NoiseState(PREV, True, np.ones(4, bool))
    jn, jloss, _, _, jbound = jsteps._fused_grads(
        js.model, js.run_cfg.privacy, jstate.params, batch, 4, jkeys, jns,
        jstate.clip_bound, jkeys.key_clip,
        active=None if act is None else jnp.asarray(act))
    args = (tbatch, tkeys, tns, tstate.clip_bound, tkeys.key_clip,
            tstate.layout, tsteps.StageTimer("cpu"))
    fused, loss, _, _, bound = tsteps._fused_grads(
        ts.model, ts.run_cfg.privacy, tstate.params, args[0], 4, *args[1:],
        active=act)
    fused = flatbuf.zero_padding(tstate.layout, fused)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(bound), float(jbound), rtol=RTOL)
    want = np.asarray(jflat.pack(jflat.layout_of(jstate.params), jn))
    np.testing.assert_allclose(fused.numpy(), want, atol=NOISY_ATOL, rtol=0)

    tb, tbs = _port(weights, mesh=MeshConfig((4,), ("data",)),
                    sync_path="barrier")
    barrier, bloss, _, bns, bbound = tsteps._barrier_grads(
        tb.model, tb.run_cfg.privacy, tb.run_cfg.mesh, tbs.params, *args,
        active=act)
    barrier = flatbuf.zero_padding(tbs.layout, barrier)
    B = 8 * 0.3 * float(bbound)
    assert float(bbound) == float(bound) and float(bloss) == float(loss)
    assert (barrier - fused).abs().max() <= MASK_ATOL_PER_B * B
    assert bns.prev_key == tkeys.key_xi

    # the clipped sum plus xi_t - lam xi_{t-1} (admin_xi of both keys)
    gates = np.ones(4, bool) if act is None else act
    clipped = torch.zeros_like(fused)
    tensors = flatbuf.flat_tensors(tstate.layout,
                                   param_tree(tstate.params))
    for i in range(4):
        if not gates[i]:
            continue
        b = {k: v[4 * i:4 * (i + 1)] for k, v in tbatch.items()}
        g = torch.autograd.grad(ts.model.loss(tstate.params, b), tensors)
        clipped += flatbuf.pack_tensors(tstate.layout, g) * \
            clipping.clip_scale(clipping.global_norm(g), bound)
    tmpl = flatbuf.unpack(tstate.layout, torch.zeros_like(fused))
    sc = 0.3 * bound
    xi = flatbuf.pack(tstate.layout, masking.admin_xi(tkeys.key_xi, tmpl, sc))
    xp = flatbuf.pack(tstate.layout, masking.admin_xi(PREV, tmpl, sc))
    manual = clipped + (xi - 0.7 * xp)
    assert (fused - manual).abs().max() <= NOISY_ATOL


def test_session_train_matches_jax(weights):
    """3 steps of the fused tier under admin masks through ``Session.train``
    against JAX's: losses, bounds, norms, epsilon, the carried key and the
    weights (``tests/test_torch_training.py``'s tolerances)."""
    js, jstate = _jax(weights)
    ts, tstate = _port(weights)
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0)
    jres = js.train(state=jstate, **kw)
    before = dispatch.launch_counts()
    tres = ts.train(state=tstate, **kw)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    for tm, jm in zip(tres.metrics, jres.metrics):
        for k in ("loss", "clip_bound", "grad_norm_mean"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL)
        assert tm["epsilon"] == jm["epsilon"]
    want = np.asarray(jflat.pack(jflat.layout_of(jres.state.params),
                                 jres.state.params))
    got = tres.state.opt_state["master"].detach().numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))


# ---------------------------------------------------------------------------
# the wire tier under admin masks (MNIST-MLP3, tests/test_torch_wire.py)


@pytest.fixture(scope="module")
def mlp3():
    return jax.tree.map(np.asarray, jbuild(JMLP3).init(jax.random.PRNGKey(1)))


def _update_fn(p, update, lr):
    return {k: v - lr * torch.as_tensor(update[k], device=v.device)
            for k, v in p.items()}


def _wire_port(mlp3, lam=0.7):
    from repro_torch.models.convert import small_params_from_jax
    sm = build_small_model(MNIST_MLP3)
    params = small_params_from_jax(mlp3, "cpu")
    silos = [{"x": s.x, "y": s.y}
             for s in synthetic_mnist(n_train=128, n_test=16)[0].split(4)]
    sess = CollaborativeSession.from_silos(
        silos, PrivacyConfig(enabled=True, sigma=W_SIGMA, clip_bound=1.0,
                             noise_lambda=lam, mask_mode="admin"),
        params_template=params, device="cpu")
    return sess, params, value_and_grad(sm.loss)


def test_wire_rounds_match_jax_with_a_drop(mlp3):
    """3 serial rounds under admin masks, silo 1 out in round 1: losses,
    parameters, epsilon and participation against JAX's session."""
    ps, pp, grad_fn = _wire_port(mlp3)
    sm = jbuild(JMLP3)
    jp = jax.tree.map(jnp.asarray, mlp3)
    js = JSession.from_silos(
        [{"x": jnp.asarray(s.x), "y": jnp.asarray(s.y)}
         for s in jmnist(n_train=128, n_test=16)[0].split(4)],
        JaxPrivacy(enabled=True, sigma=W_SIGMA, clip_bound=1.0,
                   noise_lambda=0.7, mask_mode="admin"),
        params_template=jp)

    def jgrad(p, data):
        return jax.value_and_grad(sm.loss)(p, data)

    def jupdate(p, u, lr):
        return jax.tree.map(lambda a, b: a - lr * b, p, u)

    for t in range(3):
        if t == 1:
            assert ps.drop_silo(1, step=t) and js.drop_silo(1, step=t)
        if t == 2:
            ps.rejoin_silo(1, step=t)
            js.rejoin_silo(1, step=t)
        pp, pl = ps.step(t, pp, grad_fn, _update_fn, lr=W_LR)
        jp, jl = js.step(t, jp, jgrad, jupdate, lr=W_LR)
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    got = wire.pack_np(flatbuf.layout_of(pp), pp)
    want = np.asarray(jflat.pack(jflat.layout_of(jp), jp))
    assert np.abs(got - want).max() <= PARAM_ATOL
    assert ps.accountant.contributions == js.accountant.contributions == \
        [4, 3, 4]
    assert ps.epsilon() == js.epsilon()


def test_wire_contributions_equal_fused_and_closing_row_bit_identical(mlp3):
    """A round's contributions (each handler's own row; the closing one
    the admin's, which is the stacked set's closing row) summed in silo
    order equal the fused tier's
    ``run_central`` on the same gradients within the masks' residue, full
    and partial; the admin's row given to the closing silo is bit-equal to
    the row it draws, and two sessions, one drawing it on the admin and
    one on the handler, train bit-identically."""
    from repro_torch.distributed.steps import StageTimer

    ps, params, grad_fn = _wire_port(mlp3)
    layout = flatbuf.layout_of(params)
    pipe = DPPipeline(ps.privacy, layout, 4)
    keys = step_keys(prng.PRNGKey(3), 0)
    ns = NoiseState(PREV, True, np.ones(4, bool))
    bound = torch.tensor(1.0)
    grads = [flatbuf.pack(layout, grad_fn(params, h.data)[1])
             for h in ps.handlers]
    norms = torch.stack([clipping.global_norm(flatbuf.unpack(layout, g))
                         for g in grads])
    B = 8 * W_SIGMA
    for act in (np.ones(4, bool), np.array([True, True, True, False])):
        closing, row = pipe.admin_closing_row(params, act, keys, ns, bound)
        assert closing == int(np.flatnonzero(act)[-1])
        masks = pipe._admin_mask_set(params, act, keys, ns, bound)
        assert torch.equal(row, flatbuf.pack(layout, {
            k: m[closing] for k, m in masks.items()}))
        contribs = []
        for i in np.flatnonzero(act):
            scale = pipe.clip_scale(norms[i], bound)
            own = pipe.silo_contribution(grads[i].clone(), i, scale, act,
                                         keys, ns, bound)
            if i == closing:
                dist = pipe.silo_contribution(grads[i].clone(), i, scale,
                                              act, keys, ns, bound,
                                              admin_row=row)
                assert torch.equal(own, dist)
            contribs.append(own)
        wire_sum = reduce_contributions(contribs)
        noisy, _, _ = pipe.run_central(torch.stack(grads), norms, keys, ns,
                                       bound, keys.key_clip, act,
                                       StageTimer("cpu"))
        assert (wire_sum - noisy).abs().max() <= MASK_ATOL_PER_B * B

    own, _, _ = _wire_port(mlp3)
    own.admin.closing_mask_row = lambda *a, **kw: None  # handlers draw it
    pa = pb = params
    for t in range(2):
        pa, la = ps.step(t, pa, grad_fn, _update_fn, lr=W_LR)
        pb, lb = own.step(t, pb, grad_fn, _update_fn, lr=W_LR)
        assert la == lb
    assert np.array_equal(wire.pack_np(layout, pa), wire.pack_np(layout, pb))
