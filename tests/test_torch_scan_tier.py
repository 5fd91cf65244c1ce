"""The silo-serial scan tier (``silo_mode='scan'``: ``distributed/steps.
_fused_grads_scan``) and the windowed per-leaf noise
(``noise_correction.corrected_noise``) against the JAX package, at the
qwen2.5-3b smoke config with weights carried across by
``params_from_jax``.

* One scan step against JAX's ``_fused_grads_scan`` (the per-leaf noise
  policy, dynamic clipping stale by one step, lambda 0.7 from a primed
  state, a dropped silo): loss and norms within ``RTOL``, the new bound,
  the noisy aggregate within ``NOISY_ATOL`` (the per-leaf normals through
  ``erfinv``, ``tests/test_torch_perleaf_policy.py``), the carried key
  equal.
* Scan == vmap == wire with every silo active under the packed policy, as
  JAX's ``test_fused_scan_wire_parity_all_active``
  (``tests/test_dp_pipeline.py:103``): the three aggregates within 2e-4 of
  each other and of the clipped sum plus the engine's noise streams (the
  bound of that test; measured far below).
* The windowed noise: drawn ``WINDOW`` counters at a time (the plain
  ``normal_combine``'s windows, ``kernels/prng/ref.py``) and added in
  place, bit-equal to the whole-leaf draw of ``xi_t - lam xi_{t-1}``.
* 3 steps through ``Session.train`` on the scan tier against JAX's
  (``tests/test_torch_training.py``'s tolerances).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro.core.barrier import step_keys as jax_step_keys
from repro.core.noise_correction import NoiseState as JaxNoiseState
from repro.distributed import steps as jsteps
from repro_torch.api import Session
from repro_torch.configs.base import OptimizerConfig, PrivacyConfig
from repro_torch.core import clipping, flatbuf, noise_correction, prng
from repro_torch.core.barrier import step_keys
from repro_torch.core.dp_pipeline import DPPipeline, reduce_contributions
from repro_torch.core.noise_correction import NoiseState
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.kernels.prng import ref as prng_ref
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.packing import param_tree

ARCH = "qwen2.5-3b"
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4, silo_mode="scan")
RTOL, NOISY_ATOL, PARAM_ATOL = 1e-5, 4e-6, 1e-5
PARITY_ATOL = 2e-4
PREV = (4086990474, 1067026239)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    model = transformer.init(torch.Generator().manual_seed(0),
                             Session.from_config(ARCH, device="cpu").cfg,
                             "cpu")
    return params_to_numpy(model)


def _sessions(weights, **priv):
    kw = {**QUICKSTART, **priv}
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**kw),
                                optimizer=JaxOptimizer(name="adamw", lr=1e-3))
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, weights))
    jstate = jsteps.init_train_state(jmodel, js.run_cfg,
                                     jax.random.PRNGKey(0))
    ts = Session.from_config(ARCH, privacy=PrivacyConfig(**kw),
                             optimizer=OptimizerConfig(name="adamw", lr=1e-3),
                             device="cpu")
    tstate = ts.init_state(params=params_from_jax(weights, ts.cfg, "cpu"))
    batch = js.synthetic_batches(16, 16)()
    tbatch = {k: torch.as_tensor(np.array(v), dtype=torch.long)
              for k, v in batch.items()}
    return js, jstate, batch, ts, tstate, tbatch


@pytest.mark.parametrize("active", [None, [True, True, False, True]])
def test_scan_step_matches_jax(weights, active):
    js, jstate, batch, ts, tstate, tbatch = _sessions(
        weights, clip_percentile_max=8.0)
    act = None if active is None else np.asarray(active)
    jkeys = jax_step_keys(jax.random.PRNGKey(1), 0)
    tkeys = step_keys(prng.PRNGKey(1), 0)
    jns = JaxNoiseState(jnp.asarray(PREV, jnp.uint32), jnp.asarray(True),
                        jnp.ones(4, bool))
    tns = NoiseState(PREV, True, np.ones(4, bool))
    jn, jloss, jnorms, jnew, jbound = jsteps._fused_grads_scan(
        js.model, js.run_cfg.privacy, jstate.params, batch, 4, jkeys, jns,
        jstate.clip_bound, jkeys.key_clip,
        active=None if act is None else jnp.asarray(act))
    timer = tsteps.StageTimer("cpu")
    before = dispatch.launch_counts()
    tn, tloss, tnorms, tnew, tbound = tsteps._fused_grads_scan(
        ts.model, ts.run_cfg.privacy, tstate.params, tbatch, 4, tkeys, tns,
        tstate.clip_bound, tkeys.key_clip, tstate.layout, timer, active=act)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    assert set(timer.ms()) == {"silo_grads", "norms", "accumulate", "noise"}
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms), rtol=RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(tbound), float(jbound), rtol=RTOL)
    assert float(tbound) < 8.0  # the percentile protocol, not the cap
    want = np.asarray(jflat.pack(jflat.layout_of(jstate.params), jn))
    got = flatbuf.zero_padding(tstate.layout, tn).numpy()
    np.testing.assert_allclose(got, want, atol=NOISY_ATOL, rtol=0)
    assert tnew.prev_key == tuple(int(x) for x in np.asarray(jnew.prev_key))


def test_scan_equals_vmap_equals_wire_all_active(weights):
    """The packed engine on all three tiers: the same aggregate."""
    _, _, _, ts, tstate, tbatch = _sessions(weights, dynamic_clip=False,
                                            noise_lambda=0.0)
    priv, layout, params = ts.run_cfg.privacy, tstate.layout, tstate.params
    keys = step_keys(prng.PRNGKey(9), 0)
    ns = noise_correction.init_state(prng.PRNGKey(0), n_silos=4)
    c = torch.tensor(1.0)
    args = (keys, ns, c, keys.key_clip, layout, tsteps.StageTimer("cpu"))
    fused = tsteps._fused_grads(ts.model, priv, params, tbatch, 4, *args)[0]
    with dispatch.force_impl("packed", kernel="dp_noise_tree"):
        scan, loss_s = tsteps._fused_grads_scan(ts.model, priv, params,
                                                tbatch, 4, *args)[:2]
    pipe = DPPipeline(priv, layout, 4)
    tensors = flatbuf.flat_tensors(layout, param_tree(params))
    contribs, clipped = [], torch.zeros(layout.total)
    for i in range(4):
        b = {k: v[4 * i:4 * (i + 1)] for k, v in tbatch.items()}
        g = torch.autograd.grad(ts.model.loss(params, b), tensors)
        scale = pipe.clip_scale(pipe.norm_tree(g), c)
        packed = flatbuf.pack_tensors(layout, g)
        clipped += packed * clipping.clip_scale(clipping.global_norm(g), c)
        contribs.append(pipe.silo_contribution(packed, i, scale, None, keys,
                                               ns, c))
    wire = reduce_contributions(contribs)
    manual = pipe.corrected_noise_packed(clipped, keys, ns, c, None)
    for a, b in ((fused, manual), (scan, manual), (wire, manual),
                 (fused, wire)):
        assert (flatbuf.zero_padding(layout, a.clone())
                - flatbuf.zero_padding(layout, b.clone())).abs().max() \
            < PARITY_ATOL
    assert np.isfinite(float(loss_s))


@pytest.mark.parametrize("has_prev,lam", [(True, 0.7), (False, 0.7),
                                          (True, 0.0)])
def test_windowed_noise_equals_whole_leaf_draw(has_prev, lam, monkeypatch):
    rng = np.random.default_rng(0)
    shapes = {"a": (1000,), "b": (3, 77), "e": [(5, 60)] * 3}
    tree = {k: [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in v] if isinstance(v, list) else
            torch.from_numpy(rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}
    layout = flatbuf.layout_of(tree)
    want = flatbuf.pack(layout, tree)
    sc = torch.tensor(1.2)
    kt, kp = prng.split((3, 4), layout.n_leaves), prng.split(PREV,
                                                             layout.n_leaves)
    gate = torch.tensor(lam if has_prev else 0.0)
    for i, (shape, off) in enumerate(zip(layout.shapes, layout.offsets)):
        n = int(np.prod(shape))
        z = prng.normal(kt[i], shape).reshape(-1) * sc
        if lam:
            z = z - gate * (prng.normal(kp[i], shape).reshape(-1) * sc)
        want[off:off + n] += z
    monkeypatch.setattr(prng_ref, "WINDOW", 64)
    got, st = noise_correction.corrected_noise(
        tree, (3, 4), NoiseState(PREV, has_prev), sc, lam)
    assert got is tree and st.prev_key == (3, 4) and st.has_prev
    assert torch.equal(flatbuf.pack(layout, got), want)


def test_session_train_matches_jax(weights):
    js, jstate, _, ts, tstate, _ = _sessions(weights)
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0)
    jres = js.train(state=jstate, **kw)
    tres = ts.train(state=tstate, **kw)
    assert tres.step == jres.step == 3
    assert [sorted(st) for st in tres.trainer.stage_log] == 3 * [sorted(
        ("silo_grads", "norms", "accumulate", "noise", "optimizer"))]
    for tm, jm in zip(tres.metrics, jres.metrics):
        for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL)
        assert tm["epsilon"] == jm["epsilon"]
    want = np.asarray(jflat.pack(jflat.layout_of(jres.state.params),
                                 jres.state.params))
    got = tres.state.opt_state["master"].detach().numpy()
    assert np.abs(got - want).max() <= PARAM_ATOL
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))
