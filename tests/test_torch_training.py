"""The training slice as a whole: the port's fused DP tier against the JAX
package at the qwen2.5-3b smoke config with the quickstart's privacy
settings (4 silos, sigma 0.3, dynamic clipping, lambda 0.7) and AdamW lr
1e-3, the JAX weights carried across by ``params_from_jax``.

Tolerances, each with what was measured on this CPU:
* loss, gradient norms and clip bound: fp32 products in another order
  (measured max 1.2e-7 relative); held to 1e-5 relative;
* the packed noisy gradient: that, plus libm's ``log`` in the noise
  (measured max 1.2e-6 on values up to 5.5); held to 4e-6;
* parameters: AdamW moves each weight by lr * m / (sqrt(v) + eps), so ulp
  differences in the gradient stay small unless the moment cancels across
  steps or g flips sign near 0, which moves a weight by up to 2 lr
  (measured max 2.0e-6 after 3 steps, one element past 1e-6, no flip);
  held to 1e-5;
* epsilon: the same closed-form ledger, equal.
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
from repro.distributed import steps as jsteps
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro_torch.api import Session
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                      PrivacyConfig)
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2.5-3b"
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4)
LR = 1e-3
RTOL = 1e-5
NOISY_ATOL = 4e-6
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """Random smoke weights (the port's init, seed 0) as the JAX package's
    numpy tree: both packages start every test from a copy."""
    model = transformer.init(torch.Generator().manual_seed(0),
                             get_smoke_config(ARCH), "cpu")
    return params_to_numpy(model)


def _sessions(weights, **priv):
    """(JAX session, port session, JAX TrainState, port TrainState) from
    the same weights; each package's ``init_train_state`` builds the rest
    (optimizer state, the noise state from fold_in(PRNGKey(0), 0xD0))."""
    kw = {**QUICKSTART, **priv}
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**kw),
                                optimizer=JaxOptimizer(name="adamw", lr=LR))
    ts = Session.from_config(ARCH, privacy=PrivacyConfig(**kw),
                             optimizer=OptimizerConfig(name="adamw", lr=LR),
                             device="cpu")
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, weights))
    jstate = jsteps.init_train_state(jmodel, js.run_cfg,
                                     jax.random.PRNGKey(0))
    tparams = params_from_jax(weights, ts.cfg, "cpu")
    return js, ts, jstate, ts.init_state(params=tparams)


def _master_vs_jax(tstate, jparams):
    want = np.asarray(jflat.pack(jflat.layout_of(jparams), jparams))
    return np.abs(tstate.opt_state["master"].detach().numpy() - want)


def test_one_train_step_matches_jax(weights):
    """One train step on the same batch: the JAX package's per-silo grads
    and DP engine (``_fused_grads``) and its AdamW update against the port's
    ``_fused_grads`` and ``build_train_step``, with the cap raised so the
    bound is the percentile protocol's noisy median."""
    js, ts, jstate, tstate = _sessions(weights, clip_percentile_max=8.0)
    batch = js.synthetic_batches(16, 16)()
    tbatch = {k: torch.as_tensor(np.array(v), dtype=torch.long)
              for k, v in batch.items()}
    jkeys = jax_step_keys(jax.random.PRNGKey(1), 0)
    tkeys = step_keys(prng.PRNGKey(1), 0)
    jn, jloss, jnorms, jns, jbound = jax.jit(
        lambda p, b, ns, c: jsteps._fused_grads(
            js.model, js.run_cfg.privacy, p, b, 4, jkeys, ns, c,
            jkeys.key_clip))(jstate.params, batch, jstate.noise_state,
                             jstate.clip_bound)
    tn, tloss, tnorms, tns, tbound = tsteps._fused_grads(
        ts.model, ts.run_cfg.privacy, tstate.params, tbatch, 4, tkeys,
        tstate.noise_state, tstate.clip_bound, tkeys.key_clip, tstate.layout,
        tsteps.StageTimer("cpu"))
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms), rtol=RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(tbound), float(jbound), rtol=RTOL)
    assert float(tbound) < 8.0  # the percentile protocol, not the cap
    want = np.asarray(jflat.pack(jflat.layout_of(jstate.params), jn))
    got = flatbuf.zero_padding(tstate.layout, tn).numpy()
    np.testing.assert_allclose(got, want, atol=NOISY_ATOL, rtol=0)
    assert tns.prev_key == tuple(int(x) for x in np.asarray(jns.prev_key))

    # the JAX step's update: AdamW on the aggregate over its 4 contributors
    jopt = jax_make_optimizer(js.run_cfg.optimizer)
    jnew, _ = jax.jit(jopt.update)(jstate.params, jstate.opt_state,
                                   jax.tree.map(lambda g: g / 4.0, jn),
                                   jnp.asarray(LR, jnp.float32))
    tnew, tm = tsteps.build_train_step(ts.model, ts.run_cfg)(
        tstate, tbatch, prng.PRNGKey(1), timer=tsteps.StageTimer("cpu"))
    np.testing.assert_allclose(tm["loss"], float(jloss), rtol=RTOL)
    np.testing.assert_allclose(tm["clip_bound"], float(jbound), rtol=RTOL)
    np.testing.assert_allclose(tm["grad_norm_mean"],
                               float(np.mean(np.asarray(jnorms))), rtol=RTOL)
    assert _master_vs_jax(tnew, jnew).max() <= PARAM_ATOL
    assert tnew.step == 1


def _drop_silo_2_at_step_1(step):
    return [True, True, step != 1, True]


@pytest.mark.parametrize("schedule", [None, _drop_silo_2_at_step_1])
def test_session_train_matches_jax(weights, schedule):
    js, ts, jstate, tstate = _sessions(weights)
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0,
              silo_schedule=schedule)
    jres = js.train(state=jstate, **kw)
    before = dispatch.launch_counts()
    tres = ts.train(state=tstate, **kw)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    assert tres.step == jres.step == 3
    assert [sorted(st) for st in tres.trainer.stage_log] == 3 * [sorted(
        ("silo_grads", "pack", "norms", "aggregate", "noise", "optimizer"))]
    for tm, jm in zip(tres.metrics, jres.metrics):
        for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL)
        assert tm["epsilon"] == jm["epsilon"]
        assert tm["epsilon_per_silo"] == jm["epsilon_per_silo"]
    assert _master_vs_jax(tres.state, jres.state.params).max() <= PARAM_ATOL
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))
    assert ts.privacy_report() == js.privacy_report()
    # the trained weights serve: the params are views of the master buffer
    gen = ts.serve(batch_size=2, prompt_len=4, max_new_tokens=2,
                   params=tres.state.params)
    assert gen.tokens.shape == (2, 2)


def test_train_raises_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session.from_config(ARCH, privacy=PrivacyConfig(**QUICKSTART)).train(
            steps=1)
    Session.from_config(ARCH, privacy=PrivacyConfig(**QUICKSTART),
                        device="cpu")


@pytest.mark.parametrize("priv,train_kw", [
    (dict(sync_path="barrier", mask_mode="admin"), {}),
    (dict(silo_mode="scan"), {}),
    (dict(mask_mode="admin"), {}),
    ({}, dict(checkpoint_dir="unused")),
    ({}, dict(elastic=True)),
    ({}, dict(silo_epsilon_budget=1.0)),
    ({}, dict(step_deadline_s=1.0)),
])
def test_unported_training_paths_raise(priv, train_kw, tmp_path):
    """Each trainer option that once raised trains a step through
    ``Session.train``, launching no kernel on the CPU, to a finite loss:
    admin masks on both tiers and the silo-serial scan tier (ROADMAP item
    9), and ``checkpoint_dir`` (then a resume), ``elastic``,
    ``silo_epsilon_budget`` and ``step_deadline_s`` (item 10)."""
    if "checkpoint_dir" in train_kw:
        train_kw = {**train_kw,
                    "checkpoint_dir": str(tmp_path / train_kw["checkpoint_dir"])}
    sess = Session.from_config(ARCH, device="cpu", privacy=PrivacyConfig(
        **{**QUICKSTART, **priv}),
        mesh=MeshConfig((4,), ("data",)) if priv.get("sync_path") else None)
    before = dispatch.launch_counts()
    res = sess.train(steps=1, batch_size=4, seq_len=8, **train_kw)
    assert res.step == 1 and np.isfinite(res.final["loss"])
    assert res.final["n_contributions"] == 4
    assert dispatch.launch_counts() == before
    if "silo_epsilon_budget" in train_kw:
        assert res.trainer.accountant.exhausted() == [0, 1, 2, 3]
    if "checkpoint_dir" in train_kw:
        again = sess.train(steps=2, batch_size=4, seq_len=8, **train_kw)
        assert again.trainer.restored_step == 1 and again.step == 2
        assert [m["step"] for m in again.metrics] == [0, 1]


def test_privacy_off_trains_without_a_ledger():
    sess = Session.from_config(ARCH, device="cpu")
    res = sess.train(steps=2, batch_size=4, seq_len=8, log_every=0)
    assert "epsilon" not in res.final and sess.privacy_report() is None
    assert np.isfinite(res.final["loss"])
