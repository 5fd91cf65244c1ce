"""Training in bf16 beyond the dense family, against the JAX package: the
MoE (phi3.5-moe-42b-a6.6b), VLM (qwen2-vl-72b), encoder (hubert-xlarge),
ssm (rwkv6-7b) and hybrid (zamba2-7b) families at their smoke configs with
the quickstart's privacy (4 silos, sigma 0.3, dynamic clipping, lambda
0.7) and AdamW lr 1e-3, on JAX's two routes:

* (A) bf16 compute over fp32 weights: ``compute_dtype=bf16`` in both
  packages;
* (B) bf16 weights over an fp32 master: the port's ``build_model(cfg,
  "cpu", param_dtype=bf16, compute_dtype=bf16)`` against JAX's
  ``build_model(cfg, param_dtype=bf16, compute_dtype=bf16)``. JAX keeps
  some leaves fp32 there (the MoE router, rwkv6's ``w_base`` and
  ``u_bonus``, mamba2's ``A_log``, ``D`` and ``dt_bias``): the trees of
  the MoE, ssm and hybrid families are mixed, and so are the port's
  (``models/packing.pack_train_params``).

Both packages start from the same numpy weights (the port's init, each leaf
in the dtype JAX's init gives it) and batches (tokens, or frontend
``embeds`` with distinct M-RoPE ids for qwen2-vl). Each family and route:
one fused step (``_fused_grads`` and AdamW), 3 steps through
``Session.train`` with silo 2 out at the second, and a scan-tier step under
JAX's dry-run privacy; a barrier step with a dropped silo against JAX's
``_barrier_grads`` on a 4-device host mesh in a subprocess for phi3.5-moe
and zamba2-7b; MoE routing in bf16 bit-equal (ties lower index first, at a
capacity that drops); the mixed layout against JAX's with the bf16 leaves
the rounded master and the fp32 leaves the master's views; a mixed
checkpoint both ways and a route (B) Trainer resuming bit for bit. The
small models keep their fp32-only refusal.

The port's training forward follows XLA's order in bf16, as the dense
family's (``tests/test_torch_bf16_training.py``): the second norm of a
block reads the unrounded fp32 residual sum (rwkv6's blocks, zamba2's
shared block), and the SiLUs and rwkv6's channel-mix logistic round after
each op (``layers.XlaSilu`` / ``XlaSigmoid``; the MoE experts', rwkv6's
time mix, mamba2's conv and gate); mamba2's gated norm widens the
unrounded product ``y * silu(z)``. With these the forward of each layer is
bit-equal to JAX's on the same input. Where the two still part is where
the dense family parts: a bf16 product's fp32 sum in another order rounds
to the other neighbour now and then, and the flip travels on.

Tolerances, PR 32's (``test_torch_bf16_training.py``) where they hold,
each with the largest value measured on this CPU over the cases here:

* the loss at the first step ``LOSS_RTOL`` 1e-4 (measured 3.9e-5, rwkv6;
  2.8e-5 zamba2, 1.9e-5 qwen2-vl, 8.2e-6 phi3.5-moe and hubert): PR 32's
  2e-5 does not hold for rwkv6 and zamba2, whose scans' bf16 projections
  and routing (the MoE router's fp32 logits, summed in another order than
  XLA's, move a gate by an ulp) add roundings that flip;
  ``LOSS_TRAIN_RTOL`` 1e-3 after updates (measured 2.0e-4, phi3.5-moe);
* silo norms and the bound ``NORM_RTOL`` 1e-3 (measured 8.5e-4, zamba2);
  rwkv6's ``RWKV_NORM_RTOL`` 1e-2 (measured 4.3e-3): at position 0 its
  group norm sees a rank-one head (``(r . u . k) v_0``; all zero at
  init, where u is 0), whose gradient is amplified up to ``1 /
  sqrt(eps)``, so a bf16 rounding that flips upstream moves the norm
  further than in any other family; the MoE bound after an update
  ``MOE_BOUND_TRAIN_RTOL`` 1e-2 (measured 3.2e-3);
* the noisy aggregate ``NOISY_ATOL`` 2e-2 absolute on values up to about 6
  (measured 7.0e-3, rwkv6);
* the master after AdamW ``PARAM_ATOL`` 2.5 lr and at most ``FLIP_SHARE``
  1% of the weights past lr / 10 (measured 2.0e-3 and 4.6e-5);
* the barrier aggregate: the masks carry +-B*r terms up to about 10 B that
  cancel in the sum, a few fp32 ulps of 10 B off (``NOISY_ATOL`` holds);
* keys, participation sets, epsilon, MoE routing: bit-equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.api import Session
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                      PrivacyConfig)
from repro_torch.configs.paper_models import MNIST_MLP3
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.synthetic import ArrayDataset, synthetic_tokens
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.models import moe, packing, small
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import Model, build_model
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
PHI, VL, HUBERT = "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "hubert-xlarge"
RWKV, ZAMBA = "rwkv6-7b", "zamba2-7b"
ARCHS = (PHI, VL, HUBERT, RWKV, ZAMBA)
CASES = [(a, r) for a in ARCHS for r in ("A", "B")]
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4, clip_percentile_max=8.0)
DRYRUN = dict(enabled=True, sigma=1.0, clip_mode="per_silo",
              silo_mode="scan", n_silos=4)
LR = 1e-3
BF16 = torch.bfloat16
LOSS_RTOL = 1e-4
LOSS_TRAIN_RTOL = 1e-3
NORM_RTOL = 1e-3
RWKV_NORM_RTOL = 1e-2
MOE_BOUND_TRAIN_RTOL = 1e-2
NOISY_ATOL = 2e-2
PARAM_ATOL = 2.5 * LR
FLIP_SHARE = 0.01
ACTIVE = np.array([True, True, False, True])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api import Session as JaxSession
    from repro.checkpoint import checkpointer as jckpt
    from repro.configs.base import OptimizerConfig as JaxOptimizer
    from repro.configs.base import PrivacyConfig as JaxPrivacy
    from repro.core import flatbuf as jflat
    from repro.core.barrier import step_keys as jax_step_keys
    from repro.distributed import steps as jsteps
    from repro.models import moe as jmoe
    from repro.models.registry import build_model as jax_build_model
    from repro.optim.optimizers import make_optimizer as jax_make_optimizer
    return SimpleNamespace(
        jax=jax, jnp=jnp, Session=JaxSession, ckpt=jckpt,
        Optimizer=JaxOptimizer, Privacy=JaxPrivacy, flat=jflat,
        step_keys=jax_step_keys, steps=jsteps, moe=jmoe,
        build_model=jax_build_model, make_optimizer=jax_make_optimizer)


def _pdtype(route):
    return BF16 if route == "B" else torch.float32


@pytest.fixture(scope="module")
def weights():
    """(arch, route) -> the numpy tree both packages start from: the port's
    random smoke weights (seed 0) under the route's parameter dtype, bf16
    leaves as exact fp32 arrays."""
    return {(a, r): params_to_numpy(build_model(
        get_smoke_config(a), "cpu", param_dtype=_pdtype(r))
        .init(torch.Generator().manual_seed(0))) for a, r in CASES}


def _kind(arch):
    return "embeds" if get_smoke_config(arch).family in ("vlm", "encoder") \
        else "tokens"


def _positions(B, S, rng):
    """Distinct (3, B, S) M-RoPE ids (t, h, w)."""
    t = np.broadcast_to(np.arange(S), (B, S))
    h = rng.integers(0, 5, (B, S)) + np.arange(S) // 4
    w = rng.integers(0, 7, (B, S)) + 2 * (np.arange(S) % 4)
    return np.stack([t, h, w]).astype(np.int32)


def _batch(arch, seed, B=16, S=16):
    """numpy batch of ``arch``'s kind: tokens and labels, or frontend
    embeds and labels (with M-RoPE ids for qwen2-vl)."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if _kind(arch) == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32), "labels": labels}
    out = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32), "labels": labels}
    if cfg.mrope:
        out["positions"] = _positions(B, S, rng)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _streams(jx, arch):
    """Two next_batch streams of the same numpy draws: JAX's and the
    port's."""
    js, ts = iter(range(100, 200)), iter(range(100, 200))
    return (lambda: jx.jax.tree.map(jx.jnp.asarray, _batch(arch, next(js))),
            lambda: _torch(_batch(arch, next(ts))))


def _jax_params(jx, arch, route, tree):
    """The numpy tree as JAX's route ``route`` model holds it: each leaf
    in the dtype JAX's init gives it (mixed under route B)."""
    jnp = jx.jnp
    jm = jx.build_model(jx.Session.from_config(arch).cfg,
                        param_dtype=jnp.bfloat16 if route == "B"
                        else jnp.float32, compute_dtype=jnp.bfloat16)
    shapes = jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0))
    return jm, jx.jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree,
                               shapes)


def _port_session(arch, route, mesh=None, **priv):
    ts = Session.from_config(
        arch, device="cpu", compute_dtype=BF16,
        privacy=PrivacyConfig(**{**QUICKSTART, **priv}),
        optimizer=OptimizerConfig(name="adamw", lr=LR), mesh=mesh)
    if route == "B":
        ts = dataclasses.replace(ts, model=build_model(
            ts.cfg, "cpu", param_dtype=BF16, compute_dtype=BF16))
    return ts


def _sessions(jx, weights, arch, route, **priv):
    """(JAX session, port session, JAX TrainState, port TrainState) from
    the same weights under ``route``."""
    kw = {**QUICKSTART, **priv}
    js = jx.Session.from_config(arch, privacy=jx.Privacy(**kw),
                                optimizer=jx.Optimizer(name="adamw", lr=LR),
                                compute_dtype=jx.jnp.bfloat16)
    jm, jparams = _jax_params(jx, arch, route, weights[arch, route])
    js = dataclasses.replace(js, model=dataclasses.replace(
        jm, init=lambda key: jparams))
    jstate = jx.steps.init_train_state(js.model, js.run_cfg,
                                       jx.jax.random.PRNGKey(0))
    ts = _port_session(arch, route, **priv)
    tparams = params_from_jax(weights[arch, route], ts.cfg, "cpu",
                              dtype=_pdtype(route))
    return js, ts, jstate, ts.init_state(params=tparams)


def _jax_packed(jx, tree):
    return np.asarray(jx.flat.pack(jx.flat.layout_of(tree), tree))


def _norm_rtol(arch):
    return RWKV_NORM_RTOL if arch == RWKV else NORM_RTOL


def _weights_hold(state):
    """Route (B)'s invariants: the bf16 weights are the fp32 master rounded
    to nearest even over the bf16 leaves, bit for bit; each bf16 parameter
    views the bf16 buffer and each fp32 parameter the master."""
    w, m = state.weights, state.opt_state["master"]
    assert w is not None and w.dtype == BF16
    for a, z in flatbuf.dtype_runs(state.layout, "bfloat16"):
        assert torch.equal(w[a:z].view(torch.int16),
                           m[a:z].to(BF16).view(torch.int16))
    tensors = flatbuf.flat_tensors(state.layout,
                                   packing.param_tree(state.params))
    for t in tensors:
        buf = w if t.dtype == BF16 else m
        assert t.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()


def _master_close(tstate, want):
    diff = np.abs(tstate.opt_state["master"].numpy() - want)
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff > LR / 10) <= FLIP_SHARE, np.mean(diff > LR / 10)


def _hold_step(arch, tnorms, jnorms, tloss, jloss, tbound, jbound, got,
               want):
    """A step's silo norms, loss, bound and noisy aggregate against JAX's
    at ``arch``'s tolerances."""
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms),
                               rtol=_norm_rtol(arch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tbound), float(jbound),
                               rtol=_norm_rtol(arch))
    np.testing.assert_allclose(got, want, atol=NOISY_ATOL, rtol=0)


def _drop_silo_2_at_step_1(step):
    return [True, True, step != 1, True]


# ---------------------------------------------------------------------------
# the tiers


@pytest.mark.parametrize("arch,route", CASES)
def test_fused_step_matches_jax(jx, weights, arch, route):
    """One fused step: JAX's ``_fused_grads`` and AdamW against the port's
    ``_fused_grads`` and ``build_train_step``; under route (B) the bf16
    weights are the rounded master after it, and JAX's mixed tree's fp32
    leaves are the port's fp32 leaves, views of the master."""
    jnp, jax = jx.jnp, jx.jax
    js, ts, jstate, tstate = _sessions(jx, weights, arch, route)
    assert tstate.layout.dtypes == tuple(
        np.dtype(leaf.dtype).name for leaf in jax.tree.leaves(jstate.params))
    assert (tstate.weights is None) == (route == "A")
    np.testing.assert_array_equal(tstate.opt_state["master"].numpy(),
                                  _jax_packed(jx, jstate.opt_state["master"]))
    batch = _batch(arch, 1)
    tbatch = _torch(batch)
    jkeys = jx.step_keys(jax.random.PRNGKey(1), 0)
    tkeys = step_keys(prng.PRNGKey(1), 0)
    jn, jloss, jnorms, jns, jbound = jax.jit(
        lambda p, b, ns, c: jx.steps._fused_grads(
            js.model, js.run_cfg.privacy, p, b, 4, jkeys, ns, c,
            jkeys.key_clip))(jstate.params, batch, jstate.noise_state,
                             jstate.clip_bound)
    tn, tloss, tnorms, tns, tbound = tsteps._fused_grads(
        ts.model, ts.run_cfg.privacy, tstate.params, tbatch, 4, tkeys,
        tstate.noise_state, tstate.clip_bound, tkeys.key_clip, tstate.layout,
        tsteps.StageTimer("cpu"))
    _hold_step(arch, tnorms, jnorms, tloss, jloss, tbound, jbound,
               flatbuf.zero_padding(tstate.layout, tn).numpy(),
               _jax_packed(jx, jn))
    assert tns.prev_key == tuple(int(x) for x in np.asarray(jns.prev_key))
    jopt = jx.make_optimizer(js.run_cfg.optimizer)
    _, jopt_state = jax.jit(jopt.update)(
        jstate.params, jstate.opt_state, jax.tree.map(lambda g: g / 4.0, jn),
        jnp.asarray(LR, jnp.float32))
    before = dispatch.launch_counts()
    tnew, _ = tsteps.build_train_step(ts.model, ts.run_cfg)(
        tstate, tbatch, prng.PRNGKey(1), timer=tsteps.StageTimer("cpu"))
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    _master_close(tnew, _jax_packed(jx, jopt_state["master"]))
    if route == "B":
        _weights_hold(tnew)


@pytest.mark.parametrize("arch,route", CASES)
def test_session_train_matches_jax(jx, weights, arch, route):
    """3 steps through ``Session.train``, silo 2 out at the second: losses,
    bounds, contributions, epsilon, the carried key and the master."""
    js, ts, jstate, tstate = _sessions(jx, weights, arch, route)
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0,
              silo_schedule=_drop_silo_2_at_step_1)
    jkw, tkw = dict(kw), dict(kw)
    if _kind(arch) == "embeds":
        jkw["next_batch"], tkw["next_batch"] = _streams(jx, arch)
    jres = js.train(state=jstate, **jkw)
    tres = ts.train(state=tstate, **tkw)
    assert tres.step == jres.step == 3
    for t, (tm, jm) in enumerate(zip(tres.metrics, jres.metrics)):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL
                                   if t == 0 else LOSS_TRAIN_RTOL)
        # after an update the MoE family's norms come from weights where a
        # flipped gradient sign moved a router logit
        np.testing.assert_allclose(tm["clip_bound"], jm["clip_bound"], rtol=(
            MOE_BOUND_TRAIN_RTOL if t and get_smoke_config(arch).is_moe()
            else _norm_rtol(arch)))
        assert tm["n_contributions"] == jm["n_contributions"]
        assert tm["epsilon"] == jm["epsilon"]
    assert [m["n_contributions"] for m in tres.metrics] == [4.0, 3.0, 4.0]
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))
    _master_close(tres.state, _jax_packed(jx, jres.state.opt_state["master"]))
    if route == "B":
        _weights_hold(tres.state)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_step_matches_jax(jx, weights, arch):
    """JAX's dry run: bf16 weights (``launch/dryrun.py:91``, route B) on
    the silo-serial tier with ``per_silo`` clipping, each bf16 gradient
    widened into the fp32 accumulator, a dropped silo."""
    route = "B"
    jnp, jax = jx.jnp, jx.jax
    js, ts, jstate, tstate = _sessions(jx, weights, arch, route, **DRYRUN)
    batch = _batch(arch, 2)
    jkeys = jx.step_keys(jax.random.PRNGKey(1), 0)
    tkeys = step_keys(prng.PRNGKey(1), 0)
    jn, jloss, jnorms, jns, jbound = jx.steps._fused_grads_scan(
        js.model, js.run_cfg.privacy, jstate.params,
        jax.tree.map(jnp.asarray, batch), 4, jkeys, jstate.noise_state,
        jstate.clip_bound, jkeys.key_clip, active=jnp.asarray(ACTIVE))
    tn, tloss, tnorms, tns, tbound = tsteps._fused_grads_scan(
        ts.model, ts.run_cfg.privacy, tstate.params, _torch(batch), 4, tkeys,
        tstate.noise_state, tstate.clip_bound, tkeys.key_clip, tstate.layout,
        tsteps.StageTimer("cpu"), active=ACTIVE)
    _hold_step(arch, tnorms, jnorms, tloss, jloss, tbound, jbound,
               flatbuf.zero_padding(tstate.layout, tn).numpy(),
               _jax_packed(jx, jn))
    assert tns.prev_key == tuple(int(x) for x in np.asarray(jns.prev_key))
    np.testing.assert_array_equal(tns.prev_active,
                                  np.asarray(jns.prev_active))


JAX_BARRIER = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import Session
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro.core import flatbuf
from repro.core.barrier import step_keys
from repro.distributed import steps
from repro.models.registry import build_model

arch = sys.argv[3]
z = np.load(sys.argv[1])
priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                     dynamic_clip=True, noise_lambda=0.7, sync_path="barrier",
                     clip_percentile_max=8.0)
mesh_cfg = MeshConfig((4,), ("data",))
sess = Session.from_config(arch, privacy=priv, mesh=mesh_cfg,
                           optimizer=OptimizerConfig(name="adamw", lr=1e-3))
model = build_model(sess.cfg, param_dtype=jnp.bfloat16,
                    compute_dtype=jnp.bfloat16)
shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
weights = {}
for k in z.files:
    if k.startswith("w/"):
        node, snode = weights, shapes
        *parents, name = k[2:].split("/")
        for p in parents:
            node, snode = node.setdefault(p, {}), snode[p]
        node[name] = jnp.asarray(z[k], snode[name].dtype)
model = dataclasses.replace(model, init=lambda key: weights)
sess = dataclasses.replace(sess, model=model)
state = steps.init_train_state(model, sess.run_cfg, jax.random.PRNGKey(0))
layout = flatbuf.layout_of(state.params)
mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
keys = step_keys(jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
batch = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("b/")}
with set_mesh(mesh):
    agg, loss, norms, new_ns, bound = jax.jit(
        lambda p, b, a, ns, c: steps._barrier_grads(
            model, priv, mesh_cfg, p, b, keys, ns, c, keys.key_clip, mesh,
            active=a))(state.params, batch, jnp.asarray(z["active"]),
                       state.noise_state, state.clip_bound)
np.savez(sys.argv[2], agg=np.asarray(flatbuf.pack(layout, agg)),
         loss=np.asarray(loss), norms=np.asarray(norms).reshape(-1),
         bound=np.asarray(bound), prev_key=np.asarray(new_ns.prev_key),
         prev_active=np.asarray(new_ns.prev_active))
print("OK")
"""


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                   else {f"{prefix}/{k}": v})
    return out


def jax_subprocess(script, args, timeout=300):
    """``script`` on JAX's 4-device host mesh in a subprocess, one thread."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"


@pytest.mark.parametrize("arch", [PHI, ZAMBA])
def test_barrier_step_with_a_drop_matches_jax(weights, tmp_path, arch):
    """Route (B) on the barrier tier, silo 2 dropped, a mixed tree: the
    port's ``_barrier_grads`` against JAX's under ``shard_map``."""
    pytest.importorskip("jax")
    batch = _batch(arch, 3)
    np.savez(tmp_path / "in.npz", active=ACTIVE,
             **_flat(weights[arch, "B"], "w"),
             **{f"b/{k}": v for k, v in batch.items()})
    jax_subprocess(JAX_BARRIER, (tmp_path / "in.npz", tmp_path / "out.npz",
                                 arch))
    want = dict(np.load(tmp_path / "out.npz"))
    ts = _port_session(arch, "B", mesh=MeshConfig((4,), ("data",)),
                       sync_path="barrier")
    state = ts.init_state(params=params_from_jax(weights[arch, "B"], ts.cfg,
                                                 "cpu", dtype=BF16))
    assert set(state.layout.dtypes) == {"float32", "bfloat16"}
    keys = step_keys(prng.PRNGKey(1), 0)
    agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
        ts.model, ts.run_cfg.privacy, ts.run_cfg.mesh, state.params,
        _torch(batch), keys, state.noise_state, state.clip_bound,
        keys.key_clip, state.layout, tsteps.StageTimer("cpu"), active=ACTIVE)
    _hold_step(arch, norms, want["norms"], loss, want["loss"], bound,
               want["bound"], flatbuf.zero_padding(state.layout, agg).numpy(),
               want["agg"])
    assert new_ns.prev_key == tuple(int(x) for x in want["prev_key"])
    np.testing.assert_array_equal(new_ns.prev_active, want["prev_active"])


# ---------------------------------------------------------------------------
# MoE routing in bf16


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_routing_bit_equal_in_bf16(jx, capacity_factor):
    """The router over bf16 activations (fp32 logits of the bf16-rounded
    tokens, JAX's ``moe.py:97``) with two pairs of identical expert
    columns, so that logits tie exactly on every token: ``idx``, ``pos``
    and ``keep`` bit-equal to JAX's (lower index first among equal
    probabilities), at the published capacity factor and at one that
    drops tokens; the gates and the layer's output too."""
    jnp, jax = jx.jnp, jx.jax
    cfg = get_smoke_config(PHI)
    E, D = cfg.n_experts, cfg.d_model
    rng = np.random.default_rng(9)
    router = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    router[:, 1] = router[:, 0]
    router[:, E - 1] = router[:, E - 2]
    xt = np.array(jnp.asarray(rng.standard_normal((64, D)), jnp.bfloat16)
                  .astype(jnp.float32))
    tx = torch.from_numpy(xt).to(BF16)
    T = xt.shape[0]
    cap = moe.capacity_of(T, cfg, capacity_factor)
    logits, gates, idx, pos, keep = moe.route(tx, torch.from_numpy(router),
                                              cfg, cap)
    jlogits = jax.jit(lambda x, r: x.astype(jnp.float32) @ r)(
        jnp.asarray(xt, jnp.bfloat16), jnp.asarray(router))
    jg, jidx = jx.moe._topk_gates(jlogits, cfg.top_k)
    jpos, jkeep = jx.moe._positions_in_expert(jidx, E, cap)
    # the ties are there, and resolved alike
    assert np.array_equal(np.asarray(jlogits)[:, 0], np.asarray(jlogits)[:, 1])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert (capacity_factor < 1.0) == (not bool(keep.all()))
    np.testing.assert_allclose(gates.numpy(), np.asarray(
        jg * jkeep.astype(jg.dtype)), rtol=1e-6, atol=1e-7)
    # the layer on those tokens, route (B)'s bf16 experts, as JAX's
    tree = params_to_numpy(build_model(cfg, "cpu", param_dtype=BF16).init(
        torch.Generator().manual_seed(4)))
    lp = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    lp["router"] = router
    layer = moe.MoE(cfg, "cpu", BF16)
    with torch.no_grad():
        for k, v in lp.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    assert layer.router.dtype == torch.float32 and layer.we_up.dtype == BF16
    out, aux = moe._moe_tokens(layer, tx, cfg, capacity_factor, train=True)
    jparams = {k: jnp.asarray(v, jnp.float32 if k == "router"
                              else jnp.bfloat16) for k, v in lp.items()}
    jout, jaux = jax.jit(lambda p, x: jx.moe._moe_tokens(
        p, x, cfg, capacity_factor))(jparams, jnp.asarray(xt, jnp.bfloat16))
    # equal but where an expert product's fp32 sum in another order rounds
    # to the other bf16 neighbour (1 element of 4096 here, one ulp)
    got, want = out.float().detach().numpy(), np.asarray(
        jout.astype(jnp.float32))
    assert np.mean(got != want) <= 1e-3
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the mixed tree: layout, checkpoints, resume


@pytest.mark.parametrize("arch", [PHI, RWKV, ZAMBA])
def test_mixed_tree_packs_in_jax_layout(jx, weights, arch):
    """Route (B)'s mixed tree: the port's layout (leaf order, dtypes,
    offsets, total) is JAX's ``layout_of`` of JAX's mixed tree; the master
    is JAX's fp32 pack of it; the bf16 buffer holds the bf16 leaves and
    zeros over the fp32 ones; each parameter views its buffer."""
    ts = _port_session(arch, "B")
    state = ts.init_state(params=params_from_jax(weights[arch, "B"], ts.cfg,
                                                 "cpu", dtype=BF16))
    _, jparams = _jax_params(jx, arch, "B", weights[arch, "B"])
    jl = jx.flat.layout_of(jparams)
    lay = state.layout
    assert (lay.dtypes, lay.offsets, lay.total) == (jl.dtypes, jl.offsets,
                                                    jl.total)
    assert {"float32", "bfloat16"} == set(lay.dtypes)
    np.testing.assert_array_equal(state.opt_state["master"].numpy(),
                                  _jax_packed(jx, jparams))
    _weights_hold(state)
    fp32 = torch.ones(lay.total, dtype=torch.bool)
    for a, z in flatbuf.dtype_runs(lay, "bfloat16"):
        fp32[a:z] = False
    assert bool((state.weights[fp32] == 0).all())
    assert len(flatbuf.dtype_runs(lay, "bfloat16")) <= lay.n_leaves


def _entries(path: Path) -> dict:
    m = json.loads((path / "manifest.json").read_text())
    return {e["path"]: e for e in m["entries"]}


def test_mixed_checkpoint_both_ways(jx, weights, tmp_path):
    """A route (B) phi3.5-moe state after one step (its router fp32, its
    experts bf16): the port's checkpoint round-trips bit for bit, its
    entries are byte for byte JAX's ``save`` of the same state (fp32
    ``.params`` leaves as fp32, bf16 ones as bf16), and JAX's checkpoint
    restores into the port."""
    jnp, jax = jx.jnp, jx.jax
    js, ts, jstate, tstate = _sessions(jx, weights, PHI, "B")
    tstate, _ = tsteps.build_train_step(ts.model, ts.run_cfg)(
        tstate, _torch(_batch(PHI, 4)), prng.PRNGKey(1),
        timer=tsteps.StageTimer("cpu"))
    checkpointer.save(tmp_path / "port", 1, tstate)
    entries = _entries(tmp_path / "port" / "step_00000001")
    assert entries[".params/layers/moe/router"]["dtype"] == "float32"
    assert entries[".params/layers/moe/we_up"]["dtype"] == "bfloat16"
    restored, _, step = checkpointer.restore(tmp_path / "port",
                                             ts.init_state())
    assert step == 1
    for k in ("master", "m", "v"):
        assert torch.equal(restored.opt_state[k], tstate.opt_state[k])
    assert torch.equal(restored.weights, tstate.weights)
    _weights_hold(restored)
    # JAX's save of the same state: the same files
    lay = tstate.layout

    def jtree(buf, dtypes):
        flat = flatbuf.unpack(lay, buf, dtype=torch.float32)
        out: dict = {}
        for path, dt in zip(lay.paths, dtypes):
            *parents, name = path.split(".")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            leaf = flat[path]
            arr = np.stack([t.numpy() for t in leaf]) \
                if isinstance(leaf, list) else leaf.numpy()
            node[name] = jnp.asarray(arr, getattr(jnp, dt))
        return out
    params_buf = tstate.opt_state["master"].clone()
    for a, z in flatbuf.dtype_runs(lay, "bfloat16"):
        params_buf[a:z] = tstate.weights[a:z].float()
    ns = tstate.noise_state
    jsame = jstate._replace(
        params=jtree(params_buf, lay.dtypes),
        opt_state={k: jtree(tstate.opt_state[k], ("float32",) * len(
            lay.paths)) for k in ("master", "m", "v")}
        | {"count": jnp.asarray(tstate.opt_state["count"], jnp.int32)},
        noise_state=jstate.noise_state._replace(
            prev_key=jnp.asarray(ns.prev_key, jnp.uint32),
            has_prev=jnp.asarray(ns.has_prev),
            prev_active=jnp.asarray(ns.prev_active)),
        step=jnp.asarray(tstate.step, jnp.int32),
        clip_bound=jnp.asarray(float(tstate.clip_bound), jnp.float32))
    jx.ckpt.save(tmp_path / "jax", 1, jsame)
    jentries = _entries(tmp_path / "jax" / "step_00000001")
    assert list(jentries) == list(entries)
    for path, e in entries.items():
        assert (e["dtype"], e["shape"], e["sha256"]) == (
            jentries[path]["dtype"], jentries[path]["shape"],
            jentries[path]["sha256"]), path
    back, _, _ = checkpointer.restore(tmp_path / "jax", ts.init_state())
    assert torch.equal(back.weights, tstate.weights)
    assert torch.equal(back.opt_state["master"], tstate.opt_state["master"])
    # JAX reads the port's fp32 entries back
    jback, _, _ = jx.ckpt.restore(tmp_path / "port",
                                  jsame._replace(params=None))
    np.testing.assert_array_equal(_jax_packed(jx, jback.opt_state["master"]),
                                  tstate.opt_state["master"].numpy())
    del jax


def test_mixed_trainer_resumes_bit_for_bit(weights, tmp_path):
    """zamba2-7b under route (B) (A_log, D, dt_bias fp32) through the
    Trainer: 2 steps checkpointed, then a resume to step 3, bit-equal to 3
    uninterrupted steps (master, moments, bf16 weights, carried key,
    losses)."""
    tokens = synthetic_tokens(32, 16, get_smoke_config(ZAMBA).vocab_size,
                              seed=5)

    def run(steps, ckpt):
        ts = _port_session(ZAMBA, "B")
        fb = FederatedBatcher(ArrayDataset(tokens[:, :-1], tokens[:, 1:])
                              .split(4), per_silo_batch=2)

        def next_batch():
            b = fb.next()
            return {"tokens": torch.as_tensor(b["x"], dtype=torch.long),
                    "labels": torch.as_tensor(b["y"], dtype=torch.long)}
        tr = Trainer(ts.model, ts.run_cfg, TrainerConfig(
            total_steps=steps, checkpoint_every=2, log_every=0,
            checkpoint_dir=ckpt), next_batch, batch_state=fb)
        state = ts.init_state(params=params_from_jax(
            weights[ZAMBA, "B"], ts.cfg, "cpu", dtype=BF16))
        state, step = tr.fit(state, prng.PRNGKey(1))
        return tr, state, step
    d = str(tmp_path / "ckpt")
    run(2, d)
    tr, resumed, step = run(3, d)
    assert tr.restored_step == 2 and step == 3
    wtr, whole, _ = run(3, None)
    for k in ("master", "m", "v"):
        assert torch.equal(resumed.opt_state[k], whole.opt_state[k]), k
    assert torch.equal(resumed.weights, whole.weights)
    _weights_hold(resumed)
    assert resumed.noise_state.prev_key == whole.noise_state.prev_key
    assert [m["loss"] for m in tr.metrics_log] == \
        [m["loss"] for m in wtr.metrics_log]


def test_small_models_train_in_fp32_only():
    """JAX's small models take no compute type (``repro/models/small.py``):
    the port's refuse bf16 weights and bf16 compute, as they always did,
    and train in fp32."""
    sm = small.build_small_model(MNIST_MLP3)
    run_cfg = Session.from_config(PHI, device="cpu",
                                  privacy=PrivacyConfig(**QUICKSTART)).run_cfg
    model = Model(cfg=None, device=torch.device("cpu"), init=sm.init,
                  loss=sm.loss, init_cache=None, prefill=None,
                  decode_step=None)
    params = {k: v.to(BF16) for k, v in sm.init(
        torch.Generator().manual_seed(0)).items()}
    with pytest.raises(NotImplementedError, match="fp32 only"):
        tsteps.init_train_state(model, run_cfg, prng.PRNGKey(0),
                                params=params)
    with pytest.raises(NotImplementedError, match="fp32 only"):
        tsteps.init_train_state(dataclasses.replace(
            model, compute_dtype=BF16), run_cfg, prng.PRNGKey(0),
            gen=torch.Generator().manual_seed(0))
    state = tsteps.init_train_state(model, run_cfg, prng.PRNGKey(0),
                                    gen=torch.Generator().manual_seed(0))
    assert state.weights is None and set(state.layout.dtypes) == {"float32"}
