"""A ``SmallModel`` (MNIST-MLP3, CIFAR10-CNN6) on the port's training path
against the JAX package's on the CPU, as JAX's own tests train one:
``Model(cfg=None, init=sm.init, loss=sm.loss, ...)``
(``tests/test_system.py``, ``tests/test_e2e_training.py``), the same
weights (a JAX tree drawn with numpy, ``small_params_from_jax``) and data
(``synthetic_cifar10`` / ``synthetic_mnist``) on both sides.

* Steps: ``build_train_step`` over 2 steps on the fused tier (packed, a
  partial set, the perleaf policy) and the scan tier (full and partial),
  CNN6 at 4 silos, sigma 0.02, dynamic clipping, lambda 0.7, momentum
  (``PRIV``, ``LR``): losses, bounds and norms within ``RTOL``, parameters within
  ``PARAM_ATOL``, the noise key bit-equal. The barrier tier
  (``_barrier_grads``, packed full and partial, perleaf) against JAX's on a
  4-device host mesh in a subprocess (as ``tests/test_torch_barrier.py``),
  the aggregate within the masks' residue, and against the port's fused
  tier. CNN6 falls over 20 steps (``test_cnn6_trains_under_barrier``).
* The Trainer: MLP3 over 6 steps against JAX's Trainer, resumed ==
  uninterrupted bit for bit, JAX's checkpoint resumed by the port and the
  port's restored by JAX; per-silo budgets, the epsilon budget and an
  escalation as JAX's (``tests/test_runtime.py``); CNN6 2 + 2 steps
  around a checkpoint == 4 steps bit for bit, and its checkpoint across
  the packages both ways (``.params/c0/w``, ``.opt_state/<k>/c0/w``).
* The wire tier: CNN6 through ``CollaborativeSession`` against JAX's for
  3 serial rounds with a drop (losses, params, epsilon, bytes on the
  wire); pipelined == speculative == serial bit for bit; both packages'
  codecs pack the flat tree alike.
"""
import contextlib
import dataclasses
import json
import shutil
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CollaborativeSession as JSession
from repro.checkpoint import checkpointer as jck
from repro.configs.base import MeshConfig as JMesh
from repro.configs.base import OptimizerConfig as JOptimizer
from repro.configs.base import PrivacyConfig as JPrivacy
from repro.configs.base import SHAPES
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.paper_models import CIFAR10_CNN6 as JCNN6
from repro.configs.paper_models import MNIST_MLP3 as JMLP3
from repro.core import flatbuf as jflat
from repro.core.tee import wire as jwire
from repro.data.pipeline import FederatedBatcher as JBatcher
from repro.data.synthetic import ArrayDataset as JArrayDataset
from repro.distributed import steps as jsteps
from repro.kernels import force_impl as jforce_impl
from repro.models import small as jsmall
from repro.models.registry import Model as JModel
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.api import CollaborativeSession
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                      PrivacyConfig, RunConfig)
from repro_torch.configs.paper_models import CIFAR10_CNN6, MNIST_MLP3
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.core.noise_correction import NoiseState
from repro_torch.core.tee import wire
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.synthetic import (ArrayDataset, synthetic_cifar10,
                                        synthetic_mnist)
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.kernels.prng import ref as prng_ref
from repro_torch.models import small
from repro_torch.models.convert import small_params_from_jax
from repro_torch.models.registry import Model
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
# losses, clip bounds and norms: fp32 forwards and backwards in other
# orders (tests/test_torch_training.py)
RTOL = 1e-5
# the parameters after 2 momentum steps: each step adds lr / 4 times the
# noisy aggregate, whose clipped sum (norm <= 4 C) carries the gradients'
# fp32 difference (1e-4 of a leaf's largest value, tests/
# test_torch_cifar_models.py) and whose noise (sigma C xi, up to about
# 1) moves with the bound's RTOL; rounded up (measured below 1e-6)
PARAM_ATOL = 1e-5
# the barrier tier's aggregate against JAX's and the fused tier's: the
# masks' fp32 residue, 8 ulps of 10 B per unit of B (test_torch_barrier.py)
AGG_ATOL_PER_B = 8 * 2.0 ** -23 * 10
# CNN6's silo gradients start at norm 8 here: a cap of 64 leaves the bound
# to the percentile protocol, and momentum at lr 0.01 keeps the loss near
# its start (at 0.1 a step of that bound makes the next loss jump)
PRIV = dict(enabled=True, sigma=0.02, clip_bound=1.0, dynamic_clip=True,
            noise_lambda=0.7, n_silos=4, clip_percentile_max=64.0)
LR = 0.01
PRIMED = dict(prev_key=(2180194710, 3380338437),
              prev_active=[True, True, False, True])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small work gains nothing from many intra-op threads, and the suite
    runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_weights(jm, seed=0) -> dict:
    """A nested JAX tree of ``jm``'s leaf shapes drawn with numpy (JAX's own
    init costs seconds on the CPU): kernels at JAX's init scale, biases at
    0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['b']"):
            x = 0.1 * rng.standard_normal(leaf.shape)
        else:
            x = rng.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def jax_model(sm, weights=None) -> JModel:
    init = sm.init if weights is None else \
        (lambda key: jax.tree.map(jnp.asarray, weights))
    return JModel(cfg=None, init=init, loss=sm.loss, init_cache=None,
                  prefill=None, decode_step=None)


def port_model(sm) -> Model:
    return Model(cfg=None, device=torch.device("cpu"), init=sm.init,
                 loss=sm.loss, init_cache=None, prefill=None,
                 decode_step=None)


def jax_rc(priv, mesh=1, opt="momentum", lr=LR) -> JRunConfig:
    return JRunConfig(model=None, shape=SHAPES["train_4k"],
                      mesh=JMesh((mesh,), ("data",)),
                      privacy=JPrivacy(**priv),
                      optimizer=JOptimizer(name=opt, lr=lr))


def port_rc(priv, mesh=1, opt="momentum", lr=LR) -> RunConfig:
    return RunConfig(model=None, mesh=MeshConfig((mesh,), ("data",)),
                     privacy=PrivacyConfig(**priv),
                     optimizer=OptimizerConfig(name=opt, lr=lr))


def _jax_packed(params) -> np.ndarray:
    return np.asarray(jflat.pack(jflat.layout_of(params), params))


def _flat_npz(tree, prefix="w") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_npz(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def cnn6():
    """CNN6's weights and two batches of 16 (4 a silo) of synthetic
    CIFAR-10, as numpy."""
    train, _ = synthetic_cifar10(64, 16, seed=7)
    batches = [{"x": train.x[16 * i:16 * (i + 1)],
                "y": train.y[16 * i:16 * (i + 1)]} for i in range(2)]
    return jax_weights(jsmall.build_small_model(JCNN6)), batches


# ---------------------------------------------------------------------------
# the train step: fused, perleaf and scan tiers


STEP_CASES = {
    "fused": ({}, None, None),
    "partial": ({}, [True, False, True, True], None),
    "perleaf": ({}, None, "perleaf"),
    "scan": ({"silo_mode": "scan"}, None, None),
    "scan_partial": ({"silo_mode": "scan"}, [True, True, False, True], None),
}


def _impl(impl, force):
    return force(impl, "dp_noise_tree") if impl else contextlib.nullcontext()


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted steps by (config, policy): a partial set is an argument
    of the same compiled step."""
    return {}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(cnn6, jax_steps, case):
    weights, batches = cnn6
    over, active, impl = STEP_CASES[case]
    priv = {**PRIV, **over}
    jm = jax_model(jsmall.build_small_model(JCNN6), weights)
    jrc = jax_rc(priv)
    jstate = jsteps.init_train_state(jm, jrc, jax.random.PRNGKey(0))
    # every silo as a set, so that one compiled step serves both cases
    jact = jnp.asarray(active if active is not None else [True] * 4)
    with _impl(impl, jforce_impl):
        jstep = jax_steps.setdefault(
            (tuple(over.items()), impl),
            jax.jit(jsteps.build_train_step(jm, jrc)))
        jmetrics = []
        for b in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                       b.items()}, jax.random.PRNGKey(5),
                              jact)
            jmetrics.append(m)
    tm = port_model(small.build_small_model(CIFAR10_CNN6))
    rc = port_rc(priv)
    state = tsteps.init_train_state(tm, rc, prng.PRNGKey(0),
                                    params=small_params_from_jax(weights,
                                                                 "cpu"))
    assert isinstance(state.params, dict)
    base = state.opt_state["master"].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base
               for p in state.params.values())  # views of the master
    step = tsteps.build_train_step(tm, rc)
    before = dispatch.launch_counts()
    with _impl(impl, dispatch.force_impl):
        for b, jm_ in zip(batches, jmetrics):
            state, m = step(state, {k: torch.tensor(v) for k, v in
                                    b.items()}, prng.PRNGKey(5), active,
                            timer=tsteps.StageTimer("cpu"))
            for k in ("loss", "clip_bound", "grad_norm_mean",
                      "n_contributions"):
                np.testing.assert_allclose(float(m[k]), float(jm_[k]),
                                           rtol=RTOL, err_msg=k)
            assert float(m["clip_bound"]) < PRIV["clip_percentile_max"]
    assert dispatch.launch_counts() == before  # CPU: plain versions
    np.testing.assert_allclose(state.opt_state["master"].numpy(),
                               _jax_packed(jstate.params), rtol=0,
                               atol=PARAM_ATOL)
    assert state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jstate.noise_state.prev_key))
    np.testing.assert_array_equal(state.noise_state.prev_active,
                                  np.asarray(jstate.noise_state.prev_active))


JAX_BARRIER = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs.base import MeshConfig, PrivacyConfig
from repro.configs.paper_models import CIFAR10_CNN6
from repro.core import flatbuf
from repro.core.barrier import step_keys
from repro.core.noise_correction import NoiseState, init_state
from repro.distributed import steps
from repro.kernels import force_impl
from repro.models.registry import Model
from repro.models.small import build_small_model

z = np.load(sys.argv[1])
weights = {}
for k in z.files:
    if k.startswith("w/"):
        node = weights
        *parents, name = k[2:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(z[k])
sm = build_small_model(CIFAR10_CNN6)
model = Model(cfg=None, init=None, loss=sm.loss, init_cache=None,
              prefill=None, decode_step=None)
priv = PrivacyConfig(enabled=True, sigma=0.02, clip_bound=1.0,
                     dynamic_clip=True, noise_lambda=0.7, sync_path="barrier",
                     clip_percentile_max=64.0)
mesh_cfg = MeshConfig((4,), ("data",))
mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
keys = step_keys(jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
batch = {"x": jnp.asarray(z["x"]), "y": jnp.asarray(z["y"])}
layout = flatbuf.layout_of(weights)
out = {}
for name in ("full", "partial", "perleaf"):
    ns = init_state(jax.random.PRNGKey(0), n_silos=4)
    if name == "partial":
        ns = NoiseState(jnp.asarray(z["prev_key"], jnp.uint32),
                        jnp.asarray(True), jnp.asarray(z["prev_active"]))
    act = jnp.asarray(z[name + "_active"])
    fn = jax.jit(lambda p, b, a, ns: steps._barrier_grads(
        model, priv, mesh_cfg, p, b, keys, ns, jnp.float32(1.0),
        keys.key_clip, mesh, active=a))
    with set_mesh(mesh), force_impl("perleaf" if name == "perleaf"
                                    else "packed", "dp_noise_tree"):
        agg, loss, norms, new_ns, bound = fn(weights, batch, act, ns)
    out[name + "_agg"] = np.asarray(flatbuf.pack(layout, agg))
    out[name + "_loss"] = np.asarray(loss)
    out[name + "_norms"] = np.asarray(norms).reshape(-1)
    out[name + "_bound"] = np.asarray(bound)
    out[name + "_prev_key"] = np.asarray(new_ns.prev_key)
    out[name + "_prev_active"] = np.asarray(new_ns.prev_active)
np.savez(sys.argv[2], **out)
print("OK")
"""

BARRIER_CASES = {"full": [True] * 4, "partial": [True, False, True, True],
                 "perleaf": [True] * 4}


@pytest.fixture(scope="module")
def barrier_run(cnn6, tmp_path_factory):
    """JAX's barrier step of CNN6 on a 4-device host mesh, in a subprocess
    (this process waits: one busy process a worker, as the suite's
    wall-clock tests need)."""
    weights, batches = cnn6
    inp = {**_flat_npz(weights), **batches[0],
           "prev_key": np.asarray(PRIMED["prev_key"], np.uint32),
           "prev_active": np.asarray(PRIMED["prev_active"])}
    for name, active in BARRIER_CASES.items():
        inp[name + "_active"] = np.asarray(active)
    d = tmp_path_factory.mktemp("cifar_barrier")
    np.savez(d / "in.npz", **inp)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", JAX_BARRIER, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"
    return dict(np.load(d / "out.npz"))


def _b(bound) -> float:
    """B = mask_scale * sigma * C, the spread of the pairwise terms."""
    return PrivacyConfig().mask_scale * PRIV["sigma"] * float(bound)


@pytest.mark.parametrize("case", list(BARRIER_CASES))
def test_barrier_step_matches_jax_and_the_fused_tier(cnn6, barrier_run,
                                                     case):
    weights, batches = cnn6
    want = barrier_run
    tm = port_model(small.build_small_model(CIFAR10_CNN6))
    rc = port_rc({**PRIV, "sync_path": "barrier"}, mesh=4)
    state = tsteps.init_train_state(tm, rc, prng.PRNGKey(0),
                                    params=small_params_from_jax(weights,
                                                                 "cpu"))
    ns = state.noise_state if case != "partial" else NoiseState(
        PRIMED["prev_key"], True, np.asarray(PRIMED["prev_active"]))
    keys = step_keys(prng.PRNGKey(1), 0)
    batch = {k: torch.tensor(v) for k, v in batches[0].items()}
    active = np.asarray(BARRIER_CASES[case])
    common = (batch, keys, ns, torch.tensor(1.0), keys.key_clip,
              state.layout, tsteps.StageTimer("cpu"))
    impl = "perleaf" if case == "perleaf" else "packed"
    with dispatch.force_impl(impl, kernel="dp_noise_tree"):
        agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
            tm, rc.privacy, rc.mesh, state.params, *common, active=active)
    np.testing.assert_allclose(norms.numpy(), want[case + "_norms"],
                               rtol=RTOL)
    np.testing.assert_allclose(float(loss), want[case + "_loss"], rtol=RTOL)
    np.testing.assert_allclose(float(bound), want[case + "_bound"],
                               rtol=RTOL)
    assert float(bound) < PRIV["clip_percentile_max"]
    atol = AGG_ATOL_PER_B * _b(bound)
    got = flatbuf.zero_padding(state.layout, agg)
    np.testing.assert_allclose(got.numpy(), want[case + "_agg"], rtol=0,
                               atol=atol)
    assert new_ns.prev_key == tuple(int(x) for x in
                                    want[case + "_prev_key"])
    np.testing.assert_array_equal(new_ns.prev_active,
                                  want[case + "_prev_active"])
    if case == "perleaf":
        return  # the fused tier draws another noise family under perleaf
    # the masks cancel: barrier == fused on the same inputs
    f_agg, f_loss, _, f_ns, f_bound = tsteps._fused_grads(
        tm, dataclasses.replace(rc.privacy, sync_path="fused"),
        state.params, batch, 4, *common[1:], active=active)
    np.testing.assert_allclose(float(f_loss), float(loss), rtol=RTOL)
    np.testing.assert_allclose(float(f_bound), float(bound), rtol=RTOL)
    torch.testing.assert_close(
        got, flatbuf.zero_padding(state.layout, f_agg), rtol=0, atol=atol)
    assert f_ns.prev_key == new_ns.prev_key


def test_cnn6_trains():
    """The port's twin of ``test_cnn6_trains_under_barrier``: 20 fused
    steps of 32 at sigma 0.02, momentum lr 0.1, and the loss falls."""
    sm = small.build_small_model(CIFAR10_CNN6)
    rc = port_rc(dict(enabled=True, sigma=0.02, clip_bound=1.0, n_silos=4))
    train, _ = synthetic_cifar10(n_train=256, n_test=128)
    state = tsteps.init_train_state(port_model(sm), rc, prng.PRNGKey(0),
                                    gen=torch.Generator().manual_seed(0))
    step = tsteps.build_train_step(port_model(sm), rc)
    losses = []
    for i in range(20):
        idx = np.random.default_rng(i).integers(0, 256, 32)
        b = {"x": torch.tensor(train.x[idx]), "y": torch.tensor(train.y[idx])}
        state, m = step(state, b, prng.PRNGKey(5),
                        timer=tsteps.StageTimer("cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# the Trainer: MNIST-MLP3 as JAX's tests/test_e2e_training.py, then CNN6

STEPS, EVERY = 6, 3
MLP_PRIV = dict(enabled=True, sigma=0.05, clip_bound=1.0,
                clip_mode="per_silo", n_silos=4)


def _mlp_data():
    return synthetic_mnist(n_train=256, n_test=16)[0]


def _port_trainer(sm, weights, data, total, ckpt=None, priv=MLP_PRIV,
                  opt="sgd", lr=0.5, per_silo=8, **tk):
    rc = port_rc(priv, opt=opt, lr=lr)
    fb = FederatedBatcher(ArrayDataset(data.x, data.y).split(4),
                          per_silo_batch=per_silo)
    tm = port_model(sm)

    def next_batch():
        b = fb.next()
        return {"x": torch.tensor(b["x"]), "y": torch.tensor(b["y"])}

    tr = Trainer(tm, rc, TrainerConfig(
        total_steps=total, checkpoint_every=EVERY, log_every=0,
        checkpoint_dir=None if ckpt is None else str(ckpt), **tk),
        next_batch, batch_state=fb)
    state = tsteps.init_train_state(
        tm, rc, prng.PRNGKey(0), params=small_params_from_jax(weights,
                                                              "cpu"))
    state, step = tr.fit(state, prng.PRNGKey(1))
    return tr, state, step


def _jax_trainer(sm, weights, data, total, ckpt=None, priv=MLP_PRIV,
                 opt="sgd", lr=0.5, per_silo=8, **tk):
    jm = jax_model(sm, weights)
    rc = jax_rc(priv, opt=opt, lr=lr)
    fb = JBatcher(JArrayDataset(data.x, data.y).split(4),
                  per_silo_batch=per_silo)
    tr = JTrainer(jm, rc, JTrainerConfig(
        total_steps=total, checkpoint_every=EVERY, log_every=0,
        checkpoint_dir=None if ckpt is None else str(ckpt), **tk),
        lambda: {k: jnp.asarray(v) for k, v in fb.next().items()},
        batch_state=fb)
    state = jsteps.init_train_state(jm, rc, jax.random.PRNGKey(0))
    state, step = tr.fit(state, jax.random.PRNGKey(1))
    tr._flush_metrics()
    return tr, state, step


def _bit_equal(a, b):
    (ta, sa, _), (tb, sb, _) = a, b
    for k in sa.opt_state:
        if isinstance(sa.opt_state[k], torch.Tensor):
            assert torch.equal(sa.opt_state[k], sb.opt_state[k]), k
        else:
            assert sa.opt_state[k] == sb.opt_state[k], k
    assert torch.equal(sa.clip_bound, sb.clip_bound)
    assert sa.noise_state.prev_key == sb.noise_state.prev_key
    assert [m["loss"] for m in ta.metrics_log] == \
        [m["loss"] for m in tb.metrics_log]
    assert json.dumps(ta.accountant.state_dict()) == \
        json.dumps(tb.accountant.state_dict())


def _hold_to_jax(port, ref, first=0, rtol=RTOL, atol=PARAM_ATOL):
    (tr, state, step), (jtr, jstate, jstep) = port, ref
    assert step == jstep
    tm, jm = tr.metrics_log, jtr.metrics_log
    assert [m["step"] for m in tm] == [m["step"] for m in jm]
    for a, b in zip(tm[first:], jm[first:]):
        for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
        assert a["epsilon"] == b["epsilon"]
        assert a["epsilon_per_silo"] == b["epsilon_per_silo"]
    np.testing.assert_allclose(state.opt_state["master"].numpy(),
                               _jax_packed(jstate.params), rtol=0, atol=atol)
    assert state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jstate.noise_state.prev_key))


def _only_step(src, dst, step: int):
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / name)
    return dst


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """MLP3: JAX's Trainer 6 steps checkpointing at 3 and 6; the port's 6
    steps, 3 then a resume to 6, and a resume from JAX's step-3
    checkpoint."""
    root = tmp_path_factory.mktemp("mlp_trainer")
    sm_j, sm_t = jsmall.build_small_model(JMLP3), \
        small.build_small_model(MNIST_MLP3)
    weights = jax_weights(sm_j)
    data = _mlp_data()
    jax_full = _jax_trainer(sm_j, weights, data, STEPS, root / "jax")
    port_full = _port_trainer(sm_t, weights, data, STEPS)
    _port_trainer(sm_t, weights, data, EVERY, root / "port")
    port_resumed = _port_trainer(sm_t, weights, data, STEPS, root / "port")
    from_jax = _port_trainer(sm_t, weights, data, STEPS,
                             _only_step(root / "jax", root / "jax3", EVERY))
    return dict(jax_full=jax_full, port_full=port_full, root=root,
                port_resumed=port_resumed, from_jax=from_jax,
                weights=weights, data=data)


def test_mlp3_trainer_matches_jax_and_resumes(mlp_runs):
    _hold_to_jax(mlp_runs["port_full"], mlp_runs["jax_full"])
    tr = mlp_runs["port_resumed"][0]
    assert tr.restored_step == EVERY
    _bit_equal(mlp_runs["port_resumed"], mlp_runs["port_full"])
    state = mlp_runs["port_resumed"][1]
    base = state.opt_state["master"].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base
               for p in state.params.values())  # restored in place
    # from JAX's step-3 checkpoint: its history, then JAX's own steps
    assert mlp_runs["from_jax"][0].restored_step == EVERY
    assert mlp_runs["from_jax"][0].metrics_log[:EVERY] == \
        mlp_runs["jax_full"][0].metrics_log[:EVERY]
    _hold_to_jax(mlp_runs["from_jax"], mlp_runs["jax_full"], first=EVERY)


def test_mlp3_port_checkpoint_restores_in_jax(mlp_runs):
    """JAX's checkpointer restores the port's step-6 checkpoint into its
    own TrainState: every leaf bit-equal to the port's state."""
    port_state = mlp_runs["port_resumed"][1]
    jm = jax_model(jsmall.build_small_model(JMLP3), mlp_runs["weights"])
    rc = jax_rc(MLP_PRIV, opt="sgd", lr=0.5)
    template = jsteps.init_train_state(jm, rc, jax.random.PRNGKey(0))
    jstate, extra, step = jck.restore(mlp_runs["root"] / "port", template)
    assert step == STEPS and extra["accountant"]["steps"] == STEPS
    np.testing.assert_array_equal(
        _jax_packed(jstate.params), port_state.opt_state["master"].numpy())
    assert int(jstate.step) == STEPS
    assert tuple(int(x) for x in np.asarray(jstate.noise_state.prev_key)) \
        == port_state.noise_state.prev_key


def test_mlp3_budgets_as_jax(mlp_runs):
    """A silo whose budget is spent leaves the set the next step; the
    epsilon budget stops the loop at JAX's step."""
    sm_j, sm_t = jsmall.build_small_model(JMLP3), \
        small.build_small_model(MNIST_MLP3)
    w, data = mlp_runs["weights"], mlp_runs["data"]
    priv = {**MLP_PRIV, "sigma": 0.5}
    tr, _, step = _port_trainer(sm_t, w, data, 3, priv=priv,
                                silo_budgets={1: 0.001})
    jtr, _, jstep = _jax_trainer(sm_j, w, data, 3, priv=priv,
                                 silo_budgets={1: 0.001})
    assert step == jstep == 3
    assert [m["n_contributions"] for m in tr.metrics_log] == \
        [m["n_contributions"] for m in jtr.metrics_log] == [4.0, 3.0, 3.0]
    assert tr.membership.excluded == (1,)
    assert tr.accountant.epsilon_per_silo() == jtr.accountant.\
        epsilon_per_silo()
    tr, _, step = _port_trainer(sm_t, w, data, 1000, priv=priv,
                                epsilon_budget=1.0)
    jtr, _, jstep = _jax_trainer(sm_j, w, data, 1000, priv=priv,
                                 epsilon_budget=1.0)
    assert step == jstep < 1000
    assert tr.accountant.epsilon() == jtr.accountant.epsilon() >= 1.0


def test_mlp3_escalation_drops_slowest_silo_as_jax():
    """JAX's ``test_trainer_escalation_drops_slowest_silo`` on both
    packages: the latency hook names silo 2, and both Trainers drop it
    with the same events."""
    slow = [0.1, 0.1, 0.7, 0.1]
    kw = dict(total_steps=2, log_every=0, step_deadline_s=30.0,
              elastic=True, elastic_cooldown=5)
    priv = {**MLP_PRIV, "sigma": 0.05}
    jtr = JTrainer(jax_model(jsmall.build_small_model(JMLP3)),
                   jax_rc(priv, opt="sgd"), JTrainerConfig(**kw), lambda: {},
                   silo_latency_hook=lambda step: slow)
    tr = Trainer(port_model(small.build_small_model(MNIST_MLP3)),
                 port_rc(priv, opt="sgd"), TrainerConfig(**kw), lambda: {},
                 silo_latency_hook=lambda step: slow)
    for t in (tr, jtr):
        t.telemetry.observe_all(slow)  # the hook's first feed
        for _ in range(t.straggler.escalate_after):
            t.straggler.observe(1e9)
    assert not tr.membership.active_at(0)[2]
    assert tr.membership.events == jtr.membership.events
    assert tr.membership.events[0]["silo"] == 2
    assert tr.straggler.events == jtr.straggler.events


@pytest.fixture(scope="module")
def cnn6_runs(cnn6, tmp_path_factory):
    """CNN6 in the Trainer (PRIV, momentum lr 0.1, 4 a silo): JAX 4 steps
    checkpointing at 3 (and 4); the port 4 steps, 2 then a resume to 4, and
    a resume from JAX's step-3 checkpoint."""
    weights, _ = cnn6
    root = tmp_path_factory.mktemp("cnn6_trainer")
    data = synthetic_cifar10(64, 16, seed=7)[0]
    sm_j, sm_t = jsmall.build_small_model(JCNN6), \
        small.build_small_model(CIFAR10_CNN6)
    kw = dict(priv=PRIV, opt="momentum", lr=LR, per_silo=4)
    jax_full = _jax_trainer(sm_j, weights, data, 4, root / "jax", **kw)
    port_full = _port_trainer(sm_t, weights, data, 4, **kw)
    first = _port_trainer(sm_t, weights, data, 2, root / "port", **kw)
    port_resumed = _port_trainer(sm_t, weights, data, 4, root / "port",
                                 **kw)
    from_jax = _port_trainer(sm_t, weights, data, 4,
                             _only_step(root / "jax", root / "jax3", EVERY),
                             **kw)
    return dict(jax_full=jax_full, port_full=port_full, first=first,
                port_resumed=port_resumed, from_jax=from_jax, root=root,
                weights=weights)


def test_cnn6_trainer_resumes_bit_for_bit_and_across_packages(cnn6_runs):
    r = cnn6_runs
    _hold_to_jax(r["port_full"], r["jax_full"])
    assert r["port_resumed"][0].restored_step == 2
    _bit_equal(r["port_resumed"], r["port_full"])
    assert r["from_jax"][0].restored_step == EVERY
    _hold_to_jax(r["from_jax"], r["jax_full"], first=EVERY)
    # JAX's leaf names: the checkpoint's entries, and JAX's restore of it
    names = checkpointer.tree_paths(r["first"][1])
    for path in (".params/c0/w", ".params/fc/b", ".opt_state/mu/c0/w",
                 ".opt_state/master/c5/b", ".noise_state/.prev_key"):
        assert path in names, path
    jm = jax_model(jsmall.build_small_model(JCNN6), r["weights"])
    template = jsteps.init_train_state(jm, jax_rc(PRIV),
                                       jax.random.PRNGKey(0))
    jstate, _, step = jck.restore(r["root"] / "port", template, step=2)
    assert step == 2
    np.testing.assert_array_equal(
        _jax_packed(jstate.params),
        r["first"][1].opt_state["master"].numpy())
    np.testing.assert_array_equal(
        _jax_packed(jstate.opt_state["mu"]),
        r["first"][1].opt_state["mu"].numpy())


# ---------------------------------------------------------------------------
# the wire tier: CNN6 through CollaborativeSession

WIRE_SIGMA, WIRE_LR = 0.05, 0.1
# params after 3 rounds at lr 0.1: the masks' fp32 residue (8 ulps of 10
# B a sum, B = 8 sigma C = 0.4) and the gradients' own fp32 difference
# (1e-4 of the largest clipped value, norm <= C) a round, times lr / 4;
# rounded up (measured below 1e-7)
WIRE_PARAM_ATOL = 1e-6


def _wire_silos(jax_side: bool):
    train = synthetic_cifar10(32, 16, seed=7)[0]
    silos = [{"x": s.x, "y": s.y} for s in train.split(4)]
    if jax_side:
        return [{k: jnp.asarray(v) for k, v in s.items()} for s in silos]
    return silos


def _update_fn(p, update, lr):
    return {k: v - lr * torch.as_tensor(update[k], device=v.device)
            for k, v in p.items()}


def port_session(weights, noise_lambda=0.0):
    sm = small.build_small_model(CIFAR10_CNN6)
    params = small_params_from_jax(weights, "cpu")
    sess = CollaborativeSession.from_silos(
        _wire_silos(False), PrivacyConfig(enabled=True, sigma=WIRE_SIGMA,
                                          clip_bound=1.0,
                                          noise_lambda=noise_lambda),
        params_template=params, device="cpu")
    return sess, params, small.value_and_grad(sm.loss), _update_fn


def jax_session(weights):
    sm = jsmall.build_small_model(JCNN6)
    params = jax.tree.map(jnp.asarray, weights)
    sess = JSession.from_silos(
        _wire_silos(True), JPrivacy(enabled=True, sigma=WIRE_SIGMA,
                                    clip_bound=1.0),
        params_template=params)
    grad_fn = jax.jit(jax.value_and_grad(sm.loss))

    def update_fn(p, update, lr):
        return jax.tree.map(lambda a, u: a - lr * u.astype(a.dtype), p,
                            update)

    return sess, params, grad_fn, update_fn


def _packed(params) -> np.ndarray:
    return wire.pack_np(flatbuf.layout_of(params), params)


def test_codecs_pack_the_cnn6_tree_alike(cnn6):
    """The port's flat dict and JAX's nested tree: one layout (paths,
    shapes, offsets) and the same packed bytes."""
    weights, _ = cnn6
    tree = small_params_from_jax(weights, "cpu")
    lay, jlay = flatbuf.layout_of(tree), jflat.layout_of(
        jax.tree.map(jnp.asarray, weights))
    assert lay.total == jlay.total == 308224
    assert lay.offsets == tuple(jlay.offsets)
    got = _packed(tree)
    want = jwire.pack_np(jlay, jax.tree.map(jnp.asarray, weights))
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(
        want).view(np.uint32))


def test_wire_rounds_match_jax_with_a_drop(cnn6):
    """3 serial rounds, silo 1 out in round 1 and back in round 2 (a full
    resync): losses, params, epsilon, participation and the bytes on the
    wire (but for the full messages' structure descriptors, JSON here and
    a pickled treedef in JAX) as JAX's."""
    weights, _ = cnn6
    ps, pp, pg, pu = port_session(weights)
    js, jp, jg, ju = jax_session(weights)
    dispatch.reset_launches()
    for t, events in enumerate([[], [("drop", 1)], [("rejoin", 1)]]):
        for what, silo in events:
            for s in (ps, js):
                assert getattr(s, f"{what}_silo")(silo, step=t)
        pp, pl = ps.step(t, pp, pg, pu, lr=WIRE_LR)
        jp, jl = js.step(t, jp, jg, ju, lr=WIRE_LR)
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert dispatch.launch_counts()["clip_mask"] == 0  # CPU: plain versions
    np.testing.assert_allclose(_packed(pp), jwire.pack_np(
        jflat.layout_of(jp), jp), rtol=0, atol=WIRE_PARAM_ATOL)
    assert ps.epsilon() == js.epsilon() and ps.epsilon(1) == js.epsilon(1)
    assert ps.accountant.history == js.accountant.history
    assert ps.accountant.contributions == [4, 3, 4]
    dp = len(wire._layout_descriptor(ps._bcast_layout))
    dj = len(jwire._layout_descriptor(js._bcast_layout))
    assert ps.wire_stats["update_bytes"] == js.wire_stats["update_bytes"]
    assert ps.wire_stats["rounds"] == js.wire_stats["rounds"] == 3
    assert ps.wire_stats["broadcast_bytes"] - dp == \
        js.wire_stats["broadcast_bytes"] - dj
    assert ps.wire_stats["resync_bytes"] > 0
    assert ps.wire_stats["resync_bytes"] - dp == \
        js.wire_stats["resync_bytes"] - dj


def test_wire_pipelined_and_speculative_equal_serial(cnn6):
    """Three sessions from the same weights, 2 rounds each at lambda 0.7
    (round 1 reads round 0's stream; the speculative session prefetches
    it): serial, pipelined and speculative bit for bit (params, losses,
    bytes on the wire)."""
    weights, _ = cnn6
    runs = []
    for kw in (dict(pipelined=False), dict(pipelined=True),
               dict(speculative=True)):
        sess, params, grad_fn, update_fn = port_session(weights,
                                                        noise_lambda=0.7)
        p, losses = sess.run(params, grad_fn, update_fn, lr=WIRE_LR,
                             n_rounds=2, **kw)
        runs.append((_packed(p).view(np.uint32), losses,
                     dict(sess.wire_stats)))
    for p, losses, stats in runs[1:]:
        np.testing.assert_array_equal(p, runs[0][0])
        assert losses == runs[0][1]
        assert stats["rounds"] == 2
        for k in ("update_bytes", "broadcast_bytes"):
            assert stats[k] == runs[0][2][k], k


def test_prng_draws_make_no_host_copy_per_window(monkeypatch):
    """``core/prng.py``'s plain draw (``kernels/prng/ref.py``) builds its
    device constants without a host copy a window (``torch.full``, and
    erfinv's tables once a device): a draw over
    three windows (of 1024) calls no ``torch.tensor`` once the tables are
    made, and draws what it drew before (``tests/test_torch_threefry.py``
    holds it to ``jax.random.normal``)."""
    calls = []
    real = torch.tensor

    def spy(*a, **k):
        calls.append(k.get("device"))
        return real(*a, **k)

    monkeypatch.setattr(prng_ref, "WINDOW", 1 << 10)
    z0 = prng.normal((7, 9), (2 * prng_ref.WINDOW + 5,))
    monkeypatch.setattr(torch, "tensor", spy)
    z1 = prng.normal((7, 9), (2 * prng_ref.WINDOW + 5,))
    assert calls == []
    assert torch.equal(z0, z1)
