"""Training the ssm (rwkv6-7b) and hybrid (zamba2-7b) families: the port
against the JAX package at the smoke configs in fp32, from the same
weights (the port's init, seed 0, carried across as the JAX tree).

* The loss and every leaf of its gradient: ``jax.grad`` of JAX's
  ``rwkv_stack.loss_fn`` / ``hybrid.loss_fn`` against the port's
  ``loss.backward()`` through the WKV / SSD ``autograd.Function``, leaf by
  leaf through ``models/packing.param_tree``. The hybrid runs at 5 layers:
  two calls of the shared block, whose weights take gradient from both,
  and one trailing Mamba-2 layer.
* ``Session.train`` on the fused tier, 3 steps at the quickstart's privacy
  settings (4 silos, sigma 0.3, dynamic clipping, lambda 0.7), AdamW lr
  1e-3, against JAX's ``Session.train``, as ``tests/test_torch_training.py``
  does for qwen2.5-3b: losses, clip bounds and parameters within
  tolerance, epsilon equal, the carried noise key bit-equal.
* One barrier step on a ``(4,)`` data mesh with silo 1 dropped, against
  JAX's ``_barrier_grads`` under ``shard_map`` on a 4-device host mesh in a
  subprocess (as ``tests/test_torch_barrier.py`` runs it), and the first
  step of the port's barrier ``Session.train`` with that drop.
* ``python -m repro_torch.launch.train --arch rwkv6-7b|zamba2-7b`` on the
  CPU, both tiers.

JAX's CPU WKV scan is its factored form, which clamps the log-decay at
-3.5 where the port does not; at initialised weights (w_base -0.6, so
log w is about -0.55) the clamp never binds, and the gradients agree.

Tolerances, each with what was measured on this CPU: the loss 1e-5
relative; each gradient leaf within GRAD_REL (5e-5) of its largest
|value| (measured at most 1.3e-5 over three batches, on A_log's small
gradient; 1.8e-5 absolute on u's, which reach 3.2: fp32 sums in other
orders, the scans' backward a reverse scan against JAX's autodiff of its
chunked forms); the
training run's tolerances are ``test_torch_training.py``'s (measured here:
losses and bounds 4e-7 relative, parameters 1.9e-6 after 3 steps, where
AdamW's first steps move a weight by about lr whatever |g|); the barrier
aggregate within ``test_torch_barrier.py``'s 8 ulps of 10 B.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro.distributed import steps as jsteps
from repro.models import hybrid as jhybrid
from repro.models import rwkv_stack as jrwkv_stack
from repro_torch.api import Session
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_cli
from repro_torch.models import hybrid, packing, rwkv_stack
from repro_torch.models.convert import params_from_jax, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("rwkv6-7b", "zamba2-7b")
MODULES = {"rwkv6-7b": (rwkv_stack, jrwkv_stack),
           "zamba2-7b": (hybrid, jhybrid)}
# the gradient test's depth: zamba2 at 5 layers calls the shared block
# twice (attn_every 2) and ends on a trailing Mamba-2 layer
GRAD_LAYERS = {"rwkv6-7b": 2, "zamba2-7b": 5}
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4)
LR = 1e-3
RTOL = 1e-5
GRAD_REL = 5e-5
PARAM_ATOL = 1e-5
AGG_ATOL_PER_B = 8 * 2.0 ** -23 * 10
N = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers=None):
    cut = {} if n_layers is None else {"n_layers": n_layers}
    return (dataclasses.replace(get_smoke_config(arch), **cut),
            dataclasses.replace(jax_smoke_config(arch), **cut))


def _weights(arch, cfg):
    """The port's random init (seed 0) as the JAX package's numpy tree."""
    mod = MODULES[arch][0]
    return params_to_numpy(mod.init(torch.Generator().manual_seed(0), cfg,
                                    "cpu"))


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    cfg, jcfg = _cfgs(arch, GRAD_LAYERS[arch])
    tmod, jmod = MODULES[arch]
    weights = _weights(arch, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrad = jax.value_and_grad(lambda p: jmod.loss_fn(
        p, jcfg, jax.tree.map(jnp.asarray, batch),
        compute_dtype=jnp.float32))(jax.tree.map(jnp.asarray, weights))
    params = params_from_jax(weights, cfg, "cpu")
    packing.pack_params(params)
    loss = tmod.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    tree = packing.param_tree(params)
    assert sorted(tree) == sorted(
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jgrad)[0])
    for path, leaf in tree.items():
        got = (np.stack([t.grad.numpy() for t in leaf])
               if isinstance(leaf, list) else leaf.grad.numpy())
        want = np.asarray(_leaf(jgrad, path))
        assert np.abs(want).max() > 0, path  # every leaf takes gradient
        np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                                   atol=GRAD_REL * np.abs(want).max())


def _sessions(arch, **priv):
    """(JAX session, port session, JAX TrainState, port TrainState) from
    the same weights."""
    kw = {**QUICKSTART, **priv}
    js = JaxSession.from_config(arch, privacy=JaxPrivacy(**kw),
                                optimizer=JaxOptimizer(name="adamw", lr=LR))
    ts = Session.from_config(arch, privacy=PrivacyConfig(**kw),
                             optimizer=OptimizerConfig(name="adamw", lr=LR),
                             device="cpu")
    weights = _weights(arch, ts.cfg)
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, weights))
    jstate = jsteps.init_train_state(jmodel, js.run_cfg,
                                     jax.random.PRNGKey(0))
    return js, ts, jstate, ts.init_state(
        params=params_from_jax(weights, ts.cfg, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_session_train_fused_matches_jax(arch):
    js, ts, jstate, tstate = _sessions(arch)
    assert type(tstate.params).__name__ == ("RWKVStack" if arch == "rwkv6-7b"
                                            else "Hybrid")
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0)
    start = np.asarray(jflat.pack(jflat.layout_of(jstate.params),
                                  jstate.params))
    jres = js.train(state=jstate, **kw)  # donates jstate's buffers
    before = dispatch.launch_counts()
    tres = ts.train(state=tstate, **kw)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    assert tres.step == jres.step == 3
    for tm, jm in zip(tres.metrics, jres.metrics):
        for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL)
        assert tm["epsilon"] == jm["epsilon"]
    want = np.asarray(jflat.pack(jflat.layout_of(jres.state.params),
                                 jres.state.params))
    got = tres.state.opt_state["master"].detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PARAM_ATOL
    assert np.abs(got - start).max() > 100 * PARAM_ATOL  # the weights moved
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))
    assert ts.privacy_report() == js.privacy_report()
    # the trained weights serve: the params are views of the master buffer
    gen = ts.serve(batch_size=2, prompt_len=4, max_new_tokens=2,
                   params=tres.state.params)
    assert gen.tokens.shape == (2, 2)


# ---------------------------------------------------------------------------
# one barrier step with a dropped silo, against JAX's on a 4-device mesh

BARRIER = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
               noise_lambda=0.7, sync_path="barrier", clip_percentile_max=8.0)
ACTIVE = [True, False, True, True]

JAX_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import Session
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro.core import flatbuf
from repro.core.barrier import step_keys
from repro.distributed import steps

z = np.load(sys.argv[1])
priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                     dynamic_clip=True, noise_lambda=0.7, sync_path="barrier",
                     clip_percentile_max=8.0)
mesh_cfg = MeshConfig((4,), ("data",))
mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
keys = step_keys(jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
out = {}
for arch in ("rwkv6-7b", "zamba2-7b"):
    weights = {}
    for k in z.files:
        if k.startswith(arch + "/w/"):
            node = weights
            *parents, name = k[len(arch) + 3:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = jnp.asarray(z[k])
    sess = Session.from_config(arch, privacy=priv, mesh=mesh_cfg,
                               optimizer=OptimizerConfig(name="adamw", lr=1e-3))
    model = dataclasses.replace(sess.model, init=lambda key: weights)
    state = steps.init_train_state(model, sess.run_cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(z[arch + "/" + k]) for k in ("tokens", "labels")}
    with set_mesh(mesh):
        agg, loss, norms, new_ns, bound = jax.jit(
            lambda p, b, ns, c: steps._barrier_grads(
                model, priv, mesh_cfg, p, b, keys, ns, c, keys.key_clip, mesh,
                active=jnp.asarray(z["active"])))(
            state.params, batch, state.noise_state, state.clip_bound)
    out[arch + "/agg"] = np.asarray(flatbuf.pack(flatbuf.layout_of(
        state.params), agg))
    out[arch + "/loss"] = np.asarray(loss)
    out[arch + "/norms"] = np.asarray(norms).reshape(-1)
    out[arch + "/bound"] = np.asarray(bound)
    out[arch + "/prev_key"] = np.asarray(new_ns.prev_key)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _port_barrier(arch, weights):
    sess = Session.from_config(
        arch, device="cpu", privacy=PrivacyConfig(**BARRIER),
        optimizer=OptimizerConfig(name="adamw", lr=LR),
        mesh=MeshConfig((N,), ("data",)))
    return sess, sess.init_state(params=params_from_jax(weights, sess.cfg,
                                                        "cpu"))


@pytest.fixture(scope="module")
def barrier_runs(tmp_path_factory):
    """Each family's weights and batch, and JAX's barrier step on them."""
    inp, data = {"active": np.asarray(ACTIVE)}, {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        weights = _weights(arch, cfg)
        batch = {k: v.numpy() for k, v in Session.from_config(
            arch, device="cpu").synthetic_batches(16, 16)().items()}
        data[arch] = (weights, batch)
        inp.update(_flat(weights, f"{arch}/w"))
        inp.update({f"{arch}/{k}": v for k, v in batch.items()})
    d = tmp_path_factory.mktemp("ssm_barrier")
    np.savez(d / "in.npz", **inp)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"
    return data, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_barrier_step_with_a_dropped_silo_matches_jax(barrier_runs, arch):
    data, want = barrier_runs
    weights, batch = data[arch]
    sess, state = _port_barrier(arch, weights)
    keys = step_keys(prng.PRNGKey(1), 0)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
        sess.model, sess.run_cfg.privacy, sess.run_cfg.mesh, state.params,
        tbatch, keys, state.noise_state, state.clip_bound, keys.key_clip,
        state.layout, tsteps.StageTimer("cpu"), active=np.asarray(ACTIVE))
    np.testing.assert_allclose(norms.numpy(), want[arch + "/norms"],
                               rtol=RTOL)
    np.testing.assert_allclose(float(loss), want[arch + "/loss"], rtol=RTOL)
    np.testing.assert_allclose(float(bound), want[arch + "/bound"], rtol=RTOL)
    assert float(bound) < BARRIER["clip_percentile_max"]  # not the cap
    B = PrivacyConfig().mask_scale * BARRIER["sigma"] * float(bound)
    got = flatbuf.zero_padding(state.layout, agg).numpy()
    np.testing.assert_allclose(got, want[arch + "/agg"],
                               atol=AGG_ATOL_PER_B * B, rtol=0)
    assert new_ns.prev_key == tuple(int(x) for x in want[arch + "/prev_key"])

    # the barrier Session.train's first step (its root key PRNGKey(1), as
    # above) with the same drop: JAX's loss, bound and mean norm
    sess, state = _port_barrier(arch, weights)
    dispatch.reset_launches()
    res = sess.train(state=state, steps=1, batch_size=16, seq_len=16,
                     log_every=0, silo_schedule=lambda t: ACTIVE)
    assert sum(dispatch.launch_counts().values()) == 0  # CPU: plain versions
    m, norms = res.metrics[0], want[arch + "/norms"]
    np.testing.assert_allclose(m["loss"], want[arch + "/loss"], rtol=RTOL)
    np.testing.assert_allclose(m["clip_bound"], want[arch + "/bound"],
                               rtol=RTOL)
    np.testing.assert_allclose(m["grad_norm_mean"],
                               norms[np.asarray(ACTIVE)].mean(), rtol=RTOL)
    assert m["n_contributions"] == 3 and m["epsilon"] > 0
    assert res.state.noise_state.prev_key == new_ns.prev_key


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tier", ["fused", "barrier"])
def test_cli_trains_the_family_on_cpu(arch, tier, capsys):
    res = train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                          "--batch", "4", "--seq", "9", "--sync-path", tier,
                          "--silos", "2", "--lam", "0.7", "--dynamic-clip"])
    out = capsys.readouterr().out
    assert res.step == 2 and np.isfinite(res.final["loss"])
    assert f"done at step 2 on cpu ({tier} tier)" in out
    assert res.final["n_contributions"] == 2
