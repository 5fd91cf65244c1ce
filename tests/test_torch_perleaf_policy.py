"""The per-leaf execution policy: tree-level selection (``force_impl``,
``REPRO_KERNEL_IMPL``), ``jax.random`` over shapes, the per-leaf corrected
noise, and one fused step and one barrier step under
``force_impl("perleaf", kernel="dp_noise_tree")`` against the JAX package's
under the same override (the barrier step on a 4-device host mesh in a
subprocess, as ``test_torch_barrier.py`` runs it), with the partial-set
refusals.

Tolerances, each with what was measured on this CPU:
* ``prng.normal``: the bits are equal; the normals go through ``log1p``
  (libm's here, XLA's own in JAX) inside XLA's ``erfinv``, held to
  ``NORMAL_ULP`` = 3 ulp (measured max 3 over 2**21 draws, 97% equal);
* corrected noise: those normals times sigma_c, held to 4e-6 absolute on
  values up to 5 (measured 2.4e-7), as ``test_torch_dp_pipeline.py``;
* the fused step's noisy aggregate: that, plus fp32 products in another
  order, held to 4e-6 (measured 1.4e-6 on values up to 6.6), loss and
  bound 1e-5 relative, keys bit-equal;
* the barrier aggregate: every contribution carries ``+-b * r`` terms up
  to about ``10 B``, which cancel only in the sum: ``AGG_ATOL_PER_B * B``
  (8 ulps of ``10 B``), as ``test_torch_barrier.py``.
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
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import barrier as jbarrier
from repro.core import flatbuf as jflat
from repro.core import noise_correction as jnoise
from repro.core.barrier import BarrierKeys as JaxKeys
from repro.core.barrier import step_keys as jax_step_keys
from repro.core.dp_pipeline import DPPipeline as JaxPipeline
from repro.distributed import steps as jsteps
from repro.kernels.dispatch import force_impl as jax_force_impl
from repro_torch.api import Session
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro_torch.core import barrier, flatbuf, noise_correction, prng
from repro_torch.core.barrier import BarrierKeys, step_keys
from repro_torch.core.dp_pipeline import DPPipeline, resolve_policy
from repro_torch.core.noise_correction import NoiseState
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import force_impl, resolve_tree
from repro_torch.kernels.prng import ref as prng_ref
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
NORMAL_ULP = 3
NOISY_ATOL = 4e-6
RTOL = 1e-5
AGG_ATOL_PER_B = 8 * 2.0 ** -23 * 10
N = 4
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, clip_percentile_max=8.0)
PERLEAF = ("perleaf", "dp_noise_tree")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# selection


def test_force_impl_nests_scopes_and_beats_the_environment(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert resolve_tree("dp_noise_tree", "packed") == "packed"
    assert resolve_tree("dp_clip_tree", "auto", cuda=True) == "packed"
    assert resolve_tree("dp_clip_tree", "auto", cuda=False) == "perleaf"
    with force_impl("perleaf"):
        assert resolve_tree("zsmask_tree", "packed") == "perleaf"
        with force_impl("pallas", kernel="dp_noise_tree"):  # innermost wins
            assert resolve_tree("dp_noise_tree", "jnp") == "packed"
            assert resolve_tree("zsmask_tree", "packed") == "perleaf"
        assert resolve_tree("dp_noise_tree", "packed") == "perleaf"
    assert resolve_tree("dp_noise_tree", "packed") == "packed"
    monkeypatch.setenv(dispatch.ENV_VAR, "dp_noise_tree=jnp")
    assert resolve_policy("packed").mode == "perleaf"
    assert resolve_tree("dp_clip_tree", "packed") == "packed"
    with force_impl("packed", kernel="dp_noise_tree"):
        assert resolve_policy("packed").mode == "packed"
    monkeypatch.setenv(dispatch.ENV_VAR, "perleaf")  # bare: all three
    assert {resolve_tree(k, "packed") for k in dispatch.TREE_KERNELS} == \
        {"perleaf"}
    monkeypatch.setenv(dispatch.ENV_VAR, "blocked")  # no tree kernel has it
    assert resolve_tree("zsmask_tree", "packed") == "packed"


def test_tensor_level_overrides_raise(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    for name in ("zsmask", "dp_clip_sumsq", "dp_clip_accumulate",
                 "dp_fused_clip_sum", "paged_attention"):
        with pytest.raises(ValueError, match="tree-level"):
            with force_impl("jnp", kernel=name):
                pass
    monkeypatch.setenv(dispatch.ENV_VAR, "dp_noise_tree=perleaf,zsmask=jnp")
    with pytest.raises(ValueError, match="'zsmask'"):
        resolve_tree("dp_noise_tree", "packed")
    monkeypatch.setenv(dispatch.ENV_VAR, "dp_noise_tree=fastest")
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_tree("dp_noise_tree", "packed")


# ---------------------------------------------------------------------------
# jax.random over shapes, and the per-leaf noise


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", [(), (7,), (3, 129), (1 << 16,)])
def test_normal_over_shapes_matches_jax(shape):
    key = (2705940334, 2639757084)
    jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
    np.testing.assert_array_equal(
        prng.bits(key, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    z = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    assert _ulp(prng.normal(key, shape).numpy(), z).max() <= NORMAL_ULP


def test_normal_slices_of_a_stacked_leaf_draw_the_whole_leaf():
    key = (4086990474, 1067026239)
    jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
    want = np.asarray(jax.random.normal(jkey, (3, 40, 9), jnp.float32))
    whole = prng.normal(key, (3, 40, 9))
    for l in range(3):
        part = prng.normal(key, (40, 9), offset=l * 360)
        assert torch.equal(part, whole[l])
        assert _ulp(part.numpy(), want[l]).max() <= NORMAL_ULP
    u = prng_ref.uniform(key, (1000,), -1.0, 1.0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(
        jax.random.uniform(jkey, (1000,), jnp.float32, -1.0, 1.0)))


def _small_trees(seed):
    rng = np.random.default_rng(seed)
    leaves = {"a": rng.standard_normal(37), "b": rng.standard_normal((3, 50)),
              "e": rng.standard_normal((2, 2, 64))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    ttree = {"a": torch.from_numpy(leaves["a"]),
             "b": torch.from_numpy(leaves["b"]),
             "e": [torch.from_numpy(x) for x in leaves["e"]]}
    return jax.tree.map(jnp.asarray, leaves), ttree


@pytest.mark.parametrize("has_prev,lam", [(False, 0.7), (True, 0.7),
                                          (True, 0.0)])
def test_corrected_noise_matches_jax(has_prev, lam):
    jtree, ttree = _small_trees(0)
    key_t, prev = (2705940334, 2639757084), (4086990474, 1067026239)
    jn, jst = jnoise.corrected_noise(
        jtree, jnp.asarray(key_t, jnp.uint32),
        jnoise.NoiseState(jnp.asarray(prev, jnp.uint32), jnp.asarray(has_prev)),
        jnp.float32(1.2), lam)
    # the port adds the noise into the tree it is given: into zeros, the
    # noise itself (JAX returns the noise tree)
    zeros = {k: [torch.zeros_like(t) for t in v] if isinstance(v, list)
             else torch.zeros_like(v) for k, v in ttree.items()}
    tn, tst = noise_correction.corrected_noise(
        zeros, key_t, NoiseState(prev, has_prev), torch.tensor(1.2), lam)
    assert tn is zeros
    layout = flatbuf.layout_of(ttree)
    np.testing.assert_allclose(
        flatbuf.pack(layout, tn).numpy(),
        np.asarray(jflat.pack(jflat.layout_of(jtree), jn)), atol=NOISY_ATOL,
        rtol=0)
    assert tst.prev_key == key_t and tst.has_prev
    assert noise_correction.effective_sigma(0.3, 0.7) == pytest.approx(1.0)


@pytest.mark.parametrize("impl", ["packed", "perleaf"])
@pytest.mark.parametrize("has_prev", [False, True])
def test_dp_noise_tree_matches_jax(impl, has_prev):
    """``fused_noise`` (the ``dp_noise_tree`` kernel) and the pipeline's
    ``corrected_noise_tree`` under each policy, against JAX's."""
    jtree, ttree = _small_trees(1)
    priv = dict(enabled=True, sigma=0.3, noise_lambda=0.7)
    keys = ((3704974950, 1863054868), (2705940334, 2639757084), (1, 2))
    prev = (4086990474, 1067026239)
    jkeys = JaxKeys(*(jnp.asarray(k, jnp.uint32) for k in keys))
    jstate = jnoise.NoiseState(jnp.asarray(prev, jnp.uint32),
                               jnp.asarray(has_prev))
    state = NoiseState(prev, has_prev)
    layout = flatbuf.layout_of(ttree)
    jlayout = jflat.layout_of(jtree)
    want, _ = jbarrier.fused_noise(jtree, JaxPrivacy(**priv), jkeys, jstate,
                                   jnp.float32(1.5), impl=impl)
    got, st = barrier.fused_noise(ttree, PrivacyConfig(**priv),
                                  BarrierKeys(*keys), state,
                                  torch.tensor(1.5), impl=impl)
    np.testing.assert_allclose(flatbuf.pack(layout, got).numpy(),
                               np.asarray(jflat.pack(jlayout, want)),
                               atol=NOISY_ATOL, rtol=0)
    assert st.prev_key == keys[1] and st.has_prev
    with jax_force_impl(impl, "dp_noise_tree"):
        jpipe = JaxPipeline(JaxPrivacy(**priv), jlayout, N)
    with force_impl(impl, "dp_noise_tree"):
        pipe = DPPipeline(PrivacyConfig(**priv), layout, N)
    want = jpipe.corrected_noise_tree(jtree, jkeys, jstate, jnp.float32(1.5),
                                      None)
    got = pipe.corrected_noise_tree({k: [t.clone() for t in v] if
                                     isinstance(v, list) else v.clone()
                                     for k, v in ttree.items()},
                                    BarrierKeys(*keys), state,
                                    torch.tensor(1.5), None)
    np.testing.assert_allclose(flatbuf.pack(layout, got).numpy(),
                               np.asarray(jflat.pack(jlayout, want)),
                               atol=NOISY_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# one fused step under perleaf, in process


@pytest.fixture(scope="module")
def weights():
    return params_to_numpy(transformer.init(
        torch.Generator().manual_seed(0), get_smoke_config(ARCH), "cpu"))


def test_fused_step_under_perleaf_matches_jax(weights):
    """A primed noise state (xi_{t-1} drawn and subtracted)."""
    has_prev = True
    priv = dict(QUICKSTART, n_silos=N)
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(**priv),
                                optimizer=JaxOptimizer(name="adamw", lr=1e-3))
    ts = Session.from_config(ARCH, device="cpu", privacy=PrivacyConfig(**priv),
                             optimizer=OptimizerConfig(name="adamw", lr=1e-3))
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, weights))
    jstate = jsteps.init_train_state(jmodel, js.run_cfg, jax.random.PRNGKey(0))
    tstate = ts.init_state(params=params_from_jax(weights, ts.cfg, "cpu"))
    jns = jstate.noise_state._replace(has_prev=jnp.asarray(has_prev))
    tns = tstate.noise_state._replace(has_prev=has_prev)
    batch = js.synthetic_batches(16, 16)()
    tbatch = {k: torch.as_tensor(np.array(v), dtype=torch.long)
              for k, v in batch.items()}
    jkeys = jax_step_keys(jax.random.PRNGKey(1), 0)
    tkeys = step_keys(prng.PRNGKey(1), 0)
    with jax_force_impl(*PERLEAF):  # resolved at trace time
        jn, jloss, _, jns2, jbound = jax.jit(
            lambda p, b, ns, c: jsteps._fused_grads(
                js.model, js.run_cfg.privacy, p, b, N, jkeys, ns, c,
                jkeys.key_clip))(jstate.params, batch, jns, jstate.clip_bound)
    dispatch.reset_launches()
    with force_impl(*PERLEAF):
        tn, tloss, _, tns2, tbound = tsteps._fused_grads(
            ts.model, ts.run_cfg.privacy, tstate.params, tbatch, N, tkeys,
            tns, tstate.clip_bound, tkeys.key_clip, tstate.layout,
            tsteps.StageTimer("cpu"))
    assert sum(dispatch.launch_counts().values()) == 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(tbound), float(jbound), rtol=RTOL)
    want = np.asarray(jflat.pack(jflat.layout_of(jstate.params), jn))
    got = flatbuf.zero_padding(tstate.layout, tn).numpy()
    np.testing.assert_allclose(got, want, atol=NOISY_ATOL, rtol=0)
    assert tns2.prev_key == tuple(int(x) for x in np.asarray(jns2.prev_key))


# ---------------------------------------------------------------------------
# the barrier step under perleaf against JAX's on a 4-device mesh

JAX_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import Session
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro.core import flatbuf
from repro.core.barrier import step_keys
from repro.distributed import steps
from repro.kernels.dispatch import force_impl

z = np.load(sys.argv[1])
weights = {}
for k in z.files:
    if k.startswith("w/"):
        node = weights
        *parents, name = k[2:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(z[k])
priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                     dynamic_clip=True, noise_lambda=0.7, sync_path="barrier",
                     clip_percentile_max=8.0)
mesh_cfg = MeshConfig((4,), ("data",))
sess = Session.from_config("qwen2.5-3b", privacy=priv, mesh=mesh_cfg,
                           optimizer=OptimizerConfig(name="adamw", lr=1e-3))
model = dataclasses.replace(sess.model, init=lambda key: weights)
state = steps.init_train_state(model, sess.run_cfg, jax.random.PRNGKey(0))
state = state._replace(noise_state=state.noise_state._replace(
    prev_key=jnp.asarray(z["prev_key"], jnp.uint32),
    has_prev=jnp.asarray(True)))
layout = flatbuf.layout_of(state.params)
mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
keys = step_keys(jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
batch = {"tokens": jnp.asarray(z["tokens"]), "labels": jnp.asarray(z["labels"])}
out = {}
with force_impl("perleaf", "dp_noise_tree"):
    fn = jax.jit(lambda p, b, a, ns, c: steps._barrier_grads(
        model, priv, mesh_cfg, p, b, keys, ns, c, keys.key_clip, mesh,
        active=a))
    for name, act in (("full", [True] * 4), ("partial", [True, False, True,
                                                          True])):
        with set_mesh(mesh):
            agg, loss, norms, new_ns, bound = fn(
                state.params, batch, jnp.asarray(act), state.noise_state,
                state.clip_bound)
        out[name + "_agg"] = np.asarray(flatbuf.pack(layout, agg))
        out[name + "_loss"] = np.asarray(loss)
        out[name + "_bound"] = np.asarray(bound)
        out[name + "_prev_key"] = np.asarray(new_ns.prev_key)
        out[name + "_prev_active"] = np.asarray(new_ns.prev_active)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _flat_weights(tree, prefix="w"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_weights(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


PREV_KEY = (2180194710, 3380338437)


@pytest.fixture(scope="module")
def barrier_run(weights, tmp_path_factory):
    ts = Session.from_config(ARCH, device="cpu",
                             privacy=PrivacyConfig(**QUICKSTART))
    batch = {k: v.numpy() for k, v in ts.synthetic_batches(16, 16)().items()}
    d = tmp_path_factory.mktemp("perleaf")
    np.savez(d / "in.npz", prev_key=np.asarray(PREV_KEY, np.uint32),
             **_flat_weights(weights), **batch)
    # one thread per process (torch, MKL, XLA's Eigen pool): the suite runs
    # several files at once, and wall-clock tests share the cores
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
    return batch, dict(np.load(d / "out.npz"))


def _barrier_port(weights):
    sess = Session.from_config(
        ARCH, device="cpu",
        privacy=PrivacyConfig(**QUICKSTART, sync_path="barrier"),
        optimizer=OptimizerConfig(name="adamw", lr=1e-3),
        mesh=MeshConfig((N,), ("data",)))
    state = sess.init_state(params=params_from_jax(weights, sess.cfg, "cpu"))
    ns = state.noise_state._replace(prev_key=PREV_KEY, has_prev=True)
    return sess, state._replace(noise_state=ns)


@pytest.mark.parametrize("case", ["full", "partial"])
def test_barrier_step_under_perleaf_matches_jax(weights, barrier_run, case):
    """Every silo's contribution masked leaf by leaf (the ``zsmask``
    plain version, 2 passes a leaf); a partial set given to the step is
    replaced by the full ring, in both packages (``ROADMAP.md`` queue 3)."""
    batch, want = barrier_run
    sess, state = _barrier_port(weights)
    act = np.array([True, case == "full", True, True])
    keys = step_keys(prng.PRNGKey(1), 0)
    with force_impl(*PERLEAF):
        agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
            sess.model, sess.run_cfg.privacy, sess.run_cfg.mesh, state.params,
            {k: torch.as_tensor(v) for k, v in batch.items()}, keys,
            state.noise_state, state.clip_bound, keys.key_clip, state.layout,
            tsteps.StageTimer("cpu"), active=act)
    np.testing.assert_allclose(float(loss), want[case + "_loss"], rtol=RTOL)
    np.testing.assert_allclose(float(bound), want[case + "_bound"], rtol=RTOL)
    B = PrivacyConfig().mask_scale * 0.3 * float(bound)
    got = flatbuf.zero_padding(state.layout, agg).numpy()
    np.testing.assert_allclose(got, want[case + "_agg"],
                               atol=AGG_ATOL_PER_B * B, rtol=0)
    np.testing.assert_allclose(want["partial_agg"], want["full_agg"], atol=0)
    assert new_ns.prev_key == tuple(int(x) for x in want[case + "_prev_key"])
    np.testing.assert_array_equal(new_ns.prev_active,
                                  want[case + "_prev_active"])


def test_perleaf_step_divides_by_the_given_count(weights, barrier_run):
    """Called directly with a partial set, the step aggregates the full
    ring but divides by the set's count, as JAX's ``build_train_step``
    does (``repro/distributed/steps.py:339``): the update is the full
    aggregate over 3."""
    batch, want = barrier_run
    sess, state = _barrier_port(weights)
    master = state.opt_state["master"].clone()
    with force_impl(*PERLEAF):
        step = tsteps.build_train_step(sess.model, sess.run_cfg)
        new, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                      prng.PRNGKey(1), np.array([True, False, True, True]),
                      timer=tsteps.StageTimer("cpu"))
    assert float(m["n_contributions"]) == 3.0
    # AdamW's first step moves each weight by about lr * sign(g): every
    # weight with a gradient moved, the silo-1 rows included
    moved = (new.opt_state["master"] - master).abs()
    assert float((moved > 0.5e-3).float().mean()) > 0.9


# ---------------------------------------------------------------------------
# partial participation sets under perleaf are refused


def test_perleaf_refuses_partial_sets():
    layout = flatbuf.layout_of({"a": torch.zeros(300)})
    priv = PrivacyConfig(**QUICKSTART, sync_path="barrier")
    with force_impl(*PERLEAF):
        pipe = DPPipeline(priv, layout, N)
    assert pipe.policy.mode == "perleaf"
    args = (torch.zeros(layout.total), 0, torch.tensor(1.0))
    rest = (BarrierKeys((1, 2), (3, 4), (5, 6)), NoiseState((7, 8), True),
            torch.tensor(1.0))
    with pytest.raises(ValueError, match="full static ring"):
        pipe.silo_contribution(*args, np.array([1, 0, 1, 1], bool), *rest)
    tree = pipe.silo_contribution(*args, None, *rest)
    assert isinstance(tree, dict) and tree["a"].shape == (300,)


@pytest.mark.parametrize("train_kw", [
    dict(silo_schedule=lambda t: [True, t != 1, True, True]),
    dict(elastic=True),
    dict(silo_epsilon_budget=1.0),
])
def test_perleaf_barrier_training_refuses_partial_sets(train_kw, monkeypatch):
    monkeypatch.setenv(dispatch.ENV_VAR, "dp_noise_tree=perleaf")
    sess = Session.from_config(
        ARCH, device="cpu",
        privacy=PrivacyConfig(**QUICKSTART, sync_path="barrier"),
        mesh=MeshConfig((N,), ("data",)))
    with pytest.raises(ValueError, match="packed mask engine"):
        sess.train(steps=1, batch_size=8, seq_len=8, **train_kw)
    with pytest.raises(ValueError, match="packed mask engine"):
        tsteps.build_train_step(sess.model, sess.run_cfg, elastic=True)
    monkeypatch.delenv(dispatch.ENV_VAR)
    tsteps.build_train_step(sess.model, sess.run_cfg, elastic=True)


def test_perleaf_barrier_training_runs_through_the_session(monkeypatch):
    """Two steps of ``Session.train`` on the barrier tier under the
    environment variable: no kernel launched on the CPU, the stages of the
    barrier tier, finite loss, rising epsilon."""
    monkeypatch.setenv(dispatch.ENV_VAR, "dp_noise_tree=perleaf")
    sess = Session.from_config(
        ARCH, device="cpu",
        privacy=PrivacyConfig(**QUICKSTART, sync_path="barrier"),
        mesh=MeshConfig((N,), ("data",)))
    dispatch.reset_launches()
    res = sess.train(steps=2, batch_size=8, seq_len=8, log_every=0)
    assert sum(dispatch.launch_counts().values()) == 0
    assert all(np.isfinite(m["loss"]) for m in res.metrics)
    assert res.metrics[1]["epsilon"] > res.metrics[0]["epsilon"] > 0
    assert "contributions" in res.trainer.stage_log[0]
