"""The barrier tier: the port's per-silo contributions, its barrier step and
its barrier training run against the JAX package, and against the port's
own fused tier.

* ``silo_contribution`` against JAX's, in process, for every silo: pairwise
  and none, full and partial sets, a first step and a primed one with a
  partial ``prev_active``.
* The masks telescope, and a contribution minus its clipped gradient and
  its noise share is the mask, of std about ``B * sqrt(2)``.
* ``_barrier_grads`` against JAX's own ``_barrier_grads`` under
  ``shard_map`` on a 4-device host mesh, in a subprocess (as
  ``tests/test_dp_pipeline.py`` runs it), at the qwen2.5-3b smoke config
  from the same weights, for the full set and ``[T, F, T, T]``; and
  ``Session.train`` on the barrier tier, 3 steps with silo 1 dropped at
  step 1 and back at step 2, against the same run of JAX's ``Session``.

Tolerances. Every contribution carries ``+-b * r`` terms of magnitude up to
about ``10 B`` (``|r| <= 5`` at these sizes), which cancel only in the sum:
the aggregate keeps a few fp32 ulps of that size, and the two packages add
the contributions in other orders (JAX's psum) and may differ by an ulp in
libm's ``log``. Aggregates and contributions are held to
``AGG_ATOL_PER_B * B`` (8 ulps of ``10 B``, 9.5e-6 per unit of ``B``;
measured on this CPU at B = 10.1: 1.5e-5 against JAX's barrier step and
against the port's fused tier, on aggregates up to 7.1, where 9.6e-5 is
allowed), the rest as in ``test_torch_training.py``: loss, norms and bound
1e-5 relative (measured 2.4e-7), keys bit-equal, epsilon equal.
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

from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro.core.barrier import BarrierKeys as JaxKeys
from repro.core.dp_pipeline import DPPipeline as JaxPipeline
from repro.core.noise_correction import NoiseState as JaxNoiseState
from repro_torch.api import Session
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import BarrierKeys, step_keys
from repro_torch.core.dp_pipeline import DPPipeline, reduce_contributions
from repro_torch.core.noise_correction import NoiseState
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_fused import ref as fref
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
AGG_ATOL_PER_B = 8 * 2.0 ** -23 * 10
RTOL = 1e-5
N = 4
KEYS = ((3704974950, 1863054868), (2705940334, 2639757084),
        (788428910, 4288801516))
PREV_KEY = (4086990474, 1067026239)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b(bound, sigma=0.3) -> float:
    """B = mask_scale * sigma * C, the spread of the pairwise terms."""
    return PrivacyConfig().mask_scale * sigma * float(bound)


# ---------------------------------------------------------------------------
# silo_contribution, in process


def _trees(seed, scale=1):
    """(JAX tree, port tree) of one silo's gradient: the same numpy draws."""
    rng = np.random.default_rng(seed)
    leaves = {"a": rng.standard_normal(37 * scale), "b": rng.standard_normal(
        (3, 50 * scale)), "c.d": rng.standard_normal(129 * scale),
        "e": rng.standard_normal((2, 2, 64 * scale))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    jtree = {"a": leaves["a"], "b": leaves["b"], "c": {"d": leaves["c.d"]},
             "e": leaves["e"]}
    ttree = {"a": leaves["a"], "b": leaves["b"], "c.d": leaves["c.d"],
             "e": list(leaves["e"])}
    return (jax.tree.map(jnp.asarray, jtree),
            {k: [torch.from_numpy(t) for t in v] if isinstance(v, list)
             else torch.from_numpy(v) for k, v in ttree.items()})


def _setup(mode, active, has_prev, prev_active, scale=1):
    priv = dict(enabled=True, sigma=0.3, clip_bound=2.0, noise_lambda=0.7,
                mask_mode=mode, sync_path="barrier")
    pairs = [_trees(seed=i, scale=scale) for i in range(N)]
    jl, tl = jflat.layout_of(pairs[0][0]), flatbuf.layout_of(pairs[0][1])
    assert (jl.offsets, jl.total) == (tl.offsets, tl.total)
    act = None if active is None else np.asarray(active, bool)
    pa = np.asarray(prev_active, bool)
    jpipe = JaxPipeline(JaxPrivacy(**priv), jl, N)
    jstate = JaxNoiseState(jnp.asarray(PREV_KEY, jnp.uint32),
                           jnp.asarray(has_prev), jnp.asarray(pa))
    pipe = DPPipeline(PrivacyConfig(**priv), tl, N)
    state = NoiseState(PREV_KEY, has_prev, pa)
    return priv, pairs, act, jpipe, jstate, pipe, state


CONTRIB_CASES = [
    # mode, active, has_prev, prev_active
    ("pairwise", None, False, [1, 1, 1, 1]),
    ("pairwise", [1, 1, 1, 1], True, [1, 1, 1, 1]),
    ("pairwise", [1, 0, 1, 1], True, [1, 1, 0, 1]),
    ("pairwise", [0, 1, 1, 0], True, [1, 0, 1, 1]),
    ("none", None, True, [1, 1, 1, 1]),
    ("none", [1, 0, 1, 1], True, [1, 1, 0, 1]),
]


@pytest.mark.parametrize("mode,active,has_prev,prev_active", CONTRIB_CASES)
def test_silo_contribution_matches_jax(mode, active, has_prev, prev_active):
    priv, pairs, act, jpipe, jstate, pipe, state = _setup(
        mode, active, has_prev, prev_active)
    bound = 2.0
    jkeys = JaxKeys(*(jnp.asarray(k, jnp.uint32) for k in KEYS))
    jact = None if act is None else jnp.asarray(act)
    atol = AGG_ATOL_PER_B * _b(bound)
    for i, (jg, tg) in enumerate(pairs):
        jscale = jpipe.clip_scale(jpipe.norm_tree(jg), bound)
        jc = jpipe.silo_contribution(jg, i, jscale, jact, jkeys, jstate,
                                     jnp.float32(bound))
        # pairwise: the packed buffer; none: the tree, packed here
        want = np.asarray(jc if mode == "pairwise"
                          else jflat.pack(jpipe.layout, jc))
        scale = pipe.clip_scale(pipe.norm_tree(tg), torch.tensor(bound))
        np.testing.assert_allclose(float(scale), float(jscale), rtol=RTOL)
        before = dispatch.launch_counts()
        got = pipe.silo_contribution(tg, i, scale, act, BarrierKeys(*KEYS),
                                     state, torch.tensor(bound))
        assert dispatch.launch_counts() == before  # CPU: the plain version
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
        if mode == "pairwise":  # the tree view, leaf for leaf
            tree, jtree = pipe.finalize(got), jpipe.finalize(jc)
            np.testing.assert_allclose(tree["c.d"].numpy(),
                                       np.asarray(jtree["c"]["d"]), atol=atol)
            np.testing.assert_allclose(torch.stack(tree["e"]).numpy(),
                                       np.asarray(jtree["e"]), atol=atol)
        if act is not None and not act[i]:
            assert not got.any()  # a dropped silo contributes nothing


def test_masks_telescope_and_hide_each_gradient():
    """The sum of the contributions is the clipped sum plus the aggregate
    noise (the fused tier's construction); one contribution minus its
    clipped gradient and its noise share is the mask, std about B*sqrt(2)."""
    priv, pairs, act, _, _, pipe, state = _setup(
        "pairwise", [1, 1, 0, 1], True, [1, 1, 1, 0], scale=64)
    bound = torch.tensor(4.0)
    keys = BarrierKeys(*KEYS)
    contribs, clipped = [], []
    for i, (_, tg) in enumerate(pairs):
        g = flatbuf.pack(pipe.layout, tg)
        scale = pipe.clip_scale(pipe.norm_tree(tg), bound) * float(act[i])
        clipped.append(g * scale)
        contribs.append(pipe.silo_contribution(g, i, scale, act, keys, state,
                                               bound))
    one = contribs[0].clone()
    agg = reduce_contributions([c.clone() for c in contribs])
    s, s_prev, pa = pipe._stream_scales(bound, act, state)
    gates = torch.as_tensor(act, dtype=torch.float32)
    lam = 0.7 * gates * torch.as_tensor(pa, dtype=torch.float32)
    want = fref.noise_batch_ref(sum(clipped), KEYS[1], PREV_KEY, s * gates,
                                lam, s_prev.item())
    B = _b(bound)
    torch.testing.assert_close(agg, want, atol=AGG_ATOL_PER_B * B, rtol=0)
    # silo 0 alone: its mask over the active ring (silo 1 next)
    share = fref.noise_batch_ref(clipped[0], KEYS[1], PREV_KEY,
                                 s * torch.tensor([1.0]),
                                 torch.tensor([0.7]), s_prev.item())
    mask = one - share
    assert abs(float(mask.std()) / (B * np.sqrt(2)) - 1) < 0.02
    assert float(mask.abs().max()) > 2 * B


def test_next_active_skips_dropped_silos():
    pipe = DPPipeline(PrivacyConfig(), flatbuf.layout_of({"a": torch.zeros(8)}),
                      5)
    act = np.array([1, 0, 0, 1, 1], bool)
    assert [pipe.next_active(i, act) for i in range(5)] == [3, 3, 3, 4, 0]
    assert [pipe.next_active(i, None) for i in range(5)] == [1, 2, 3, 4, 0]
    assert pipe.next_active(2, np.array([0, 0, 1, 0, 0], bool)) == 2


# ---------------------------------------------------------------------------
# the barrier step and the barrier run against JAX's on a 4-device mesh

ARCH = "qwen2.5-3b"
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, sync_path="barrier",
                  clip_percentile_max=8.0)
LR = 1e-3
PRIMED = dict(prev_key=(2180194710, 3380338437), has_prev=True,
              prev_active=[True, True, False, True])
STEP_CASES = {"full": ([True] * 4, None), "partial": ([True, False, True,
                                                       True], PRIMED)}


def drop_and_rejoin(step):
    """Silo 1 out at step 1, back at step 2."""
    return [True, step != 1, True, True]


JAX_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import Session
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro.core import flatbuf
from repro.core.barrier import step_keys
from repro.core.noise_correction import NoiseState
from repro.distributed import steps

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
layout = flatbuf.layout_of(state.params)
mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
keys = step_keys(jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
batch = {"tokens": jnp.asarray(z["tokens"]), "labels": jnp.asarray(z["labels"])}
out = {}
fn = jax.jit(lambda p, b, a, ns, c: steps._barrier_grads(
    model, priv, mesh_cfg, p, b, keys, ns, c, keys.key_clip, mesh, active=a))
for name in ("full", "partial"):
    ns = state.noise_state
    if name + "_prev_key" in z.files:
        ns = NoiseState(jnp.asarray(z[name + "_prev_key"], jnp.uint32),
                        jnp.asarray(True),
                        jnp.asarray(z[name + "_prev_active"]))
    with set_mesh(mesh):
        agg, loss, norms, new_ns, bound = fn(
            state.params, batch, jnp.asarray(z[name + "_active"]), ns,
            state.clip_bound)
    out[name + "_agg"] = np.asarray(flatbuf.pack(layout, agg))
    out[name + "_loss"] = np.asarray(loss)
    out[name + "_norms"] = np.asarray(norms).reshape(-1)
    out[name + "_bound"] = np.asarray(bound)
    out[name + "_prev_key"] = np.asarray(new_ns.prev_key)
    out[name + "_prev_active"] = np.asarray(new_ns.prev_active)

res = sess.train(state=state, steps=3, batch_size=16, seq_len=16, log_every=0,
                 silo_schedule=lambda t: [True, t != 1, True, True])
for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions",
          "epsilon"):
    out["train_" + k] = np.array([m[k] for m in res.metrics], np.float64)
out["train_epsilon_per_silo"] = np.array(
    [m["epsilon_per_silo"] for m in res.metrics], np.float64)
out["train_prev_key"] = np.asarray(res.state.noise_state.prev_key)
out["train_steps"] = np.asarray(res.step)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's inputs, and JAX's barrier step and run on them."""
    weights = params_to_numpy(transformer.init(
        torch.Generator().manual_seed(0), get_smoke_config(ARCH), "cpu"))
    ts = Session.from_config(ARCH, device="cpu",
                             privacy=PrivacyConfig(**QUICKSTART))
    batch = {k: v.numpy() for k, v in ts.synthetic_batches(16, 16)().items()}
    inp = {**_flat_weights(weights), **batch}
    for name, (active, primed) in STEP_CASES.items():
        inp[name + "_active"] = np.asarray(active)
        if primed:
            inp[name + "_prev_key"] = np.asarray(primed["prev_key"], np.uint32)
            inp[name + "_prev_active"] = np.asarray(primed["prev_active"])
    d = tmp_path_factory.mktemp("barrier")
    np.savez(d / "in.npz", **inp)
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
    return weights, batch, dict(np.load(d / "out.npz"))


def _port(weights, **priv):
    sess = Session.from_config(
        ARCH, device="cpu", privacy=PrivacyConfig(**{**QUICKSTART, **priv}),
        optimizer=OptimizerConfig(name="adamw", lr=LR),
        mesh=MeshConfig((N,), ("data",)))
    return sess, sess.init_state(params=params_from_jax(weights, sess.cfg,
                                                        "cpu"))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_barrier_step_matches_jax_barrier_grads(runs, case):
    weights, batch, want = runs
    active, primed = STEP_CASES[case]
    sess, state = _port(weights)
    ns = state.noise_state if primed is None else NoiseState(
        primed["prev_key"], True, np.asarray(primed["prev_active"]))
    keys = step_keys(prng.PRNGKey(1), 0)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
        sess.model, sess.run_cfg.privacy, sess.run_cfg.mesh, state.params,
        tbatch, keys, ns, state.clip_bound, keys.key_clip, state.layout,
        tsteps.StageTimer("cpu"), active=np.asarray(active))
    np.testing.assert_allclose(norms.numpy(), want[case + "_norms"], rtol=RTOL)
    np.testing.assert_allclose(float(loss), want[case + "_loss"], rtol=RTOL)
    np.testing.assert_allclose(float(bound), want[case + "_bound"], rtol=RTOL)
    assert float(bound) < QUICKSTART["clip_percentile_max"]  # not the cap
    B = _b(bound)
    got = flatbuf.zero_padding(state.layout, agg).numpy()
    np.testing.assert_allclose(got, want[case + "_agg"],
                               atol=AGG_ATOL_PER_B * B, rtol=0)
    assert new_ns.prev_key == tuple(int(x) for x in want[case + "_prev_key"])
    np.testing.assert_array_equal(new_ns.prev_active,
                                  want[case + "_prev_active"])


def test_session_train_barrier_matches_jax(runs):
    """3 steps through ``Session.train`` on the barrier tier, silo 1 out at
    step 1 and back at step 2 (its correction share then gated off)."""
    weights, _, want = runs
    sess, state = _port(weights)
    dispatch.reset_launches()
    res = sess.train(state=state, steps=3, batch_size=16, seq_len=16,
                     log_every=0, silo_schedule=drop_and_rejoin)
    assert sum(dispatch.launch_counts().values()) == 0  # CPU: plain versions
    assert res.step == int(want["train_steps"]) == 3
    assert [sorted(st) for st in res.trainer.stage_log] == 3 * [sorted(
        ("silo_grads", "norms", "pack", "contributions", "reduce",
         "optimizer"))]
    for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
        np.testing.assert_allclose([m[k] for m in res.metrics],
                                   want["train_" + k], rtol=RTOL)
    assert max(m["clip_bound"] for m in res.metrics) < 8.0  # below the cap
    assert [m["epsilon"] for m in res.metrics] == list(want["train_epsilon"])
    assert [m["epsilon_per_silo"] for m in res.metrics] == \
        want["train_epsilon_per_silo"].tolist()
    assert res.state.noise_state.prev_key == tuple(
        int(x) for x in want["train_prev_key"])


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_barrier_tier_matches_fused_tier(runs, case):
    """The two tiers of the port on the same weights, batch and keys: the
    same aggregate up to the masks' residue (and the norms' rounding, tree
    against packed row), the same loss, bound and carried state."""
    weights, batch, _ = runs
    active, primed = STEP_CASES[case]
    sess, state = _port(weights)
    ns = state.noise_state if primed is None else NoiseState(
        primed["prev_key"], True, np.asarray(primed["prev_active"]))
    keys = step_keys(prng.PRNGKey(1), 0)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    common = (tbatch, keys, ns, state.clip_bound, keys.key_clip, state.layout,
              tsteps.StageTimer("cpu"))
    priv = sess.run_cfg.privacy
    b_agg, b_loss, b_norms, b_ns, b_bound = tsteps._barrier_grads(
        sess.model, priv, sess.run_cfg.mesh, state.params, *common,
        active=np.asarray(active))
    f_agg, f_loss, f_norms, f_ns, f_bound = tsteps._fused_grads(
        sess.model, dataclasses.replace(priv, sync_path="fused"), state.params,
        tbatch, N, *common[1:], active=np.asarray(active))
    np.testing.assert_allclose(b_norms.numpy(), f_norms.numpy(), rtol=RTOL)
    np.testing.assert_allclose(float(b_loss), float(f_loss), rtol=RTOL)
    np.testing.assert_allclose(float(b_bound), float(f_bound), rtol=RTOL)
    B = _b(b_bound)
    torch.testing.assert_close(flatbuf.zero_padding(state.layout, b_agg),
                               flatbuf.zero_padding(state.layout, f_agg),
                               atol=AGG_ATOL_PER_B * B, rtol=0)
    assert (b_ns.prev_key, b_ns.has_prev) == (f_ns.prev_key, f_ns.has_prev)
    np.testing.assert_array_equal(b_ns.prev_active, f_ns.prev_active)


def test_barrier_needs_the_mesh_silo_count():
    sess, state = _port(params_to_numpy(transformer.init(
        torch.Generator().manual_seed(0), get_smoke_config(ARCH), "cpu")))
    step = tsteps.build_train_step(sess.model, sess.run_cfg)
    batch = sess.synthetic_batches(8, 8)()
    with pytest.raises(ValueError, match="mesh's silo-axis extent"):
        step(state, batch, prng.PRNGKey(1), np.ones(3, bool),
             timer=tsteps.StageTimer("cpu"))
