"""Training in bf16 against the JAX package, at the qwen2.5-3b smoke config
with the quickstart's privacy (4 silos, sigma 0.3, dynamic clipping,
lambda 0.7) and AdamW lr 1e-3, on JAX's two routes:

* (A) bf16 compute over fp32 weights: ``Session.from_config(arch,
  compute_dtype=bf16)`` in both packages;
* (B) bf16 weights over an fp32 master: the port's ``build_model(cfg,
  "cpu", param_dtype=bf16, compute_dtype=bf16)`` against JAX's
  ``build_model(cfg, param_dtype=bf16, compute_dtype=bf16)``, both from the
  bf16 weights of one port model (``params_to_numpy`` gives them as exact
  fp32 arrays, ``jnp.asarray(a, bf16)`` and ``params_from_jax(...,
  dtype=bf16)`` take them back bit for bit).

Each case starts both packages from the same numpy weights and batch: one
fused step (``_fused_grads`` and AdamW), a barrier step with a dropped silo
(JAX's ``_barrier_grads`` under ``shard_map`` on a 4-device host mesh, in a
subprocess, and 3 barrier steps through JAX's ``Session.train`` there), a
scan-tier step with JAX's dry-run privacy (``per_silo``, ``scan``), a
batch of repeated tokens, 3 steps through ``Session.train``, each clip
mode's ``silo_grad``, the packed layout of a mixed fp32/bf16 tree and a
bf16 checkpoint both ways; a route (B) Trainer resumes bit for bit. Under
route (B) the port's bf16 weights are its fp32 master rounded to nearest
even, bit for bit, after every step.

Where the two packages part in bf16. The port's training forward follows
XLA's order where XLA's CPU backend rounds otherwise than torch
(``models/transformer.py``): the second norm of a layer reads the unrounded
fp32 residual sum, and the SiLU rounds after each op, forward and
backward (``layers.XlaSilu``). With both, the loss agrees to 1e-6 and the
forward's hidden states bit for bit but for a few elements. What remains,
each a bf16 rounding that flips:

* a bf16 product's fp32 sum in another order rounds to the other bf16
  neighbour now and then (4 of 4096 elements of the first layer's output
  here), and the flip travels on through the layers and the backward;
* XLA reduces a bf16 cotangent (the q/k/v bias gradients, summed over the
  batch and sequence) rounding after every add; torch sums in fp32 and
  rounds once. Matching it would take one launch a row on the card.

So a gradient element may lie a few bf16 ulps of its leaf's largest value
from JAX's (1e-2 of it on the smoke weights), while a silo's norm, a sum
over 1e5 such elements, agrees to a few 1e-4. The tolerances, each with
the largest value measured on this CPU over the cases here:

* loss at the first step: ``LOSS_RTOL`` 2e-5 relative (measured 3.5e-6);
  after an update, from weights that differ where a gradient's sign
  flipped (below): ``LOSS_TRAIN_RTOL`` 1e-3 (measured 1.05e-4 at step 3);
* silo norms and the dynamic bound, a noisy percentile of the norms:
  ``NORM_RTOL`` 1e-3 relative (measured 3.4e-4 and 1.2e-4); one
  example's norm, over 16 tokens, sums fewer flips: ``EXAMPLE_RTOL``
  5e-3 (measured 1.3e-3);
* the noisy aggregate and the clipped sums: ``NOISY_ATOL`` 2e-2
  absolute, on values up to about 6 (measured 4.9e-3: the clipped
  gradients' flips, a bf16 ulp of a value up to 0.5 each);
* the master after AdamW: each weight moves by lr * m / (sqrt(v) + eps),
  which is +-lr at the first step, so a gradient element whose sign flips
  between the packages moves its weight by 2 lr: ``PARAM_ATOL`` 2.5 lr
  (measured 2.0e-3), and at most ``FLIP_SHARE`` 1% of the weights past
  lr / 10 (measured 2.8e-5);
* the noise keys, the carried state, the participation sets and epsilon:
  bit-equal.
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
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.core.noise_correction import NoiseState
from repro_torch.core.tee import wire
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.synthetic import ArrayDataset, synthetic_tokens
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.models import packing, transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4)
# JAX's dry-run privacy (repro/launch/dryrun.py), at the quickstart's 4 silos
DRYRUN = dict(enabled=True, sigma=1.0, clip_mode="per_silo",
              silo_mode="scan", n_silos=4)
LR = 1e-3
BF16 = torch.bfloat16
LOSS_RTOL = 2e-5
LOSS_TRAIN_RTOL = 1e-3
NORM_RTOL = 1e-3
EXAMPLE_RTOL = 5e-3
NOISY_ATOL = 2e-2
PARAM_ATOL = 2.5 * LR
FLIP_SHARE = 0.01
# the qwen2.5-3b smoke layout's wire identity before leaf dtypes were
# recorded: the fingerprint leaves them out, so an fp32 layout keeps it
FP32_FINGERPRINT = "2a7e20c90745b6f62d56c8f3c9a4f023"


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
    """The JAX package's modules (imported here, so the card-only cases
    run where JAX is not installed)."""
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
    from repro.models import transformer as jtransformer
    from repro.models.registry import build_model as jax_build_model
    from repro.optim.optimizers import make_optimizer as jax_make_optimizer
    return SimpleNamespace(
        jax=jax, jnp=jnp, Session=JaxSession, ckpt=jckpt,
        Optimizer=JaxOptimizer, Privacy=JaxPrivacy, flat=jflat,
        step_keys=jax_step_keys, steps=jsteps, transformer=jtransformer,
        build_model=jax_build_model, make_optimizer=jax_make_optimizer)


def _weights(dtype):
    model = build_model(get_smoke_config(ARCH), "cpu", param_dtype=dtype) \
        .init(torch.Generator().manual_seed(0))
    return params_to_numpy(model)


@pytest.fixture(scope="module")
def weights():
    """Route -> the numpy tree both packages start from: the port's random
    smoke weights in fp32 (A) and in bf16 (B, as exact fp32 arrays)."""
    return {"A": _weights(torch.float32), "B": _weights(BF16)}


def _port_session(route, mesh=None, **priv):
    ts = Session.from_config(
        ARCH, device="cpu", compute_dtype=BF16,
        privacy=PrivacyConfig(**{**QUICKSTART, **priv}),
        optimizer=OptimizerConfig(name="adamw", lr=LR), mesh=mesh)
    if route == "B":
        ts = dataclasses.replace(ts, model=build_model(
            ts.cfg, "cpu", param_dtype=BF16, compute_dtype=BF16))
    return ts


def _sessions(jx, weights, route, **priv):
    """(JAX session, port session, JAX TrainState, port TrainState) from the
    same weights under ``route``; each package's ``init_train_state``
    builds the rest (the fp32 master, the moments, the noise state)."""
    jnp = jx.jnp
    kw = {**QUICKSTART, **priv}
    js = jx.Session.from_config(ARCH, privacy=jx.Privacy(**kw),
                                optimizer=jx.Optimizer(name="adamw", lr=LR),
                                compute_dtype=jnp.bfloat16)
    pd = jnp.bfloat16 if route == "B" else jnp.float32
    if route == "B":
        js = dataclasses.replace(js, model=jx.build_model(
            js.cfg, param_dtype=pd, compute_dtype=jnp.bfloat16))
    jparams = jx.jax.tree.map(lambda a: jnp.asarray(a, pd), weights[route])
    jmodel = dataclasses.replace(js.model, init=lambda key: jparams)
    js = dataclasses.replace(js, model=jmodel)
    jstate = jx.steps.init_train_state(jmodel, js.run_cfg,
                                       jx.jax.random.PRNGKey(0))
    ts = _port_session(route, **priv)
    tparams = params_from_jax(weights[route], ts.cfg, "cpu",
                              dtype=BF16 if route == "B" else torch.float32)
    return js, ts, jstate, ts.init_state(params=tparams)


def _jax_packed(jx, tree):
    return np.asarray(jx.flat.pack(jx.flat.layout_of(tree), tree))


def _batch(js, seq_len=16, vocab=None):
    batch = js.synthetic_batches(16, seq_len)()
    batch = {k: np.array(v) for k, v in batch.items()}
    if vocab is not None:  # every token repeated many times over
        batch = {k: v % vocab for k, v in batch.items()}
    return batch, {k: torch.as_tensor(v, dtype=torch.long)
                   for k, v in batch.items()}


def _bf16_is_round_of_master(state):
    assert state.weights is not None and state.weights.dtype == BF16
    assert torch.equal(state.weights,
                       state.opt_state["master"].to(BF16))
    # the parameters are views of the bf16 buffer
    first = flatbuf.flat_tensors(state.layout,
                                 packing.param_tree(state.params))[0]
    assert first.untyped_storage().data_ptr() == \
        state.weights.untyped_storage().data_ptr()


def _master_close(jx, tstate, jopt_master):
    got = tstate.opt_state["master"].numpy()
    diff = np.abs(got - _jax_packed(jx, jopt_master))
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff > LR / 10) <= FLIP_SHARE, np.mean(diff > LR / 10)


# ---------------------------------------------------------------------------
# the packed layout


def test_flatbuf_mixed_tree_matches_jax(jx):
    """A tree of fp32 and bf16 leaves (one stacked): JAX's dtypes, offsets
    and total, the bf16 leaves widened exactly into the fp32 buffer, and
    unpack in the recorded dtypes, a noisy fp32 buffer's bf16 leaves
    rounded to nearest even as JAX's ``astype``; fp32 leaves stay views."""
    jnp = jx.jnp
    g = torch.Generator().manual_seed(3)
    tree = {"a.w": torch.randn(5, 7, generator=g).to(BF16),
            "a.b": torch.randn(7, generator=g),
            "layers.w": [torch.randn(3, 4, generator=g).to(BF16)
                         for _ in range(2)]}
    jtree = {"a": {"w": jnp.asarray(tree["a.w"].float().numpy(),
                                    jnp.bfloat16),
                   "b": jnp.asarray(tree["a.b"].numpy())},
             "layers": {"w": jnp.asarray(np.stack(
                 [t.float().numpy() for t in tree["layers.w"]]),
                 jnp.bfloat16)}}
    layout, jlayout = flatbuf.layout_of(tree), jx.flat.layout_of(jtree)
    assert layout.dtypes == jlayout.dtypes == ("float32", "bfloat16",
                                               "bfloat16")
    assert (layout.offsets, layout.total) == (jlayout.offsets, jlayout.total)
    buf = flatbuf.pack(layout, tree)
    assert buf.dtype == torch.float32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(
        jx.flat.pack(jlayout, jtree)))
    noisy = torch.randn(layout.total, generator=g)
    got = flatbuf.unpack(layout, noisy)
    want = jx.flat.unpack(jlayout, jnp.asarray(noisy.numpy()))
    assert got["a.w"].dtype == got["layers.w"][0].dtype == BF16
    np.testing.assert_array_equal(got["a.w"].float().numpy(), np.asarray(
        want["a"]["w"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        np.stack([t.float().numpy() for t in got["layers.w"]]),
        np.asarray(want["layers"]["w"].astype(jnp.float32)))
    assert got["a.b"].untyped_storage().data_ptr() == \
        noisy.untyped_storage().data_ptr()
    as32 = flatbuf.unpack(layout, noisy, dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in
               flatbuf.flat_tensors(layout, as32))
    np.testing.assert_array_equal(flatbuf.pack(layout, as32).numpy(),
                                  flatbuf.zero_padding(layout,
                                                       noisy.clone()).numpy())


def test_fp32_wire_identity_unchanged(weights):
    """The layout's dtypes move no fp32 layout's wire identity: the same
    fingerprint as before they were recorded, and the descriptor's layout
    (dtypes not sent: fp32) equals the sender's."""
    tree = packing.param_tree(params_from_jax(
        weights["A"], get_smoke_config(ARCH), "cpu"))
    layout = flatbuf.layout_of(tree)
    assert wire.layout_fingerprint(layout).hex() == FP32_FINGERPRINT
    assert flatbuf.build_layout(layout.paths, layout.shapes,
                                layout.stacks) == layout
    bf = packing.param_tree(params_from_jax(
        weights["A"], get_smoke_config(ARCH), "cpu", dtype=BF16))
    assert wire.layout_fingerprint(flatbuf.layout_of(bf)).hex() == \
        FP32_FINGERPRINT  # the bytes mean the same fp32 buffer


def test_pack_params_bf16_weights_view_one_bf16_buffer(weights):
    params = params_from_jax(weights["B"], get_smoke_config(ARCH), "cpu",
                             dtype=BF16)
    layout, buf = packing.pack_params(params)
    assert buf.dtype == BF16 and set(layout.dtypes) == {"bfloat16"}
    assert torch.equal(buf.float(), flatbuf.pack(layout, packing.param_tree(
        params)))
    wq = params.layers[1].attn.wq
    assert wq.dtype == BF16 and wq.requires_grad
    off = layout.offsets[layout.paths.index("layers.attn.wq")] + wq.numel()
    with torch.no_grad():
        buf[off] = 3.0
    assert wq.reshape(-1)[0].item() == 3.0
    # a mixed tree: the bf16 leaf views the bf16 buffer, the fp32 leaves
    # the fp32 master (tests/test_torch_bf16_families.py holds the rest)
    mixed = transformer.init(torch.Generator().manual_seed(0),
                             get_smoke_config(ARCH), "cpu")
    mixed.ln_f.scale = torch.nn.Parameter(mixed.ln_f.scale.to(BF16))
    layout, buf = packing.pack_params(mixed)
    assert buf.dtype == BF16 and layout.dtypes[layout.paths.index(
        "ln_f.scale")] == "bfloat16"
    assert mixed.ln_f.scale.untyped_storage().data_ptr() == \
        buf.untyped_storage().data_ptr()
    assert mixed.embed.dtype == torch.float32 and \
        mixed.embed.untyped_storage().data_ptr() != \
        buf.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the forward's order and the embedding gradient


def test_training_forward_follows_xla_order(jx, weights):
    """The loss, the final hidden states and a layer's output against JAX's
    jitted training forward; serving's forward (the plain order) is the
    one that parts."""
    jnp = jx.jnp
    js = jx.Session.from_config(ARCH)
    batch, tbatch = _batch(js)
    b = {k: v[:4] for k, v in batch.items()}
    cfg = get_smoke_config(ARCH)
    tp = params_from_jax(weights["A"], cfg, "cpu")
    jp = jx.jax.tree.map(jnp.asarray, weights["A"])
    jh = jx.jax.jit(lambda p, b: jx.transformer.forward(
        p, js.cfg, b, None, False, False, jnp.bfloat16, "hidden")[0])(jp, b)
    th, _ = transformer._forward(tp, cfg, tbatch["tokens"][:4], None, BF16,
                                 train=True)
    neq = np.mean(np.asarray(jh.astype(jnp.float32)) != th.float().numpy())
    serving = transformer.forward(tp, cfg, tbatch["tokens"][:4], None, BF16,
                                  "hidden")
    neq_serving = np.mean(np.asarray(jh.astype(jnp.float32))
                          != serving.float().numpy())
    assert neq < 0.02 and neq_serving > 0.5, (neq, neq_serving)
    jl = jx.jax.jit(jx.build_model(js.cfg, compute_dtype=jnp.bfloat16).loss)(
        jp, b)
    tl = build_model(cfg, "cpu", compute_dtype=BF16).loss(
        tp, {k: v[:4] for k, v in tbatch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


@pytest.mark.parametrize("route", ["A", "B"])
def test_embedding_gradient_repeats_tokens_in_bf16(jx, weights, route):
    """Cast, then gather: the embedding's gradient is a scatter-add into a
    bf16 table, repeated tokens added in bf16 one after another, as JAX's
    (bit for bit, from the same cotangent; 8 distinct tokens over 64), and
    then widened under route (A)."""
    jnp = jx.jnp
    pd = BF16 if route == "B" else torch.float32
    cfg = get_smoke_config(ARCH)
    tp = params_from_jax(weights[route], cfg, "cpu", dtype=pd)
    emb = tp.embed.detach().clone().requires_grad_(True)
    toks = np.random.default_rng(5).integers(0, 8, (4, 16))
    ct = np.random.default_rng(6).normal(size=(4, 16, cfg.d_model)) \
        .astype(np.float32)
    jemb = jnp.asarray(weights[route]["embed"],
                       jnp.bfloat16 if route == "B" else jnp.float32)
    jcfg = jx.Session.from_config(ARCH).cfg
    (jg,) = jx.jax.jit(lambda e, c: jx.jax.vjp(
        lambda e: jx.transformer._embed_inputs(
            {"embed": e}, jcfg, {"tokens": jnp.asarray(toks)},
            jnp.bfloat16), e)[1](c))(jemb, jnp.asarray(ct, jnp.bfloat16))
    x = transformer._embed_inputs(SimpleNamespace(embed=emb),
                                  torch.as_tensor(toks), None, BF16)
    (tg,) = torch.autograd.grad(x, emb, torch.as_tensor(ct).to(BF16))
    assert tg.dtype == pd
    np.testing.assert_array_equal(tg.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))
    # the whole step on such a batch
    js, ts, jstate, tstate = _sessions(jx, weights, route)
    batch, tbatch = _batch(js, vocab=8)
    _fused_step_vs_jax(jx, js, ts, jstate, tstate, batch, tbatch)


# ---------------------------------------------------------------------------
# the tiers


def _fused_step_vs_jax(jx, js, ts, jstate, tstate, batch, tbatch):
    """One fused step: JAX's ``_fused_grads`` and AdamW against the port's
    ``_fused_grads`` and ``build_train_step``."""
    jnp, jax = jx.jnp, jx.jax
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
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms),
                               rtol=NORM_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tbound), float(jbound), rtol=NORM_RTOL)
    got = flatbuf.zero_padding(tstate.layout, tn).numpy()
    np.testing.assert_allclose(got, _jax_packed(jx, jn), atol=NOISY_ATOL,
                               rtol=0)
    assert tns.prev_key == tuple(int(x) for x in np.asarray(jns.prev_key))
    jopt = jx.make_optimizer(js.run_cfg.optimizer)
    jnew, jopt_state = jax.jit(jopt.update)(
        jstate.params, jstate.opt_state, jax.tree.map(lambda g: g / 4.0, jn),
        jnp.asarray(LR, jnp.float32))
    tnew, tm = tsteps.build_train_step(ts.model, ts.run_cfg)(
        tstate, tbatch, prng.PRNGKey(1), timer=tsteps.StageTimer("cpu"))
    np.testing.assert_allclose(tm["loss"], float(jloss), rtol=LOSS_RTOL)
    _master_close(jx, tnew, jopt_state["master"])
    assert tnew.step == 1
    if tnew.weights is not None:
        _bf16_is_round_of_master(tnew)
        # JAX's bf16 weights are its master rounded: the same but where
        # the masters straddle a rounding boundary
        want = _jax_packed(jx, jnew)
        assert np.mean(tnew.weights.float().numpy() != want) <= FLIP_SHARE


@pytest.mark.parametrize("route", ["A", "B"])
def test_fused_step_matches_jax(jx, weights, route):
    js, ts, jstate, tstate = _sessions(jx, weights, route,
                                       clip_percentile_max=8.0)
    assert (tstate.weights is None) == (route == "A")
    assert tstate.opt_state["master"].dtype == torch.float32
    np.testing.assert_array_equal(tstate.opt_state["master"].numpy(),
                                  _jax_packed(jx, jstate.opt_state["master"]))
    batch, tbatch = _batch(js)
    _fused_step_vs_jax(jx, js, ts, jstate, tstate, batch, tbatch)


@pytest.mark.parametrize("route", ["A", "B"])
def test_scan_step_matches_jax(jx, weights, route):
    """JAX's dry-run privacy: the silo-serial tier, ``per_silo`` clipping,
    the bf16 gradients widened into the fp32 accumulator
    (``gg.astype(jnp.float32)``), a dropped silo."""
    jnp, jax = jx.jnp, jx.jax
    js, ts, jstate, tstate = _sessions(jx, weights, route, **DRYRUN)
    batch, tbatch = _batch(js)
    act = np.array([True, True, False, True])
    jkeys = jx.step_keys(jax.random.PRNGKey(1), 0)
    tkeys = step_keys(prng.PRNGKey(1), 0)
    jn, jloss, jnorms, jns, jbound = jx.steps._fused_grads_scan(
        js.model, js.run_cfg.privacy, jstate.params, batch, 4, jkeys,
        jstate.noise_state, jstate.clip_bound, jkeys.key_clip,
        active=jnp.asarray(act))
    before = dispatch.launch_counts()
    tn, tloss, tnorms, tns, tbound = tsteps._fused_grads_scan(
        ts.model, ts.run_cfg.privacy, tstate.params, tbatch, 4, tkeys,
        tstate.noise_state, tstate.clip_bound, tkeys.key_clip, tstate.layout,
        tsteps.StageTimer("cpu"), active=act)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms),
                               rtol=NORM_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tbound), float(jbound), rtol=NORM_RTOL)
    got = flatbuf.zero_padding(tstate.layout, tn).numpy()
    np.testing.assert_allclose(got, _jax_packed(jx, jn), atol=NOISY_ATOL,
                               rtol=0)
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

z = np.load(sys.argv[1])
weights = {}
for k in z.files:
    if k.startswith("w/"):
        node = weights
        *parents, name = k[2:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(z[k], jnp.bfloat16)
priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                     dynamic_clip=True, noise_lambda=0.7, sync_path="barrier",
                     clip_percentile_max=8.0)
mesh_cfg = MeshConfig((4,), ("data",))
sess = Session.from_config("qwen2.5-3b", privacy=priv, mesh=mesh_cfg,
                           optimizer=OptimizerConfig(name="adamw", lr=1e-3))
model = dataclasses.replace(
    build_model(sess.cfg, param_dtype=jnp.bfloat16,
                compute_dtype=jnp.bfloat16), init=lambda key: weights)
sess = dataclasses.replace(sess, model=model)
state = steps.init_train_state(model, sess.run_cfg, jax.random.PRNGKey(0))
layout = flatbuf.layout_of(state.params)
mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
keys = step_keys(jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
batch = {"tokens": jnp.asarray(z["tokens"]), "labels": jnp.asarray(z["labels"])}
with set_mesh(mesh):
    agg, loss, norms, new_ns, bound = jax.jit(
        lambda p, b, a, ns, c: steps._barrier_grads(
            model, priv, mesh_cfg, p, b, keys, ns, c, keys.key_clip, mesh,
            active=a))(state.params, batch, jnp.asarray(z["active"]),
                       state.noise_state, state.clip_bound)
res = sess.train(state=state, steps=3, batch_size=16, seq_len=16,
                 log_every=0, silo_schedule=lambda t: [True, True, t != 1,
                                                       True])
train = {"train_" + k: np.array([m[k] for m in res.metrics], np.float64)
         for k in ("loss", "clip_bound", "n_contributions", "epsilon")}
np.savez(sys.argv[2], agg=np.asarray(flatbuf.pack(layout, agg)),
         loss=np.asarray(loss), norms=np.asarray(norms).reshape(-1),
         bound=np.asarray(bound), prev_key=np.asarray(new_ns.prev_key),
         prev_active=np.asarray(new_ns.prev_active), **train,
         train_master=np.asarray(flatbuf.pack(
             layout, res.state.opt_state["master"])),
         train_prev_key=np.asarray(res.state.noise_state.prev_key),
         train_steps=np.asarray(res.step))
print("OK")
"""


def _flat(tree, prefix="w"):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                   else {f"{prefix}/{k}": v})
    return out


def _barrier_session():
    return _port_session("B", mesh=MeshConfig((4,), ("data",)),
                         sync_path="barrier", clip_percentile_max=8.0)


ACTIVE = np.array([True, True, False, True])


@pytest.fixture(scope="module")
def barrier_runs(weights, tmp_path_factory):
    """JAX's route (B) barrier step (silo 2 dropped) and 3 barrier steps
    through its ``Session.train`` (silo 2 out at the second), on a
    4-device host mesh in a subprocess, from the port's inputs."""
    pytest.importorskip("jax")
    tmp_path = tmp_path_factory.mktemp("bf16_barrier")
    batch = {k: v.numpy() for k, v in
             _barrier_session().synthetic_batches(16, 16)().items()}
    np.savez(tmp_path / "in.npz", **_flat(weights["B"]), **batch,
             active=ACTIVE)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", JAX_BARRIER,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"
    return batch, dict(np.load(tmp_path / "out.npz"))


def test_barrier_step_with_a_drop_matches_jax(weights, barrier_runs):
    """Route (B) on the barrier tier, silo 2 dropped: the port's
    ``_barrier_grads`` against JAX's under ``shard_map``. The
    contributions' +-B*r masks cancel only in the sum, which keeps a few
    fp32 ulps of 10 B (``tests/test_torch_barrier.py``): under
    ``NOISY_ATOL`` here."""
    batch, want = barrier_runs
    active = ACTIVE
    ts = _barrier_session()
    state = ts.init_state(params=params_from_jax(weights["B"], ts.cfg, "cpu",
                                                 dtype=BF16))
    keys = step_keys(prng.PRNGKey(1), 0)
    agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
        ts.model, ts.run_cfg.privacy, ts.run_cfg.mesh, state.params,
        {k: torch.as_tensor(v) for k, v in batch.items()}, keys,
        state.noise_state, state.clip_bound, keys.key_clip, state.layout,
        tsteps.StageTimer("cpu"), active=active)
    np.testing.assert_allclose(norms.numpy(), want["norms"], rtol=NORM_RTOL)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(bound), want["bound"], rtol=NORM_RTOL)
    got = flatbuf.zero_padding(state.layout, agg).numpy()
    np.testing.assert_allclose(got, want["agg"], atol=NOISY_ATOL, rtol=0)
    assert new_ns.prev_key == tuple(int(x) for x in want["prev_key"])
    np.testing.assert_array_equal(new_ns.prev_active, want["prev_active"])
    np.testing.assert_array_equal(new_ns.prev_active, active)


def test_session_train_barrier_matches_jax(weights, barrier_runs):
    """3 route (B) barrier steps through ``Session.train``, silo 2 out at
    the second, against JAX's (the tolerances of
    :func:`test_session_train_matches_jax`)."""
    _, want = barrier_runs
    ts = _barrier_session()
    state = ts.init_state(params=params_from_jax(weights["B"], ts.cfg, "cpu",
                                                 dtype=BF16))
    res = ts.train(state=state, steps=3, batch_size=16, seq_len=16,
                   log_every=0, silo_schedule=_drop_silo_2_at_step_1)
    assert res.step == int(want["train_steps"]) == 3
    got = [m["loss"] for m in res.metrics]
    np.testing.assert_allclose(got[0], want["train_loss"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1:], want["train_loss"][1:],
                               rtol=LOSS_TRAIN_RTOL)
    np.testing.assert_allclose([m["clip_bound"] for m in res.metrics],
                               want["train_clip_bound"], rtol=NORM_RTOL)
    assert [m["n_contributions"] for m in res.metrics] == \
        list(want["train_n_contributions"]) == [4.0, 3.0, 4.0]
    assert [m["epsilon"] for m in res.metrics] == list(want["train_epsilon"])
    assert res.state.noise_state.prev_key == tuple(
        int(x) for x in want["train_prev_key"])
    diff = np.abs(res.state.opt_state["master"].numpy()
                  - want["train_master"])
    assert diff.max() <= PARAM_ATOL and np.mean(diff > LR / 10) <= FLIP_SHARE
    _bf16_is_round_of_master(res.state)


def _drop_silo_2_at_step_1(step):
    return [True, True, step != 1, True]


@pytest.mark.parametrize("route,tier", [("A", "fused"), ("B", "fused"),
                                        ("A", "scan"), ("B", "scan")])
def test_session_train_matches_jax(jx, weights, route, tier):
    """3 steps through ``Session.train`` (silo 2 out at step 1): loss
    within ``LOSS_RTOL`` at the first step and ``LOSS_TRAIN_RTOL`` after,
    clip bound within ``NORM_RTOL``, epsilon and the step count equal, the
    carried key bit-equal, the master within ``PARAM_ATOL``, and under
    route (B) the bf16 weights the rounded master."""
    priv = DRYRUN if tier == "scan" else {}
    js, ts, jstate, tstate = _sessions(jx, weights, route, **priv)
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0,
              silo_schedule=_drop_silo_2_at_step_1)
    jres = js.train(state=jstate, **kw)
    before = dispatch.launch_counts()
    tres = ts.train(state=tstate, **kw)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    assert tres.step == jres.step == 3
    for t, (tm, jm) in enumerate(zip(tres.metrics, jres.metrics)):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL
                                   if t == 0 else LOSS_TRAIN_RTOL)
        np.testing.assert_allclose(tm["clip_bound"], jm["clip_bound"],
                                   rtol=NORM_RTOL)
        assert tm["n_contributions"] == jm["n_contributions"]
        assert tm["epsilon"] == jm["epsilon"]
        assert tm["epsilon_per_silo"] == jm["epsilon_per_silo"]
    assert [m["n_contributions"] for m in tres.metrics] == [4.0, 3.0, 4.0]
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))
    np.testing.assert_array_equal(
        tres.state.noise_state.prev_active,
        np.asarray(jres.state.noise_state.prev_active))
    _master_close(jx, tres.state, jres.state.opt_state["master"])
    if route == "B":
        _bf16_is_round_of_master(tres.state)
    assert ts.privacy_report() == js.privacy_report()


# ---------------------------------------------------------------------------
# checkpoints


def _entries(path: Path) -> dict:
    m = json.loads((path / "manifest.json").read_text())
    return {e["path"]: e for e in m["entries"]}


def test_bf16_checkpoint_both_ways(jx, weights, tmp_path):
    """A route (B) state after one step: the port's checkpoint round-trips
    bit for bit; every entry of it is byte for byte JAX's ``save`` of the
    same state (``"dtype": "bfloat16"``, the raw 2-byte values); JAX's
    checkpoint restores into the port; and JAX restores the port's (its
    fp32 and integer entries through JAX's ``restore``; its weights, which
    JAX's ``restore`` cannot read back from any bf16 checkpoint, its own
    included, as the master rounded, the bytes the port wrote)."""
    jnp, jax = jx.jnp, jx.jax
    js, ts, jstate, tstate = _sessions(jx, weights, "B")
    tstate, _ = tsteps.build_train_step(ts.model, ts.run_cfg)(
        tstate, ts.synthetic_batches(16, 16)(), prng.PRNGKey(1),
        timer=tsteps.StageTimer("cpu"))
    checkpointer.save(tmp_path / "port", 1, tstate)
    entries = _entries(tmp_path / "port" / "step_00000001")
    assert entries[".params/embed"]["dtype"] == "bfloat16"
    assert entries[".opt_state/master/embed"]["dtype"] == "float32"
    # the port's round trip, into a fresh state
    fresh = ts.init_state()
    restored, _, step = checkpointer.restore(tmp_path / "port", fresh)
    assert step == 1 and restored.step == tstate.step
    for k in ("master", "m", "v"):
        assert torch.equal(restored.opt_state[k], tstate.opt_state[k])
    assert torch.equal(restored.weights, tstate.weights)
    _bf16_is_round_of_master(restored)
    assert restored.noise_state.prev_key == tstate.noise_state.prev_key
    # JAX's save of the same state: the same files
    jtrees = {}
    for name, buf in (("params", tstate.weights),
                      ("master", tstate.opt_state["master"]),
                      ("m", tstate.opt_state["m"]),
                      ("v", tstate.opt_state["v"])):
        tree = flatbuf.unpack(tstate.layout, buf, dtype=buf.dtype)
        np_tree = params_to_numpy_tree(tree)
        jtrees[name] = jax.tree.map(
            lambda a, dt=(jnp.bfloat16 if name == "params"
                          else jnp.float32): jnp.asarray(a, dt), np_tree)
    ns = tstate.noise_state
    jsame = jstate._replace(
        params=jtrees["params"],
        opt_state={"master": jtrees["master"], "m": jtrees["m"],
                   "v": jtrees["v"],
                   "count": jnp.asarray(tstate.opt_state["count"],
                                        jnp.int32)},
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
    # JAX's checkpoint into the port
    back, _, _ = checkpointer.restore(tmp_path / "jax", ts.init_state())
    assert torch.equal(back.weights, tstate.weights)
    assert torch.equal(back.opt_state["master"], tstate.opt_state["master"])
    # the port's checkpoint into JAX
    with pytest.raises(ValueError, match="cast"):
        jx.ckpt.restore(tmp_path / "jax", jsame)  # JAX's own bf16 leaves
    jback, _, _ = jx.ckpt.restore(tmp_path / "port",
                                  jsame._replace(params=None))
    np.testing.assert_array_equal(
        _jax_packed(jx, jback.opt_state["master"]),
        tstate.opt_state["master"].numpy())
    assert tuple(int(x) for x in np.asarray(jback.noise_state.prev_key)) \
        == ns.prev_key
    jw = jax.tree.map(lambda m: m.astype(jnp.bfloat16),
                      jback.opt_state["master"])
    raw = np.load(tmp_path / "port" / "step_00000001" /
                  entries[".params/embed"]["file"])
    np.testing.assert_array_equal(
        raw.view(np.uint16), np.asarray(jw["embed"]).view(np.uint16))


def test_bf16_session_resumes_bit_for_bit(weights, tmp_path):
    """Route (B) through the Trainer: 2 steps checkpointed, then a resume
    to step 3, equal bit for bit to 3 uninterrupted steps (master, moments,
    bf16 weights, carried key, ledger, metrics history)."""
    tokens = synthetic_tokens(32, 16, get_smoke_config(ARCH).vocab_size,
                              seed=5)

    def run(steps, ckpt):
        ts = _port_session("B")
        fb = FederatedBatcher(ArrayDataset(tokens[:, :-1], tokens[:, 1:])
                              .split(4), per_silo_batch=4)

        def next_batch():
            b = fb.next()
            return {"tokens": torch.as_tensor(b["x"], dtype=torch.long),
                    "labels": torch.as_tensor(b["y"], dtype=torch.long)}
        tr = Trainer(ts.model, ts.run_cfg, TrainerConfig(
            total_steps=steps, checkpoint_every=2, log_every=0,
            checkpoint_dir=ckpt), next_batch, batch_state=fb)
        state = ts.init_state(params=params_from_jax(
            weights["B"], ts.cfg, "cpu", dtype=BF16))
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
    _bf16_is_round_of_master(resumed)
    assert resumed.noise_state.prev_key == whole.noise_state.prev_key
    assert [m["loss"] for m in tr.metrics_log] == \
        [m["loss"] for m in wtr.metrics_log]
    assert [m["epsilon"] for m in tr.metrics_log] == \
        [m["epsilon"] for m in wtr.metrics_log]


def params_to_numpy_tree(tree: dict) -> dict:
    """A flat port tree (stacked leaves as lists) as JAX's nested numpy
    tree, bf16 tensors widened exactly."""
    out: dict = {}
    for path, leaf in tree.items():
        *parents, name = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        parts = leaf if isinstance(leaf, list) else [leaf]
        arrs = [t.float().numpy() for t in parts]
        node[name] = np.stack(arrs) if isinstance(leaf, list) else arrs[0]
    return out


# ---------------------------------------------------------------------------
# the clip modes


@pytest.mark.parametrize("mode,route", [("per_example", "A"),
                                        ("per_microbatch", "A"),
                                        ("per_silo", "B")])
def test_clip_modes_over_bf16_compute_match_jax(jx, weights, mode, route):
    """Each granularity's clipped sum against JAX's ``silo_grad`` over 8
    examples (4 groups of 2): per-example and per-microbatch over route
    (A), the bf16 forward with fp32 gradients; per-silo over route (B),
    its clipped bf16 gradient tree rounded as JAX's."""
    from repro.core import barrier as jbarrier
    from repro_torch.core import barrier as tbarrier
    jnp, jax = jx.jnp, jx.jax
    js, ts, jstate, tstate = _sessions(jx, weights, route, clip_mode=mode)
    batch, tbatch = _batch(js)
    b = {k: v[:8] for k, v in batch.items()}
    tb = {k: v[:8] for k, v in tbatch.items()}
    jg, jnorms, jloss = jax.jit(lambda p, b: jbarrier.silo_grad(
        js.model.loss, p, b, js.run_cfg.privacy, 1.0))(jstate.params, b)
    tg, tnorms, tloss = tbarrier.silo_grad(ts.model.loss, tstate.params, tb,
                                           ts.run_cfg.privacy, 1.0)
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms),
                               rtol=EXAMPLE_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    got = flatbuf.pack(tstate.layout, tg).numpy()
    np.testing.assert_allclose(got, _jax_packed(jx, jg), atol=NOISY_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


def _card_and_cpu(cuda):
    """Route (B) sessions on the card and on the CPU, one weight set."""
    out = []
    for dev in (cuda, torch.device("cpu")):
        s = Session.from_config(
            ARCH, device=dev, compute_dtype=BF16,
            privacy=PrivacyConfig(**QUICKSTART),
            optimizer=OptimizerConfig(name="adamw", lr=LR))
        out.append(dataclasses.replace(s, model=build_model(
            s.cfg, dev, param_dtype=BF16, compute_dtype=BF16)))
    return out


def test_card_fused_step_route_b_matches_cpu(cuda):
    """One route (B) fused step on the card and on the CPU from the same
    bf16 weights and batch: cuBLAS's bf16 products sum in another order,
    so held as the port to JAX; the carried key bit-equal."""
    s_g, s_c = _card_and_cpu(cuda)
    w = _weights(BF16)
    states = [s.init_state(params=params_from_jax(w, s.cfg, s.device,
                                                  dtype=BF16))
              for s in (s_g, s_c)]
    batch = s_c.synthetic_batches(16, 16)()
    dispatch.reset_launches()
    out = [tsteps.build_train_step(s.model, s.run_cfg)(
        st, {k: v.to(s.device) for k, v in batch.items()}, prng.PRNGKey(1),
        timer=tsteps.StageTimer(s.device)) for s, st in zip((s_g, s_c),
                                                            states)]
    counts = dispatch.launch_counts()
    assert counts.get("clip_accumulate") == 1 and \
        counts.get("noise_batch") == 1, counts
    (g_state, g_m), (c_state, c_m) = out
    np.testing.assert_allclose(float(g_m["loss"]), float(c_m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(g_m["clip_bound"]),
                               float(c_m["clip_bound"]), rtol=NORM_RTOL)
    diff = (g_state.opt_state["master"].cpu()
            - c_state.opt_state["master"]).abs()
    assert diff.max() <= PARAM_ATOL and (diff > 1e-6).float().mean() \
        <= FLIP_SHARE
    assert g_state.noise_state.prev_key == c_state.noise_state.prev_key
    _bf16_is_round_of_master(g_state)


def test_card_bf16_silo_gradient_repeats_bit_for_bit(cuda):
    """One silo's bf16 gradient computed twice on the card: bit-equal
    (cuBLAS with ``allow_bf16_reduced_precision_reduction`` off, set by
    ``Session.from_config``)."""
    s_g, _ = _card_and_cpu(cuda)
    state = s_g.init_state()
    batch = {k: v[:4] for k, v in s_g.synthetic_batches(16, 64)().items()}
    tensors = flatbuf.flat_tensors(state.layout,
                                   packing.param_tree(state.params))
    grads = []
    for _ in range(2):
        loss = s_g.model.loss(state.params, batch)
        g = torch.autograd.grad(loss, tensors)
        grads.append(flatbuf.pack_tensors(state.layout, g))
    assert all(t.dtype == BF16 for t in g)
    assert torch.equal(grads[0], grads[1])
