"""The MoE, VLM and encoder families (phi3.5-moe-42b-a6.6b,
qwen3-moe-235b-a22b, qwen2-vl-72b, hubert-xlarge) in the port against the
JAX package at their smoke configs in fp32, from the same weights (the
port's init as JAX's numpy tree, into the port by ``params_from_jax``),
inputs drawn with numpy.

* Configs field by field; weights across and back; the packed layout's
  offsets equal to ``core/flatbuf.py``'s on JAX's tree (the MoE leaves
  ``layers.moe.{router, we_down, we_gate, we_up}`` in JAX's order).
* ``loss`` on tokens and on ``embeds`` (qwen2-vl with distinct (3, B, S)
  M-RoPE position ids), the MoE aux term included.
* M-RoPE: ``apply_rope`` and ``mrope_sections_for`` against JAX's with
  distinct t, h and w ids (JAX's own smoke test feeds equal ones, where
  M-RoPE equals plain RoPE).
* Prefill then decode against the parallel forward and against JAX's
  (``tests/test_serving.py:22`` of the JAX package); qwen2-vl's prefill on
  ``embeds`` with M-RoPE positions against ``forward`` without a cache.
* ``Session.serve`` token for token against JAX's: direct, wave and
  continuous for phi3.5-moe and qwen2-vl; qwen3-moe continuous, and at the
  published capacity factor 1.25, where tokens drop. The encoder refuses
  to decode (the session and the CLI), as JAX's does.
* 3 fused ``Session.train`` steps against JAX's: phi3.5-moe on tokens (its
  aux loss in the loss), hubert-xlarge on frame ``embeds``, qwen2-vl on
  ``embeds`` with (3, B, S) positions split over the silos.
* One barrier step of qwen2-vl with (3, B, S) positions and a dropped silo
  against JAX's ``_barrier_grads`` under ``shard_map`` on a 4-device host
  mesh in a subprocess (as ``tests/test_torch_barrier.py`` runs it).
* Both CLIs take the new archs.

Tolerances, as ``test_torch_serving.py`` / ``test_torch_training.py``:
logits 1e-5 (absolute and relative), losses, bounds and norms 1e-5
relative, parameters 1e-5 absolute after 3 AdamW steps, the barrier
aggregate within 8 ulps of 10 B (``test_torch_barrier.py``).
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
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro.distributed import steps as jsteps
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serving import zipf_requests as jax_zipf_requests
from repro_torch.api import Session
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro_torch.core import flatbuf, prng
from repro_torch.core.barrier import step_keys
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import moe, packing, transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.layers import (apply_rope, chunked_lm_loss,
                                       mrope_sections_for)
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import zipf_requests

ROOT = Path(__file__).resolve().parents[1]
PHI, QWEN3, VL, HUBERT = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                          "qwen2-vl-72b", "hubert-xlarge")
ARCHS = (PHI, QWEN3, VL, HUBERT)
LOGIT_ATOL = LOGIT_RTOL = 1e-5
RTOL = 1e-5
PARAM_ATOL = 1e-5
AGG_ATOL_PER_B = 8 * 2.0 ** -23 * 10
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4)
LR = 1e-3


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
    """arch -> (JAX model, JAX params, the weights as JAX's numpy tree,
    port config, port params): the port's random init (seed 0) carried
    across through numpy to both packages."""
    out = {}
    for arch in ARCHS:
        jmodel = jax_build_model(jax_smoke_config(arch),
                                 compute_dtype=jnp.float32)
        cfg = get_smoke_config(arch)
        tree = params_to_numpy(transformer.init(
            torch.Generator().manual_seed(0), cfg, "cpu"))
        out[arch] = (jmodel, jax.tree.map(jnp.asarray, tree), tree, cfg,
                     params_from_jax(tree, cfg, "cpu"))
    return out


def _positions(B, S, rng):
    """Distinct (3, B, S) M-RoPE ids: t the token index, h and w a patch
    grid's rows and columns, none equal to another axis."""
    t = np.broadcast_to(np.arange(S), (B, S))
    h = rng.integers(0, 5, (B, S)) + np.arange(S) // 4
    w = rng.integers(0, 7, (B, S)) + 2 * (np.arange(S) % 4)
    pos = np.stack([t, h, w]).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return pos


def _batch(cfg, kind, B, S, seed):
    """numpy batch: tokens and labels, or frontend embeds and labels (with
    distinct M-RoPE positions for an M-RoPE config)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if kind == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32), "labels": labels}
    batch = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32), "labels": labels}
    if cfg.mrope:
        batch["positions"] = _positions(B, S, rng)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and weights


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    assert arch in PORTED
    for port, jcfg in ((get_config(arch), jax_config(arch)),
                       (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(jcfg, f.name), f.name
    full = get_config(arch)
    want = {PHI: (32, 4096, 32, 8, 128, 6400, 32064, 16, 2),
            QWEN3: (94, 4096, 64, 4, 128, 1536, 151936, 128, 8),
            VL: (80, 8192, 64, 8, 128, 29568, 152064, 0, 0),
            HUBERT: (48, 1280, 16, 16, 80, 5120, 504, 0, 0)}
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.d_ff, full.vocab_size, full.n_experts,
            full.top_k) == want[arch]
    smoke = get_smoke_config(arch)
    if smoke.is_moe():
        assert smoke.moe_capacity_factor == 4.0 and smoke.top_k == 2
        assert full.moe_capacity_factor == 1.25


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_across_back_and_pack_in_jax_layout(weights, arch):
    jmodel, jparams, tree, cfg, tparams = weights[arch]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
    got = params_to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    if cfg.is_moe():
        L, E, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
        m = got["layers"]["moe"]
        assert (m["router"].shape, m["we_gate"].shape, m["we_down"].shape) \
            == ((L, d, E), (L, E, d, f), (L, E, f, d))
        assert tparams.layers[0].moe.router.dtype == torch.float32
    jl = jflat.layout_of(jparams)
    tl = flatbuf.layout_of(packing.param_tree(tparams))
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.total == jl.total
    if cfg.is_moe():
        moe_paths = [p for p in tl.paths if ".moe." in p]
        assert moe_paths == ["layers.moe.router", "layers.moe.we_down",
                             "layers.moe.we_gate", "layers.moe.we_up"]
    back = params_from_jax(got, cfg, "cpu")
    for (n, a), (_, b) in zip(back.named_parameters(),
                              tparams.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the loss, M-RoPE, prefill and decode


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["tokens", "embeds"])
def test_loss_matches_jax(weights, arch, kind):
    jmodel, jparams, _, cfg, tparams = weights[arch]
    batch = _batch(cfg, kind, 2, 16, seed=1)
    want = float(jax.jit(jmodel.loss)(jparams,
                                      jax.tree.map(jnp.asarray, batch)))
    got = build_model(cfg, "cpu").loss(tparams, _torch(batch))
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    if cfg.is_moe():  # the aux term is in: the LM loss alone is lower
        tb = _torch(batch)
        hidden = transformer.forward(tparams, cfg, tb.get("tokens"),
                                     logits_mode="hidden",
                                     embeds=tb.get("embeds"))
        lm = chunked_lm_loss(hidden, tparams.head(), tb["labels"])
        assert float(got) - float(lm) > 0.5 * transformer.AUX_LOSS_WEIGHT


def test_mrope_matches_jax_with_distinct_axes():
    for d_rot in (16, 80, 128):
        assert mrope_sections_for(d_rot) == jlayers.mrope_sections_for(d_rot)
    assert mrope_sections_for(128) == (16, 24, 24)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = _positions(2, 9, rng)
    sec = mrope_sections_for(16)
    tx = torch.from_numpy(x)
    rope = jax.jit(jlayers.apply_rope, static_argnums=(2, 3, 4))
    for p, s in ((pos, sec), (pos, None), (pos[0], sec)):
        want = rope(jnp.asarray(x), jnp.asarray(p), 1e6, 1.0, s)
        got = apply_rope(tx, torch.from_numpy(p), 1e6, 1.0, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    # distinct axes: M-RoPE differs from rotating by the t axis alone, and
    # 3-D ids without sections rotate by the t axis
    m = apply_rope(tx, torch.from_numpy(pos), 1e6, 1.0, sec)
    t = apply_rope(tx, torch.from_numpy(pos[0]), 1e6, 1.0)
    assert (m - t).abs().max() > 1e-2
    torch.testing.assert_close(apply_rope(tx, torch.from_numpy(pos), 1e6),
                               t, rtol=0, atol=0)


@pytest.mark.parametrize("arch", [PHI, QWEN3, VL])
def test_prefill_then_decode_matches_forward_and_jax(weights, arch):
    jmodel, jparams, _, cfg, tparams = weights[arch]
    T, Tpre = 10, 6
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, T))
    jfull = jax.jit(lambda p, t: jtransformer.forward(
        p, jax_smoke_config(arch), {"tokens": t},
        compute_dtype=jnp.float32)[0])(jparams, jnp.asarray(toks))
    model = build_model(cfg, "cpu")
    with torch.inference_mode():
        full = transformer.forward(tparams, cfg, torch.from_numpy(toks))
        np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        cache = model.init_cache(2, T)
        logits = [model.prefill(tparams, torch.from_numpy(toks[:, :Tpre]),
                                cache)]
        logits += [model.decode_step(tparams, torch.from_numpy(
            toks[:, t:t + 1]), cache) for t in range(Tpre, T)]
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(2, T)
    jl, jcache = prefill(jparams, {"tokens": jnp.asarray(toks[:, :Tpre])},
                         jcache)
    want = [jl]
    for t in range(Tpre, T):
        jl, jcache = decode(jparams, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, jcache)
        want.append(jl)
    for i, (got, w) in enumerate(zip(logits, want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_allclose(got.numpy(), full[:, Tpre - 1 + i].numpy(),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_vlm_prefill_on_embeds_with_mrope_matches_forward(weights):
    """qwen2-vl's frontend embeddings with distinct (3, B, S) ids: the
    prefill through flash attention (its plain version here) gives the
    last logits of ``forward`` without a cache, and JAX's; a decode step
    after it continues on plain positions, as JAX's does."""
    jmodel, jparams, _, cfg, tparams = weights[VL]
    batch = _batch(cfg, "embeds", 2, 12, seed=4)
    tb = _torch(batch)
    model = build_model(cfg, "cpu")
    nxt = np.array([[3], [7]])
    with torch.inference_mode():
        full = transformer.forward(tparams, cfg, None, embeds=tb["embeds"],
                                   positions=tb["positions"])
        cache = model.init_cache(2, 13)
        last = model.prefill(tparams, None, cache, embeds=tb["embeds"],
                             positions=tb["positions"])
        step = model.decode_step(tparams, torch.from_numpy(nxt), cache)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    jcache = jmodel.init_cache(2, 13)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    jlast, jcache = jax.jit(jmodel.prefill)(jparams, jb, jcache)
    jstep, _ = jax.jit(jmodel.decode_step)(
        jparams, {"tokens": jnp.asarray(nxt)}, jcache)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # the ids matter: plain positions give other logits
    with torch.inference_mode():
        plain = transformer.forward(tparams, cfg, None, embeds=tb["embeds"])
    assert (plain[:, -1] - full[:, -1]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# Session.serve


SERVE_CASES = [(PHI, "direct"), (PHI, "wave"), (PHI, "continuous"),
               (VL, "direct"), (VL, "wave"), (VL, "continuous"),
               (QWEN3, "continuous")]


@pytest.mark.parametrize("arch,mode", SERVE_CASES)
def test_serve_matches_jax_token_for_token(weights, arch, mode):
    _, jparams, _, cfg, tparams = weights[arch]
    sess = Session.from_config(arch, device="cpu")
    before = dispatch.launch_counts()
    if mode == "direct":
        prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 11))
        want = JaxSession.from_config(arch).serve(
            prompt=jnp.asarray(prompt, jnp.int32), params=jparams,
            max_new_tokens=6)
        got = sess.serve(prompt=prompt, params=tparams, max_new_tokens=6)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(got.logits.numpy(),
                                   np.asarray(want.logits),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    else:
        kw = dict(min_len=4, max_len=9, max_new_low=2, max_new_high=6,
                  seed=6)
        j_reqs = jax_zipf_requests(6, cfg.vocab_size, **kw)
        t_reqs = zipf_requests(6, cfg.vocab_size, **kw)
        skw = dict(scheduler=mode, max_batch=3, max_len=24, page_size=4,
                   prefill_chunk=4)
        want = JaxSession.from_config(arch).serve(requests=j_reqs,
                                                  params=jparams, **skw)
        got = sess.serve(requests=t_reqs, params=tparams, **skw)
        assert got.stats.drained
        for rj, rt in zip(j_reqs, t_reqs):
            np.testing.assert_array_equal(rt.prompt, rj.prompt)
            assert rt.generated == rj.generated, f"rid {rt.rid} diverged"
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert dispatch.launch_counts() == before  # CPU: plain versions only


def test_qwen3_moe_continuous_drops_tokens_as_jax_does(weights, monkeypatch):
    """At the published capacity factor 1.25 a decode step of 3 slots
    routes 3 rows (inactive slots included) into 8 experts of capacity 2,
    and prefill chunks of 12 rows into capacity 3: picks drop, and the
    port drops the same ones as JAX (the same tokens, the same logits)."""
    _, jparams, _, cfg, tparams = weights[QWEN3]
    cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    jcfg = dataclasses.replace(jax_smoke_config(QWEN3),
                               moe_capacity_factor=1.25)
    dropped = []
    route = moe.route

    def spy(*a, **k):
        out = route(*a, **k)
        dropped.append(int((~out[-1]).sum()))
        return out

    monkeypatch.setattr(moe, "route", spy)
    kw = dict(min_len=3, max_len=14, max_new_low=3, max_new_high=8, seed=7)
    j_reqs = jax_zipf_requests(6, cfg.vocab_size, **kw)
    t_reqs = zipf_requests(6, cfg.vocab_size, **kw)
    skw = dict(scheduler="continuous", max_batch=3, max_len=24, page_size=4,
               prefill_chunk=4)
    want = JaxSession.from_config(jcfg).serve(requests=j_reqs,
                                              params=jparams, **skw)
    got = Session.from_config(cfg, device="cpu").serve(
        requests=t_reqs, params=tparams, **skw)
    assert sum(dropped) > 0, dropped
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.generated == rj.generated, f"rid {rt.rid} diverged"
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_encoder_refuses_to_decode(weights, capsys):
    sess = Session.from_config(HUBERT, device="cpu")
    for scheduler in (None, "wave", "continuous"):
        with pytest.raises(ValueError, match="encoder-only"):
            sess.serve(scheduler=scheduler)
        with pytest.raises(ValueError, match="encoder-only"):
            JaxSession.from_config(HUBERT).serve(scheduler=scheduler)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_cli.main(["--arch", HUBERT, "--device", "cpu"])


# ---------------------------------------------------------------------------
# training


def _sessions(arch, tree, priv, mesh=None):
    """(JAX session, port session, JAX TrainState, port TrainState) from
    the same weights."""
    js = JaxSession.from_config(arch, privacy=JaxPrivacy(**priv),
                                optimizer=JaxOptimizer(name="adamw", lr=LR))
    ts = Session.from_config(arch, privacy=PrivacyConfig(**priv),
                             optimizer=OptimizerConfig(name="adamw", lr=LR),
                             mesh=mesh, device="cpu")
    jmodel = dataclasses.replace(
        js.model, init=lambda key: jax.tree.map(jnp.asarray, tree))
    jstate = jsteps.init_train_state(jmodel, js.run_cfg,
                                     jax.random.PRNGKey(0))
    return js, ts, jstate, ts.init_state(
        params=params_from_jax(tree, ts.cfg, "cpu"))


def _streams(cfg, kind, B, S):
    """Two next_batch streams of the same numpy draws: JAX's and the
    port's."""
    seeds = iter(range(100, 200))
    jseeds = iter(range(100, 200))
    return (lambda: jax.tree.map(jnp.asarray,
                                 _batch(cfg, kind, B, S, next(jseeds))),
            lambda: _torch(_batch(cfg, kind, B, S, next(seeds))))


@pytest.mark.parametrize("arch,kind", [(PHI, "tokens"), (HUBERT, "embeds"),
                                       (VL, "embeds")])
def test_session_train_fused_matches_jax(weights, arch, kind):
    _, _, tree, cfg, _ = weights[arch]
    js, ts, jstate, tstate = _sessions(arch, tree, QUICKSTART)
    kw = dict(steps=3, batch_size=16, seq_len=16, log_every=0)
    if kind == "embeds":
        jnext, tnext = _streams(cfg, kind, 16, 16)
        jkw, tkw = dict(kw, next_batch=jnext), dict(kw, next_batch=tnext)
    else:
        jkw = tkw = kw
    start = np.asarray(jflat.pack(jflat.layout_of(jstate.params),
                                  jstate.params))
    jres = js.train(state=jstate, **jkw)
    before = dispatch.launch_counts()
    tres = ts.train(state=tstate, **tkw)
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
    if cfg.is_moe():  # every expert weight took gradient
        for path in ("layers.moe.router", "layers.moe.we_down"):
            i = tres.state.layout.paths.index(path)
            off, n = tres.state.layout.offsets[i], tres.state.layout.sizes[i]
            assert np.abs(got[off:off + n] - start[off:off + n]).max() > 0
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))


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
weights = {}
for k in z.files:
    if k.startswith("w/"):
        node = weights
        *parents, name = k[2:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(z[k])
sess = Session.from_config("qwen2-vl-72b", privacy=priv, mesh=mesh_cfg,
                           optimizer=OptimizerConfig(name="adamw", lr=1e-3))
model = dataclasses.replace(sess.model, init=lambda key: weights)
state = steps.init_train_state(model, sess.run_cfg, jax.random.PRNGKey(0))
batch = {k: jnp.asarray(z["b/" + k]) for k in ("embeds", "labels",
                                               "positions")}
with set_mesh(mesh):
    agg, loss, norms, new_ns, bound = jax.jit(
        lambda p, b, ns, c: steps._barrier_grads(
            model, priv, mesh_cfg, p, b, keys, ns, c, keys.key_clip, mesh,
            active=jnp.asarray(z["active"])))(
        state.params, batch, state.noise_state, state.clip_bound)
np.savez(sys.argv[2],
         agg=np.asarray(flatbuf.pack(flatbuf.layout_of(state.params), agg)),
         loss=np.asarray(loss), norms=np.asarray(norms).reshape(-1),
         bound=np.asarray(bound), prev_key=np.asarray(new_ns.prev_key))
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


def test_reshape_to_silos_splits_mrope_ids_on_their_batch_axis():
    pos = torch.arange(3 * 8 * 5).reshape(3, 8, 5)
    emb = torch.zeros(8, 5, 2)
    silos = tsteps._reshape_to_silos({"positions": pos, "embeds": emb}, 4)
    assert silos["positions"].shape == (4, 3, 2, 5)
    for i in range(4):
        assert torch.equal(silos["positions"][i], pos[:, 2 * i:2 * i + 2])
    assert silos["embeds"].shape == (4, 2, 5, 2)
    with pytest.raises(ValueError, match="does not split"):
        tsteps._reshape_to_silos({"positions": pos}, 3)


def test_vlm_barrier_step_with_mrope_ids_matches_jax(weights, tmp_path):
    _, _, tree, cfg, _ = weights[VL]
    batch = _batch(cfg, "embeds", 16, 16, seed=11)
    np.savez(tmp_path / "in.npz", active=np.asarray(ACTIVE),
             **_flat(tree, "w"), **{f"b/{k}": v for k, v in batch.items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"
    want = dict(np.load(tmp_path / "out.npz"))

    _, sess, _, state = _sessions(VL, tree, BARRIER,
                                  mesh=MeshConfig((4,), ("data",)))
    keys = step_keys(prng.PRNGKey(1), 0)
    agg, loss, norms, new_ns, bound = tsteps._barrier_grads(
        sess.model, sess.run_cfg.privacy, sess.run_cfg.mesh, state.params,
        _torch(batch), keys, state.noise_state, state.clip_bound,
        keys.key_clip, state.layout, tsteps.StageTimer("cpu"),
        active=np.asarray(ACTIVE))
    np.testing.assert_allclose(norms.numpy(), want["norms"], rtol=RTOL)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=RTOL)
    np.testing.assert_allclose(float(bound), want["bound"], rtol=RTOL)
    assert float(bound) < BARRIER["clip_percentile_max"]  # not the cap
    B = PrivacyConfig().mask_scale * BARRIER["sigma"] * float(bound)
    got = flatbuf.zero_padding(state.layout, agg).numpy()
    np.testing.assert_allclose(got, want["agg"], atol=AGG_ATOL_PER_B * B,
                               rtol=0)
    assert new_ns.prev_key == tuple(int(x) for x in want["prev_key"])


# ---------------------------------------------------------------------------
# the CLIs


def test_clis_take_the_new_archs(capsys):
    res = serve_cli.main(["--arch", PHI, "--device", "cpu", "--scheduler",
                          "continuous", "--batch", "2", "--prompt-len", "5",
                          "--tokens", "3", "--max-batch", "2"])
    assert res.stats.drained and res.tokens.shape == (2, 3)
    res = serve_cli.main(["--arch", VL, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "5", "--tokens", "2"])
    assert res.tokens.shape == (2, 2)
    for arch in (HUBERT, QWEN3):
        res = train_cli.main(["--arch", arch, "--device", "cpu", "--steps",
                              "1", "--batch", "4", "--seq", "9",
                              "--silos", "2"])
        assert res.step == 1 and np.isfinite(res.final["loss"])
    out = capsys.readouterr().out
    assert "done at step 1 on cpu" in out
