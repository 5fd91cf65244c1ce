"""Training through flash attention with remat (``registry.build_model(cfg,
device, ..., remat=True, use_flash=True)``) against the JAX package's
``build_model(..., remat=True, use_flash=True)``, the path its dry run
trains every cell on (``repro/launch/dryrun.py:91-92``). Each case starts
both packages from the same numpy weights (the port's init, seed 0) and
the same numpy batch. JAX's ``auto`` dispatch picks the blocked custom VJP
only at S >= 2048 off the TPU, so its side runs under
``REGISTRY.force_impl("blocked", kernel="flash_attention")``.

* One silo's loss and every leaf of its gradient (a batch of 4 x 16, a
  silo's share of 16 x 16), family by family: qwen2.5-3b (dense),
  phi3.5-moe (MoE, its aux term through the checkpoint), qwen2-vl (VLM, on
  embeds with distinct M-RoPE ids), hubert-xlarge (encoder: flash without
  the causal mask), zamba2-7b at 5 layers (two groups, JAX's remat unit:
  the Mamba-2 layers and the shared block; one trailing layer outside
  it), rwkv6-7b (``remat`` only: no attention). qwen2.5-3b also under
  route (B), bf16 weights over an fp32 master.
* ``remat=True`` against ``remat=False``: the loss and every gradient bit
  for bit (the recompute reruns the same ops on the same inputs).
* One step through ``Session.train`` on the fused tier for each family
  but the VLM, and on the scan tier for qwen2.5-3b, against JAX's
  ``Session.train`` over the same model: loss, clip bound, mean norm,
  contributions, epsilon, the carried noise key and the master.

Tolerances, each with the largest value measured on this CPU. fp32: the
loss ``RTOL`` 1e-5 relative (measured 1.5e-7); each gradient leaf within
``GRAD_REL`` 5e-5 of its largest |value| (measured 1.6e-5, on rwkv6's
``layers.mix.wk``, the WKV backward against JAX's autodiff; fp32 sums in
other orders, the flash backward's group fold and key walk against
JAX's); a step's metrics ``RTOL`` (measured 1.2e-6) and the master
``PARAM_ATOL`` 1e-5 (``tests/test_torch_training.py``'s; measured
4.3e-6). Route (B), bf16: ``tests/test_torch_bf16_training.py``'s
reasons, a bf16 rounding that flips in a GEMM's or a bias cotangent's sum
and travels on. The loss ``BF16_LOSS_RTOL`` 1e-4 (measured 2.4e-5,
against 9e-7 with the plain attention on the same weights and batch: op
for op, JAX's blocked forward on the same bf16 inputs is bit-equal to the
port's plain one, so the gap comes from how XLA rounds around the custom
VJP inside the jitted model, as it does around the residual add that
``transformer._layer_apply(train=True)`` follows); each leaf within
``BF16_GRAD_REL`` 4e-2 of its largest |value| (measured 1.8e-2; the plain
attention reaches 2.1e-2 on these weights); the silo's norm within
``BF16_NORM_RTOL`` 1e-3 (measured 7.7e-5). Keys, epsilon and
participation: bit-equal.

The card cases (``cuda`` fixture; without a CUDA device they skip): one
silo's flash gradient on the card computed twice, bit-equal, with
2 x layers lse forwards and 1 x layers backwards a pass (remat reruns the
forward), and held to the CPU's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import Session
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, PrivacyConfig
from repro_torch.core import flatbuf
from repro_torch.kernels import dispatch
from repro_torch.models import packing
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import build_model

QWEN, PHI, VL, HUBERT, ZAMBA, RWKV = (
    "qwen2.5-3b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "hubert-xlarge",
    "zamba2-7b", "rwkv6-7b")
# the batch each family trains on, and its depth (None: the smoke config's)
KIND = {QWEN: "tokens", PHI: "tokens", VL: "embeds", HUBERT: "embeds",
        ZAMBA: "tokens", RWKV: "tokens"}
LAYERS = {ZAMBA: 5}
QUICKSTART = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                  noise_lambda=0.7, n_silos=4)
LR = 1e-3
BF16 = torch.bfloat16
RTOL, GRAD_REL, PARAM_ATOL = 1e-5, 5e-5, 1e-5
BF16_LOSS_RTOL, BF16_GRAD_REL, BF16_NORM_RTOL = 1e-4, 4e-2, 1e-3


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
    """The JAX package's modules (imported here, so the card cases run
    where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api import Session as JaxSession
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import OptimizerConfig as JaxOptimizer
    from repro.configs.base import PrivacyConfig as JaxPrivacy
    from repro.core import flatbuf as jflat
    from repro.distributed import steps as jsteps
    from repro.kernels.dispatch import REGISTRY
    from repro.models.registry import build_model as jax_build_model
    return dataclasses.make_dataclass("JX", ["jax", "jnp", "Session",
                                             "smoke", "Optimizer", "Privacy",
                                             "flat", "steps", "REGISTRY",
                                             "build_model"])(
        jax, jnp, JaxSession, jax_smoke_config, JaxOptimizer, JaxPrivacy,
        jflat, jsteps, REGISTRY, jax_build_model)


def _blocked(jx):
    return jx.REGISTRY.force_impl("blocked", kernel="flash_attention")


def _cfg(arch):
    cut = {"n_layers": LAYERS[arch]} if arch in LAYERS else {}
    return dataclasses.replace(get_smoke_config(arch), **cut)


def _weights(arch, dtype=torch.float32, cfg=None):
    """The port's random init (seed 0) of ``cfg`` (default: the case's) as
    JAX's numpy tree (bf16 weights as exact fp32 arrays)."""
    return params_to_numpy(build_model(cfg or _cfg(arch), "cpu",
                                       param_dtype=dtype)
                           .init(torch.Generator().manual_seed(0)))


def _batch(cfg, kind, B, S, seed):
    """numpy batch: tokens and labels, or frontend embeds and labels (with
    distinct (3, B, S) M-RoPE ids for an M-RoPE config)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if kind == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32), "labels": labels}
    batch = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32), "labels": labels}
    if cfg.mrope:
        t = np.broadcast_to(np.arange(S), (B, S))
        batch["positions"] = np.stack([
            t, rng.integers(0, 5, (B, S)) + t // 4,
            rng.integers(0, 7, (B, S)) + 2 * (t % 4)]).astype(np.int32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype == np.int32
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _flags(arch):
    """JAX's switches for ``arch``: flash wherever there is attention."""
    return dict(remat=True, use_flash=arch != RWKV)


def _port_grads(arch, tree, batch, dtype=torch.float32, remat=True):
    """The port's loss and gradient tree (path -> fp32 numpy) under
    ``build_model(..., remat, use_flash)``."""
    cfg = _cfg(arch)
    model = build_model(cfg, "cpu", param_dtype=dtype, compute_dtype=dtype,
                        **dict(_flags(arch), remat=remat))
    params = params_from_jax(tree, cfg, "cpu", dtype=dtype)
    packing.pack_params(params)
    loss = model.loss(params, _torch(batch))
    loss.backward()
    # a leaf no path reaches (the embedding, under embeds) has gradient 0
    grad = lambda t: t.grad if t.grad is not None else torch.zeros_like(t)  # noqa: E731
    grads = {}
    for path, leaf in packing.param_tree(params).items():
        grads[path] = (torch.stack([grad(t) for t in leaf])
                       if isinstance(leaf, list) else grad(leaf))
    return loss, grads


def _jax_grads(jx, arch, tree, batch, dtype):
    jnp, jax = jx.jnp, jx.jax
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jcfg = dataclasses.replace(jx.smoke(arch), **(
        {"n_layers": LAYERS[arch]} if arch in LAYERS else {}))
    jmodel = jx.build_model(jcfg, param_dtype=jd, compute_dtype=jd,
                            **_flags(arch))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    with _blocked(jx):
        return jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("arch", [QWEN, PHI, VL, HUBERT, ZAMBA, RWKV])
def test_silo_gradient_matches_jax(jx, arch):
    tree = _weights(arch)
    batch = _batch(_cfg(arch), KIND[arch], 4, 16, seed=1)
    jloss, jgrad = _jax_grads(jx, arch, tree, batch, torch.float32)
    before = dispatch.launch_counts()
    loss, grads = _port_grads(arch, tree, batch)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert sorted(grads) == sorted(
        ".".join(str(getattr(k, "key", k)) for k in path) for path, _ in
        jx.jax.tree_util.tree_flatten_with_path(jgrad)[0])
    for path, got in grads.items():
        want = np.asarray(_leaf(jgrad, path))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, err_msg=path,
                                   atol=GRAD_REL * np.abs(want).max())


def test_silo_gradient_route_b_matches_jax(jx):
    """bf16 weights over an fp32 master (qwen2.5-3b): the loss, each leaf
    and the silo's norm."""
    tree = _weights(QWEN, BF16)
    batch = _batch(_cfg(QWEN), "tokens", 4, 16, seed=2)
    jloss, jgrad = _jax_grads(jx, QWEN, tree, batch, BF16)
    loss, grads = _port_grads(QWEN, tree, batch, BF16)
    np.testing.assert_allclose(loss.float().item(), float(jloss),
                               rtol=BF16_LOSS_RTOL)
    sq = jsq = 0.0
    for path, got in grads.items():
        assert got.dtype == BF16
        got = got.float().numpy()
        want = np.asarray(_leaf(jgrad, path).astype(jx.jnp.float32))
        np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                                   atol=BF16_GRAD_REL * np.abs(want).max())
        sq += float((got.astype(np.float64) ** 2).sum())
        jsq += float((want.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(np.sqrt(sq), np.sqrt(jsq), rtol=BF16_NORM_RTOL)


@pytest.mark.parametrize("arch,dtype", [
    (QWEN, torch.float32), (QWEN, BF16), (PHI, torch.float32),
    (VL, torch.float32), (HUBERT, torch.float32), (ZAMBA, torch.float32),
    (RWKV, torch.float32)], ids=lambda x: str(x).replace("torch.", ""))
def test_remat_changes_no_gradient_bit(arch, dtype):
    tree = _weights(arch, dtype)
    batch = _batch(_cfg(arch), KIND[arch], 4, 16, seed=3)
    loss, grads = _port_grads(arch, tree, batch, dtype, remat=True)
    loss0, grads0 = _port_grads(arch, tree, batch, dtype, remat=False)
    assert torch.equal(loss, loss0)
    for path, g in grads.items():
        assert torch.equal(g, grads0[path]), path


def _sessions(jx, arch, **priv):
    """(JAX session, port session, JAX TrainState, port TrainState) over
    ``build_model(..., remat=True, use_flash=True)`` in both packages, from
    the same weights."""
    jnp, jax = jx.jnp, jx.jax
    kw = {**QUICKSTART, **priv}
    tree = _weights(arch, cfg=get_smoke_config(arch))
    js = jx.Session.from_config(arch, privacy=jx.Privacy(**kw),
                                optimizer=jx.Optimizer(name="adamw", lr=LR))
    jmodel = jx.build_model(js.cfg, compute_dtype=jnp.float32,
                            **_flags(arch))
    js = dataclasses.replace(js, model=dataclasses.replace(
        jmodel, init=lambda key: jax.tree.map(jnp.asarray, tree)))
    jstate = jx.steps.init_train_state(js.model, js.run_cfg,
                                       jax.random.PRNGKey(0))
    ts = Session.from_config(arch, privacy=PrivacyConfig(**kw),
                             optimizer=OptimizerConfig(name="adamw", lr=LR),
                             device="cpu")
    ts = dataclasses.replace(ts, model=build_model(ts.cfg, "cpu",
                                                   **_flags(arch)))
    return js, ts, jstate, ts.init_state(
        params=params_from_jax(tree, ts.cfg, "cpu"))


@pytest.mark.parametrize("arch,tier", [
    (QWEN, "fused"), (QWEN, "scan"), (PHI, "fused"), (HUBERT, "fused"),
    (ZAMBA, "fused"), (RWKV, "fused")])
def test_session_train_step_matches_jax(jx, arch, tier):
    priv = {"silo_mode": "scan"} if tier == "scan" else {}
    js, ts, jstate, tstate = _sessions(jx, arch, **priv)
    assert ts.cfg.n_layers == js.cfg.n_layers
    kw = dict(steps=1, batch_size=16, seq_len=16, log_every=0)
    jkw, tkw = dict(kw), dict(kw)
    if KIND[arch] == "embeds":
        jkw["next_batch"] = lambda: jx.jax.tree.map(
            jx.jnp.asarray, _batch(ts.cfg, "embeds", 16, 16, seed=7))
        tkw["next_batch"] = lambda: _torch(_batch(ts.cfg, "embeds", 16, 16,
                                                  seed=7))
    with _blocked(jx):
        jres = js.train(state=jstate, **jkw)
    before = dispatch.launch_counts()
    tres = ts.train(state=tstate, **tkw)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    assert tres.step == jres.step == 1
    for tm, jm in zip(tres.metrics, jres.metrics):
        for k in ("loss", "clip_bound", "grad_norm_mean", "n_contributions"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL)
        assert tm["epsilon"] == jm["epsilon"]
    want = np.asarray(jx.flat.pack(jx.flat.layout_of(jres.state.params),
                                   jres.state.params))
    got = tres.state.opt_state["master"].detach().numpy()
    assert np.abs(got - want).max() <= PARAM_ATOL
    assert tres.state.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jres.state.noise_state.prev_key))
    assert ts.privacy_report() == js.privacy_report()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


def test_card_flash_silo_gradient_repeats_bit_for_bit(cuda):
    """One silo's gradient (4 x 64) of the qwen2.5-3b smoke config through
    flash and remat on the card, twice: bit-equal, each pass 2 x layers
    lse forwards (the forward, then remat's recompute) and 1 x layers
    backwards, no serving forward; held to the CPU's within GRAD_REL."""
    cfg = _cfg(QWEN)
    tree = _weights(QWEN)
    batch = _torch(_batch(cfg, "tokens", 4, 64, seed=4))
    out = []
    for dev in (cuda, cuda, torch.device("cpu")):
        model = build_model(cfg, dev, **_flags(QWEN))
        params = params_from_jax(tree, cfg, dev)
        layout, buf = packing.pack_params(params)
        tensors = flatbuf.flat_tensors(layout, packing.param_tree(params))
        dispatch.reset_launches()
        loss = model.loss(params, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tensors)
        if dev.type == "cuda":
            var = dispatch.variant_counts()
            assert var["flash_attention"] == {
                "f32": 0, "bf16": 0, "lse_f32": 2 * cfg.n_layers,
                "lse_bf16": 0}, var
            assert var["flash_attention_bwd"]["f32"] == cfg.n_layers, var
        out.append((loss.detach().cpu(),
                    flatbuf.pack_tensors(layout, grads).cpu()))
    (l1, g1), (l2, g2), (lc, gc) = out
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    np.testing.assert_allclose(l1.item(), lc.item(), rtol=RTOL)
    np.testing.assert_allclose(g1.numpy(), gc.numpy(), rtol=0,
                               atol=GRAD_REL * gc.abs().max().item())
    dispatch.reset_launches()
