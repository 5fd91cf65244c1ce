"""The port's dry run (``repro_torch.launch.{mesh,specs,dryrun}``) against
the JAX package's: every runnable cell's batch and cache specs and every
arch's parameter specs equal JAX's leaf by leaf (the cache's ``len`` is a
host int in the port and has no spec), and the plan's argument bytes equal
the bytes of JAX's specs; the plan's temporary bytes at or above the live
bytes a traced serving step holds, and within 10% of them; the cell's step
at a smoke config and a short sequence against JAX's ``model.prefill`` and
``model.decode_step`` on the same weights, for the dense, ssm and hybrid
families; rwkv6's chunked prefill against one call and against JAX's
forward with a state; zamba2-7b's long_500k refused by the plan; the CLI
on the CPU. ``repro.launch.dryrun`` is never imported: it forces 512 host
devices at import."""
import dataclasses
import functools
import json
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jax_configs
from repro.launch import specs as jax_specs
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models.convert import params_from_jax

BF16 = torch.bfloat16
# bf16 logits, port against JAX, and a greedy token split only at a
# near-tie: tests/test_torch_bf16_serving.py's gates
LOGIT_ATOL = 0.1
TIE = 2 * LOGIT_ATOL
# gate (e) of chip_smoke.py's phase 28 on the traced bytes: the plan at or
# above them and within 10%
PLAN_SLACK = 1.10
SERVING_CELLS = [c for c in jax_configs.runnable_cells()
                 if jax_configs.SHAPES[c[1]].kind != "train"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_MODELS: dict = {}


def _jax_model(arch: str):
    """JAX's dry-run model of the full config (``dryrun.py:91-92``)."""
    if arch not in _JAX_MODELS:
        _JAX_MODELS[arch] = jax_build_model(
            jax_configs.get_config(arch), param_dtype=jnp.bfloat16,
            compute_dtype=jnp.bfloat16, remat=True, use_flash=True)
    return _JAX_MODELS[arch]


def _jax_leaves(tree, prefix="") -> dict:
    """path -> (shape, dtype name) of a nested dict of ShapeDtypeStructs,
    the cache's ``len`` left out."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_jax_leaves(v, path + "."))
        elif k != "len":
            out[path] = (tuple(v.shape), jnp.dtype(v.dtype).name)
    return out


def _port_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_port_leaves(v, path + "."))
        else:
            assert v.device.type == "meta"
            out[path] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return out


def _bytes(leaves: dict) -> int:
    return sum(math.prod(s) * {"bfloat16": 2, "float32": 4, "int32": 4}[d]
               for s, d in leaves.values())


@pytest.mark.parametrize("arch,shape", jax_configs.runnable_cells())
def test_batch_and_cache_specs_equal_jax(arch, shape):
    cfg, jshape = get_config(arch), jax_configs.SHAPES[shape]
    jcfg = jax_configs.get_config(arch)
    model = dryrun.cell_model(cfg, specs.META)
    assert _port_leaves(specs.batch_specs(cfg, SHAPES[shape])) == \
        _jax_leaves(jax_specs.batch_specs(jcfg, jshape))
    assert _port_leaves(specs.cache_specs(cfg, SHAPES[shape], model)) == \
        _jax_leaves(jax_specs.cache_specs(jcfg, jshape, _jax_model(arch)))


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_params_specs_equal_jax(arch):
    """Every leaf of JAX's tree at bf16 weights, the leaves JAX keeps fp32
    (the MoE router, rwkv6's decay and bonus, mamba2's A_log, D, dt_bias)
    included."""
    model = dryrun.cell_model(get_config(arch), specs.META)
    assert _port_leaves(specs.params_specs(model)) == \
        _jax_leaves(jax_specs.params_specs(_jax_model(arch)))


@pytest.mark.parametrize("arch,shape", SERVING_CELLS)
def test_argument_bytes_equal_jax_specs(arch, shape):
    """The plan's argument bytes at JAX's global batch: the weights in
    bf16, the cache and the batch, as JAX's specs count them."""
    jcfg, jshape = jax_configs.get_config(arch), jax_configs.SHAPES[shape]
    jm = _jax_model(arch)
    want = (_bytes(_jax_leaves(jax_specs.params_specs(jm)))
            + _bytes(_jax_leaves(jax_specs.cache_specs(jcfg, jshape, jm)))
            + _bytes(_jax_leaves(jax_specs.batch_specs(jcfg, jshape))))
    got = dryrun.cell_bytes(get_config(arch), SHAPES[shape],
                            jshape.global_batch)
    assert got["argument_bytes"] == want
    rec = dryrun.plan_record(arch, shape)
    assert rec["batch"] <= jshape.global_batch
    assert rec["memory"]["total_bytes_per_dev"] <= mesh.HBM_BYTES or \
        rec["status"] == "does_not_fit"


def test_train_state_bytes_are_the_port_state():
    """A train cell's argument bytes are the port's TrainState: built at a
    smoke config on the CPU (the scan tier, JAX's dry-run privacy, bf16
    weights), its master, m, v and bf16 weights add up to the formula."""
    cfg = get_smoke_config("zamba2-7b")   # a mixed fp32 / bf16 tree
    sess = dryrun.train_session(None, device="cpu", cfg=cfg)
    state = sess.init_state()
    real = (state.opt_state["master"].nbytes + state.opt_state["m"].nbytes
            + state.opt_state["v"].nbytes + state.weights.nbytes)
    parts = dryrun.train_state_bytes(specs.params_specs(sess.model))
    assert sum(parts.values()) == real
    assert sess.run_cfg.privacy.silo_mode == "scan"
    assert sess.run_cfg.privacy.n_silos == dryrun.TRAIN_SILOS


def test_zamba2_long_500k_does_not_fit():
    """13 shared-attention entries x 524,288 positions x 32 KV heads x
    112 x K and V in bf16: 97.71 GB of KV cache at batch 1 (97.86 with
    the Mamba-2 states), past the card."""
    rec = dryrun.plan_record("zamba2-7b", "long_500k")
    assert rec["status"] == "does_not_fit" and rec["batch"] == 0
    cache = rec["memory"]["argument_parts"]["cache"]
    kv = 13 * 524_288 * 32 * 112 * 2 * 2
    assert round(kv / 1e9, 2) == 97.71
    # the conv and h states of the 81 Mamba-2 layers
    assert cache - kv == 81 * (3 * 7296 * 2 + 112 * 64 * 64 * 4)
    assert round(cache / 1e9, 2) == 97.86
    assert "does not fit" in rec["reason"]
    assert dryrun.plan_record("rwkv6-7b", "long_500k")["status"] == "ok"


def test_plan_is_the_largest_batch_that_fits():
    for arch, shape in (("qwen2.5-3b", "prefill_32k"),
                        ("zamba2-7b", "decode_32k")):
        cfg, sh = get_config(arch), SHAPES[shape]
        b = dryrun.plan_cell(arch, shape)["batch"]
        total = lambda n: sum(  # noqa: E731
            dryrun.cell_bytes(cfg, sh, n)[k] for k in ("argument_bytes",
                                                        "temp_bytes"))
        assert 0 < b < sh.global_batch
        assert total(b) <= mesh.HBM_BYTES < total(b + 1)


def test_cli_plans_every_cell_on_the_cpu(tmp_path):
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 31
    recs = {(r["arch"], r["shape"]): r for r in
            (json.loads(f.read_text()) for f in files)}
    assert recs[("zamba2-7b", "long_500k")]["status"] == "does_not_fit"
    for r in recs.values():  # no step of a cell that does not fit runs
        if r["status"] == "does_not_fit":
            assert r["hlo_cost"] is None and r["roofline"] is None
    for key in (("qwen2.5-3b", "prefill_32k"), ("qwen2.5-3b", "decode_32k"),
                ("zamba2-7b", "prefill_32k"), ("rwkv6-7b", "long_500k"),
                ("qwen2.5-3b", "train_4k")):
        r = recs[key]
        assert r["status"] == "ok" and r["batch"] >= 1
        # the counted step (analysis/op_cost.py): FLOPs and bytes, and a
        # useful share of the counted FLOPs
        hc, ro = r["hlo_cost"], r["roofline"]
        assert hc["flops_per_chip"] > 0 and hc["hbm_bytes_per_chip"] > 0
        assert hc["while_trip_counts"]
        assert ro["model_flops_global"] > 0
        assert ro["useful_flops_ratio"] > 0
        assert ro["t_compute_s"] == hc["flops_per_chip"] / mesh.PEAK_FLOPS_BF16
    for key in (("qwen2.5-3b", "prefill_32k"), ("zamba2-7b", "prefill_32k")):
        # attention's S x S work is counted: the model FLOPs are a share
        assert recs[key]["roofline"]["useful_flops_ratio"] < 1
    assert dryrun.DRYRUN_OUT.parent.name == "build"


def test_run_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --run would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                     "--run", "--out", str(tmp_path)])
    cell = dryrun.build_cell("qwen2.5-3b", "decode_32k", 1, "cpu",
                             cfg=get_smoke_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell(cell)


# ---------------------------------------------------------------------------
# the plan's temporary bytes against a traced step


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the ops run under it allocate and
    that are still referenced, and their peak: each op's outputs counted
    once a storage (views share it), released when the last tensor on
    the storage dies. Storages made before the mode are not counted."""

    def __init__(self, skip: set):
        super().__init__()
        self.skip, self.live, self.cur, self.peak = skip, {}, 0, 0

    def _release(self, key):
        n, refs = self.live[key]
        if refs > 1:
            self.live[key] = (n, refs - 1)
        else:
            del self.live[key]
            self.cur -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if key == 0 or key in self.skip:
                continue
            n, refs = self.live.get(key, (st.nbytes(), 0))
            if refs == 0:
                self.cur += n
                self.peak = max(self.peak, self.cur)
            self.live[key] = (n, refs + 1)
            weakref.finalize(t, self._release, key)
        return out


def _storages(tree, acc: set) -> set:
    if isinstance(tree, dict):
        for v in tree.values():
            _storages(v, acc)
    elif isinstance(tree, torch.Tensor):
        acc.add(tree.untyped_storage().data_ptr())
    elif isinstance(tree, torch.nn.Module):
        acc.update(p.untyped_storage().data_ptr() for p in tree.parameters())
    return acc


@pytest.fixture
def kernel_allocations(monkeypatch):
    """The serving forward's kernels as their CUDA wrappers allocate: the
    output (and a scan's new state) only, where the plain versions on the
    CPU build chunked or S x S intermediates."""
    from repro_torch.models import attention, mamba2, rwkv6

    monkeypatch.setattr(attention.flash_ops, "flash_attention",
                        lambda q, k, v, causal=True: torch.empty_like(q))
    monkeypatch.setattr(rwkv6.rwkv_ops, "wkv_chunked",
                        lambda r, k, v, w, u, s0, chunk=32:
                        (torch.empty_like(r), torch.empty_like(s0)))
    monkeypatch.setattr(mamba2.ssd_ops, "ssd_chunked",
                        lambda xh, dt, la, Bc, Cc, h0, chunk=64:
                        (torch.empty_like(xh), torch.empty_like(h0)))


# narrow configs with the published configs' ratios of d_ff, heads and
# state to d_model: the per-token terms dominate at S 512
NARROW = {
    "qwen2.5-3b": dict(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       d_head=32, d_ff=1376, vocab_size=512),
    "rwkv6-7b": dict(n_layers=2, d_model=256, n_heads=4, d_ff=896,
                     vocab_size=512, rwkv_head_size=64),
    "zamba2-7b": dict(n_layers=6, attn_every=6, d_model=224, n_heads=8,
                      n_kv_heads=8, d_head=28, d_ff=896, vocab_size=512,
                      ssm_state=64, mamba_headdim=64),
}


@pytest.mark.parametrize("arch,kind", [(a, k) for a in NARROW
                                       for k in ("prefill", "decode")])
def test_temp_bytes_cover_the_traced_step(arch, kind, kernel_allocations):
    """The plan's temporary bytes (``serving_temp_bytes``) at or above the
    live bytes a step holds at its peak, traced op by op, and within 10%
    of them; prefill at S 512, decode one token against a 512-deep cache
    (the K copy of the einsum), batch 2."""
    cfg = reduce_for_smoke(get_config(arch), **NARROW[arch])
    S, B = 512, 2
    shape = dataclasses.replace(SHAPES[f"{kind}_32k"], seq_len=S,
                                global_batch=B)
    cell = dryrun.build_cell(arch, None, B, "cpu", cfg=cfg, shape=shape)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        params = cell.model.init(gen)
        cache = cell.model.init_cache(B, S)
        if kind == "decode":
            dryrun.fill_cache(cache, S - 1, gen)
        batch = dryrun.seeded_batch(cell, gen)
        live = LiveBytes(_storages(batch, _storages(cache, _storages(
            params, set()))))
        with live:
            cell.step(params, batch, cache)
    plan = sum(dryrun.serving_temp_bytes(cfg, shape, B).values())
    assert live.peak <= plan <= PLAN_SLACK * live.peak, (live.peak, plan)


# ---------------------------------------------------------------------------
# the step against JAX's


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """JAX's smoke model at bf16 weights and compute (the dry run's
    build) and the port's weights, the same values (built once an arch:
    JAX's init takes seconds on the CPU)."""
    jm = jax_build_model(jax_configs.get_smoke_config(arch),
                         param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                         remat=True, use_flash=True)
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = get_smoke_config(arch)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_jax(tree, cfg, "cpu", dtype=BF16)
    return jm, jp, cfg, tp


def _fill_both(jcache: dict, tcache: dict, depth: int, rng) -> dict:
    """The same seeded values into JAX's cache and the port's, each leaf
    rounded to its dtype alike; every ``len`` at ``depth``."""
    out = {}
    for k, v in jcache.items():
        if isinstance(v, dict):
            out[k] = _fill_both(v, tcache[k], depth, rng)
        elif k == "len":
            out[k] = jnp.full(v.shape, depth, v.dtype)
            tcache[k] = depth
        else:
            a = rng.standard_normal(v.shape).astype(np.float32)
            out[k] = jnp.asarray(a).astype(v.dtype)
            tcache[k].copy_(torch.from_numpy(a).to(tcache[k].dtype))
    return out


def _logits_close(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    for r in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
        assert want[r].max() - want[r, got[r].argmax()] <= TIE


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-7b", "zamba2-7b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_cell_step_matches_jax(arch, kind):
    """``build_cell``'s step at a smoke config and S 64 (batch 2) against
    JAX's ``model.prefill`` on an empty cache / ``model.decode_step``
    against a cache filled at depth 63, on the same weights and values."""
    jm, jp, cfg, tp = _weights(arch)
    S, B = 64, 2
    shape = dataclasses.replace(SHAPES[f"{kind}_32k"], seq_len=S,
                                global_batch=B)
    cell = dryrun.build_cell(arch, None, B, "cpu", cfg=cfg, shape=shape)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S if kind == "prefill"
                                            else 1)).astype(np.int32)
    jcache = jm.init_cache(B, S)
    tcache = cell.model.init_cache(B, S)
    if kind == "decode":
        jcache = _fill_both(jcache, tcache, S - 1, rng)
    step = jm.prefill if kind == "prefill" else jm.decode_step
    want, _ = step(jp, {"tokens": jnp.asarray(toks)}, jcache)
    with torch.inference_mode():
        got = cell.step(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    _logits_close(got, want)


def test_rwkv6_chunked_prefill_matches_one_call_and_jax():
    """The long cell's prefill (``long_prefill``: 16-token calls, the state
    carried) against one call over the same 64 tokens and against JAX's
    forward with a state (its ``decode_step`` over the prompt): the last
    logits within the serving gate; the first layer's WKV state within
    fp32 rounding (1e-4: the plain scan sums a 16-token call in other
    chunks), the second's within 0.1 (its bf16 inputs part by an ulp where
    the first layer's outputs do)."""
    jm, jp, cfg, tp = _weights("rwkv6-7b")
    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=64)
    cell = dryrun.build_cell("rwkv6-7b", None, 1, "cpu", cfg=cfg,
                             shape=shape)
    with torch.inference_mode():
        chunked = cell.model.init_cache(1, 64)
        pre = dryrun.long_prefill(cell, tp, chunked,
                                  torch.Generator().manual_seed(5), chunk=16)
        toks = torch.randint(0, cfg.vocab_size, (1, 64), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(5))
        one = cell.model.init_cache(1, 64)
        l1 = cell.model.decode_step(tp, toks, one)
    assert pre["calls"] == 4 and pre["peak_bytes"] is None
    assert chunked["len"] == one["len"] == 64
    np.testing.assert_allclose(pre["logits"].float().numpy(),
                               l1.float().numpy(), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(chunked["S"][0].numpy(), one["S"][0].numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(chunked["S"].numpy(), one["S"].numpy(),
                               atol=0.1, rtol=0)
    want, jstate = jm.decode_step(jp, {"tokens": jnp.asarray(toks.numpy())},
                                  jm.init_cache(1, 64))
    _logits_close(pre["logits"], want)
    np.testing.assert_allclose(chunked["S"].numpy(), np.asarray(jstate["S"]),
                               atol=0.1, rtol=0)
