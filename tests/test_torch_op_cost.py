"""The counted step cost (``repro_torch.analysis.op_cost``, the twin of
``repro/analysis/hlo_cost.py``) against JAX's ``analyze``: the counted
FLOPs of ``tests/test_analysis.py``'s scan and nested-scan functions equal
JAX's exactly, whether the loop is counted whole or one body times its
trip count; a smoke qwen2.5-3b and phi3.5-moe loss forward (no flash)
within 1% of JAX's count of its compiled loss. One unit of depth times its
count equals a full count at smoke depth (serving and training, a
transformer and a zamba2 stack with a tail). The dry run's train step
counted whole equals its silos' forward and backward plus its state's
passes, every family. Each kernel's work formula gives its PERF.md bound
on one shape. The counting scope routes meta tensors to the kernels'
stand-ins and refuses CPU tensors, a meta tensor reaches no kernel outside
it, and a kernel without a stand-in refuses to launch one inside it."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_cost import analyze
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.analysis import op_cost
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import flatbuf
from repro_torch.distributed import steps
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention_cuda
from repro_torch.kernels.prng import ops as prng_ops
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import packing
from repro_torch.models.registry import build_model

META = torch.device("meta")
BF16 = torch.bfloat16
HBM = 3.35e12
FP32_RATE, BF16_RATE = 67e12, 989e12
# the smoke forwards against JAX's compiled loss: JAX's HLO holds a few
# small products the port's ops fold elsewhere (0.26% / 0.06% measured)
LOSS_RTOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device=META)


def _jax_flops(f, *sds) -> float:
    return analyze(jax.jit(f).lower(*sds).compile().as_text()).flops


def test_scan_trip_count_multiplies_flops_as_jax():
    """An 8-step scan of a (64 x 256) @ (256 x 256) product: JAX's
    ``analyze`` multiplies the body by 8; the port counts the loop whole,
    and one body times 8, to the same number."""
    def jax_scanned(x, ws):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)
        return h

    want = _jax_flops(jax_scanned, jax.ShapeDtypeStruct((64, 256),
                                                        jnp.float32),
                      jax.ShapeDtypeStruct((8, 256, 256), jnp.float32))

    def layer(h, w):
        return torch.tanh(h @ w)

    def scanned(x, ws):
        for w in ws:
            x = layer(x, w)
        return x

    x, ws = _meta(64, 256), _meta(8, 256, 256)
    _, whole = op_cost.count(scanned, x, ws)
    _, body = op_cost.count(layer, x, ws[0])
    assert whole.flops == body.scaled(8).flops == want == 2 * 64 * 256 * \
        256 * 8
    assert whole.top_flops[0][1] == 8  # one (op, shapes) entry, 8 calls


def test_nested_scan_multiplies_as_jax():
    def jax_outer(x, ws):
        def inner(h, w):
            h, _ = jax.lax.scan(lambda h, wi: (h @ wi, None), h, w)
            return h, None
        h, _ = jax.lax.scan(inner, x, ws)
        return h

    want = _jax_flops(jax_outer, jax.ShapeDtypeStruct((32, 32), jnp.float32),
                      jax.ShapeDtypeStruct((4, 3, 32, 32), jnp.float32))

    def outer(x, ws):
        for w in ws:
            for wi in w:
                x = x @ wi
        return x

    x, ws = _meta(32, 32), _meta(4, 3, 32, 32)
    _, whole = op_cost.count(outer, x, ws)
    _, one = op_cost.count(lambda h, w: h @ w, x, ws[0, 0])
    assert whole.flops == one.scaled(4 * 3).flops == want == \
        2 * 32 * 32 * 32 * 12


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3.5-moe-42b-a6.6b"])
def test_smoke_loss_forward_within_one_percent_of_jax(arch):
    """The smoke loss forward in fp32 without flash (attention as einsum
    products in both), batch 4 x 32: the port's counted FLOPs within 1% of
    JAX's ``analyze`` of its compiled loss (its layers a scan of 2)."""
    B, S = 4, 32
    jm = jax_build_model(jax_smoke_config(arch), compute_dtype=jnp.float32)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct((B, S), jnp.int32)
    want = _jax_flops(jm.loss, jp, {"tokens": sds, "labels": sds})
    cfg = get_smoke_config(arch)
    model = build_model(cfg, META)
    params = op_cost._meta_params(cfg, torch.float32, False)
    ids = _meta(B, S, dtype=torch.int32)
    with torch.no_grad():
        _, got = op_cost.count(model.loss, params, {"tokens": ids,
                                                    "labels": ids})
    assert abs(got.flops / want - 1) < LOSS_RTOL, (got.flops, want)
    assert got.hbm_bytes > 0 and not got.total_collective


def _full(cfg, shape, batch, silos=8):
    """The step counted at full depth in one go."""
    if shape.kind != "train":
        return op_cost.serving_step_cost(cfg, shape, batch)
    one = op_cost.silo_step_cost(cfg, shape.seq_len, batch // silos)
    return one.scaled(silos).plus(op_cost.state_step_cost(cfg))


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("arch,depth", [("qwen2.5-3b", dict(n_layers=5)),
                                        ("zamba2-7b", dict(n_layers=15,
                                                           attn_every=6))])
def test_unit_times_count_equals_a_full_count(arch, depth, kind):
    """A unit's cost (a layer; a zamba2 group of 6 and a tail layer) times
    its count, plus the rest, equals the step counted at full depth:
    FLOPs and bytes exactly, op by op (a train step's state passes are
    counted at full depth in both)."""
    cfg = dataclasses.replace(get_smoke_config(arch), **depth)
    shape = dataclasses.replace(SHAPES[kind], seq_len=64)
    got = op_cost.step_cost(cfg, shape, 16)
    want = _full(cfg, shape, 16)
    assert got.flops == want.flops and got.hbm_bytes == want.hbm_bytes
    assert {k: v for k, v in got.ops.items() if v[2]} == {
        k: [float(x) for x in v] for k, v in want.ops.items()}
    if cfg.family == "hybrid":
        assert got.trip_counts == {"groups": 2, "tail_layers": 3,
                                   **({"silos": 8} if kind == "train_4k"
                                      else {})}
    else:
        assert got.trip_counts["layers"] == 5


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3.5-moe-42b-a6.6b",
                                  "qwen2-vl-72b", "hubert-xlarge",
                                  "rwkv6-7b", "zamba2-7b"])
def test_train_step_counted_whole_equals_silos_and_state(arch):
    """The dry run's train step (``steps.build_train_step`` over its meta
    train state, 8 silos) counted as it runs equals 8 silos' forward and
    backward plus the state's passes, FLOPs and bytes exactly: nothing of
    the step is left out of the split the cells are counted by."""
    cfg = get_smoke_config(arch)
    model = dryrun.cell_model(cfg, META)
    run_cfg = RunConfig(model=cfg, privacy=dryrun.train_privacy(),
                        optimizer=dryrun.TRAIN_OPTIMIZER)
    state = steps.init_train_state(model, run_cfg, (0, 0),
                                   params=op_cost._meta_params(
                                       cfg, model.param_dtype, True))
    at = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=16)
    step = steps.build_train_step(model, run_cfg)
    _, whole = op_cost.count(step, state, specs.batch_specs(cfg, at), (0, 0),
                             timer=steps.StageTimer(META))
    split = op_cost.silo_step_cost(cfg, 64, 2).scaled(8).plus(
        op_cost.state_step_cost(cfg))
    assert whole.flops == split.flops and whole.hbm_bytes == split.hbm_bytes
    # the noise through its kernel's stand-in, once a weight tensor
    noise = sum(v[2] for k, v in whole.ops.items()
                if k.startswith("kernel.normal_combine("))
    assert noise == len(flatbuf.flat_tensors(
        state.layout, packing.param_tree(state.params)))


def _bound(work, rate):
    nbytes, flops = work
    return max(nbytes / HBM * 1e3, flops / rate * 1e3)


def test_each_kernel_formula_gives_its_perf_bound():
    """The formulas at one shape of each PERF.md row: the bound, to the
    table's four places."""
    f = op_cost
    bf = BF16
    q, k = (_meta(15, 32768, 16, 128, dtype=bf),
            _meta(15, 32768, 2, 128, dtype=bf))
    rows = {
        # row 1: qwen2.5-3b's prefill_32k batch, bf16
        "flash_attention": (_bound(f.flash_work(q, k, k), BF16_RATE),
                            66.7065),
        # row 1's training forward and row 19, qwen2.5-3b's silo, fp32
        "flash_attention_fwd_lse": (_bound(f.flash_lse_work(
            _meta(1, 4096, 16, 128), _meta(1, 4096, 2, 128),
            _meta(1, 4096, 2, 128)), FP32_RATE), 1.0259),
        "flash_attention_bwd": (_bound(f.flash_bwd_work(
            _meta(1, 4096, 16, 128), _meta(1, 4096, 2, 128),
            _meta(1, 4096, 2, 128)), FP32_RATE), 2.5648),
        # row 2's 32k-deep bf16 sub-row: 59 slots of 2048 pages of 16, each
        # at its last position
        "paged_attention": (_bound(f.paged_work(
            _meta(59, 1, 16, 128, dtype=bf),
            torch.arange(59 * 2048, dtype=torch.int32).reshape(59, 2048),
            torch.full((59,), 32767, dtype=torch.int32), 16, 2), BF16_RATE),
            0.5913),
        # rows 11-12 at rwkv6's long call and zamba2's prefill_32k
        "wkv": (_bound(f.wkv_work(_meta(1, 32768, 64, 64), _meta(64, 64),
                                  _meta(1, 64, 64, 64)), FP32_RATE), 0.8019),
        "ssd": (_bound(f.ssd_work(_meta(5, 32768, 112, 64),
                                  _meta(5, 32768, 112), _meta(5, 32768, 64),
                                  _meta(5, 112, 64, 64)), FP32_RATE), 5.6091),
        # rows 15-16 at the training shapes
        "wkv_bwd": (_bound(f.wkv_bwd_work(_meta(4, 64, 64, 64),
                                          _meta(64, 64),
                                          _meta(4, 64, 64, 64)), FP32_RATE),
                    0.0150),
        "ssd_bwd": (_bound(f.ssd_bwd_work(_meta(4, 64, 112, 64),
                                          _meta(4, 64, 112),
                                          _meta(4, 64, 64),
                                          _meta(4, 112, 64, 64)), FP32_RATE),
                    0.0228),
    }
    assert set(rows) | {"normal_combine"} == set(op_cost.STAND_INS) | {
        "paged_attention"}
    for name, (got, perf) in rows.items():
        assert round(got, 4) == perf, (name, got)
    # row 18's draw over the embedding leaf: its bound is by its pinned
    # instruction counts; the bytes are chip_smoke.py's two words an
    # element (read, then written), and no product
    n = 311_164_928
    assert op_cost.normal_combine_work(_meta(n), True) == (2 * 4 * n, 0)
    assert op_cost.normal_combine_work(_meta(n), False) == (4 * n, 0)


def test_cells_count_attention_through_the_kernels():
    """qwen2.5-3b's prefill_32k at the plan's batch: the flash forward
    counted 36 times by its formula (2.40 s of the bf16 peak), inside a
    t_compute of at least 5 s; the kernels launched nothing."""
    before = dispatch.launch_counts()
    rec = dryrun.plan_record("qwen2.5-3b", "prefill_32k")
    assert dispatch.launch_counts() == before
    B = rec["batch"]
    cost = dryrun.counted_cost(dryrun.get_config("qwen2.5-3b"),
                               SHAPES["prefill_32k"], B)
    flash = {k: v for k, v in cost.ops.items()
             if k.startswith("kernel.flash_attention(")}
    (f, _, calls), = flash.values()
    q = _meta(B, 32768, 16, 128, dtype=BF16)
    kv = _meta(B, 32768, 2, 128, dtype=BF16)
    assert calls == 36
    assert f == 36 * op_cost.flash_work(q, kv, kv)[1]
    assert 2.3 < f / mesh.PEAK_FLOPS_BF16 < 2.5
    assert rec["roofline"]["t_compute_s"] >= 5.0
    assert rec["hlo_cost"]["while_trip_counts"] == {"layers": 36}
    assert not any(k.startswith("aten.bmm") and "32768x32768" in k
                   for k in cost.ops)


def test_counting_scope_refuses_other_devices():
    """Ops on host tensors alone are host work and count nothing; CPU
    tensors raise in a stand-in; meta tensors reach no kernel outside a
    counting scope, and inside one a kernel without a stand-in refuses to
    launch them."""
    x = torch.ones(4, 4)
    _, host = op_cost.count(lambda a: a @ a, x)
    assert host.flops == 0 and host.hbm_bytes == 0 and not host.ops
    c = op_cost.Counter()
    with c.scope():
        with pytest.raises(ValueError, match="got a tensor on cpu"):
            c.kernel("flash_attention", torch.ones(1, 4, 2, 16),
                     torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16))
    m = _meta(1, 4, 2, 16)
    with pytest.raises(ValueError, match="counting scope"):
        flash_attention_cuda(m, m, m)
    with pytest.raises(ValueError, match="all be on cuda or all on cpu"):
        dispatch.on_cuda(m, m)
    with dispatch.counting(c):
        assert dispatch.on_cuda(m, m)
        out = flash_attention_cuda(m, m, m)
        with pytest.raises(ValueError, match="launches on a CUDA device"):
            prng_ops.normal((1, 2), 0, _meta(64))
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            paged_attention_cuda(_meta(1, 1, 2, 16), _meta(4, 4, 1, 16),
                                 _meta(4, 4, 1, 16),
                                 _meta(1, 1, dtype=torch.int32),
                                 _meta(1, dtype=torch.int32))
    assert out.is_meta and out.shape == m.shape
    assert dispatch.counting_scope() is None
