"""The counted cost of a cell's step: the port's twin of
``repro/analysis/hlo_cost.py``.

JAX's dry run reads FLOPs and HBM bytes off the compiled step's HLO
(``hlo_cost.analyze``), multiplying each ``while`` body by its trip count.
The port has no compiled graph: it runs the step eagerly, one kernel an
op. So it counts the step as it runs, on the ``meta`` device (shapes and
dtypes, no storage, any cell's size), under a ``TorchDispatchMode``:

* FLOPs of ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and ``convolution``,
  as JAX counts ``dot`` and ``convolution`` (``hlo_cost.py:153-190``): 2
  x the result's elements x the contracted size;
* HBM bytes as each op's tensor operands plus its results, each read or
  written once: in eager PyTorch every op is its own kernel, so this is
  the port's form of the fusion-unit model of ``hlo_cost.py``. Views and
  allocations move nothing;
* collective bytes 0: the port runs on one card;
* the ops with the most FLOPs and the most bytes (``top_flops``,
  ``top_hbm``), aggregated by op and shapes.

A hand-written kernel is counted by its own work formula (below), never
through its plain version's ops: the counter enters
``kernels.dispatch.counting``, which routes meta inputs to
:meth:`Counter.kernel`; the stand-in there counts the formula and returns
meta outputs of the kernel's shapes. ``chip_smoke.py`` bounds the same
kernels by the same formulas. The counter takes meta tensors only: a CPU
or CUDA tensor raises.

JAX multiplies a scan body by its trip count (``hlo_cost.py:216``). The
step counter likewise counts a cell's model at one and at two units of
depth (a layer; a zamba2 group of ``attn_every`` Mamba-2 layers and its
shared block, and one trailing layer), takes one unit's cost as the
difference and multiplies it by the unit's count, recorded under
``trip_counts`` (JAX's ``while_trip_counts``); a train cell counts one
silo and multiplies it by the silos. The train step's passes over its
packed state are counted as the step runs them, at full depth.

Importing this module touches no device and imports no other module of
the port: ``chip_smoke.py`` reads the work formulas from this file for any
tree it times.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

META = torch.device("meta")
TOP = 20

# ---------------------------------------------------------------------------
# the kernels' work: (bytes each input read once and each output written
# once, operations), the numbers of their PERF.md bounds


def _pairs(Sq: int, Sk: int, causal: bool) -> int:
    """Visible (query, key) pairs of one (batch, head): the causal mask
    over equal lengths keeps the lower triangle."""
    return Sq * (Sq + 1) // 2 if causal and Sq == Sk else Sq * Sk


def flash_work(q, k, v, causal: bool = True) -> tuple:
    """The serving forward: q, k, v read and out written, in q's type; 2
    products of D (scores, then the values) per visible (query head, key)
    pair, 2 operations each."""
    B, Sq, Hq, D = q.shape
    pairs = _pairs(Sq, k.shape[1], causal)
    e = q.element_size()
    return ((2 * q.numel() + k.numel() + v.numel()) * e,
            4 * D * Hq * B * pairs)


def flash_lse_work(q, k, v, causal: bool = True) -> tuple:
    """The training forward: as :func:`flash_work`, with ``out`` beside q
    counted at the keys' size too, and the fp32 log-sum-exp written."""
    B, Sq, Hq, D = q.shape
    pairs = _pairs(Sq, k.shape[1], causal)
    e = q.element_size()
    return ((2 * q.numel() + 2 * k.numel()) * e + B * Hq * Sq * 4,
            4 * D * Hq * B * pairs)


def flash_bwd_work(q, k, v, causal: bool = True) -> tuple:
    """The backward: q, out, dout and dq, k, v, dk and dv in q's type, the
    log-sum-exp read; 5 products of D per visible pair (the scores again,
    dP, dV, dQ, dK)."""
    B, Sq, Hq, D = q.shape
    pairs = _pairs(Sq, k.shape[1], causal)
    e = q.element_size()
    return ((4 * q.numel() + 4 * k.numel()) * e + B * Hq * Sq * 4,
            10 * D * Hq * B * pairs)


def paged_work(q, tables, q_start, P: int, Hkv: int) -> tuple:
    """Paged attention for these inputs (``tables`` and ``q_start`` on the
    host): q read and the output written (fp32), the K/V of every page
    holding a visible position read once (in q's type), and 2 products of
    D per visible (query head, key) pair."""
    B, C, Hq, D = q.shape
    S = tables.shape[1] * P
    pages, flops = set(), 0
    for b in range(B):
        qs = int(q_start[b])
        last = min(max(qs + C, 0), S)  # visible positions of the last row
        pages.update(tables[b, :-(-last // P)].tolist())
        for c in range(C):
            flops += 4 * D * Hq * min(max(qs + c + 1, 0), S)
    e = q.element_size()
    nbytes = (q.numel() * (e + 4) + len(pages) * P * Hkv * D * e * 2
              + tables.numel() * 4 + B * 4)
    return nbytes, flops


def wkv_work(r, u, state0) -> tuple:
    """The WKV scan: r, k, v, w in and o out, u, the state in and out
    (fp32); 4 operations per (token, head, N x N state element)."""
    B, S, H, N = r.shape
    return ((5 * r.numel() + u.numel() + 2 * state0.numel()) * 4,
            4 * B * S * H * N * N)


def wkv_bwd_work(r, u, state0) -> tuple:
    """Its backward: r, k, v, w, do in and dr, dk, dv, dw out; u in, du
    out; the state and dstate in, dstate0 out; 12 operations per (token,
    head, state element)."""
    B, S, H, N = r.shape
    return ((9 * r.numel() + 2 * u.numel() + 3 * state0.numel()) * 4,
            12 * B * S * H * N * N)


def ssd_work(xh, dt, Bc, h0) -> tuple:
    """The SSD scan: x, dt, the log decay, B, C and h0 in, y and h out
    (fp32); 5 operations per (token, head, P x N state element)."""
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    return ((2 * xh.numel() + 2 * dt.numel() + 2 * Bc.numel()
             + 2 * h0.numel()) * 4, 5 * B * S * nh * P * N)


def ssd_bwd_work(xh, dt, Bc, h0) -> tuple:
    """Its backward: x, dy in, dx out; dt, the log decay in, their
    gradients out; B, C in, dB, dC out; h0, dh in, dh0 out; 13 operations
    per (token, head, state element)."""
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    return ((3 * xh.numel() + 4 * dt.numel() + 4 * Bc.numel()
             + 3 * h0.numel()) * 4, 13 * B * S * nh * P * N)


def normal_combine_work(out, accumulate: bool) -> tuple:
    """The corrected noise drawn into ``out`` (fp32): written, and read
    first when accumulating; no product (its PERF.md bound is by the
    draw's instructions, ``chip_smoke.py``'s ``normal_bound``)."""
    return (2 if accumulate else 1) * out.numel() * 4, 0


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _like(t: torch.Tensor) -> torch.Tensor:
    return _empty(t.shape, t.dtype)


# name -> (work of the call, its meta outputs); the arguments are the CUDA
# wrapper's. The kernels of the dry run's cells (paged attention is bounded
# by :func:`paged_work` in ``chip_smoke.py``; no cell pages): the train
# step's noise draws through ``normal_combine``
STAND_INS = {
    "flash_attention": (
        lambda q, k, v, causal=True: flash_work(q, k, v, causal),
        lambda q, k, v, causal=True: _like(q)),
    "flash_attention_fwd_lse": (
        lambda q, k, v, causal=True: flash_lse_work(q, k, v, causal),
        lambda q, k, v, causal=True: (
            _like(q), _empty((q.shape[0], q.shape[2], q.shape[1]),
                             torch.float32))),
    "flash_attention_bwd": (
        lambda q, k, v, out, lse, dout, causal=True:
            flash_bwd_work(q, k, v, causal),
        lambda q, k, v, out, lse, dout, causal=True:
            (_like(q), _like(k), _like(v))),
    "wkv": (
        lambda r, k, v, w, u, s0: wkv_work(r, u, s0),
        lambda r, k, v, w, u, s0: (_like(r), _like(s0))),
    "wkv_bwd": (
        lambda r, k, v, w, u, s0, do, dstate=None: wkv_bwd_work(r, u, s0),
        lambda r, k, v, w, u, s0, do, dstate=None:
            tuple(_like(t) for t in (r, k, v, w, u, s0))),
    "ssd": (
        lambda xh, dt, la, Bc, Cc, h0: ssd_work(xh, dt, Bc, h0),
        lambda xh, dt, la, Bc, Cc, h0: (_like(xh), _like(h0))),
    "ssd_bwd": (
        lambda xh, dt, la, Bc, Cc, h0, dy, dh=None: ssd_bwd_work(xh, dt, Bc,
                                                                 h0),
        lambda xh, dt, la, Bc, Cc, h0, dy, dh=None:
            tuple(_like(t) for t in (xh, dt, la, Bc, Cc, h0))),
    "normal_combine": (  # in place: ``out`` itself comes back
        lambda out, ka, kb, offset, sa, sb=None, g=None, accumulate=False:
            normal_combine_work(out, accumulate),
        lambda out, *args, **kwargs: out),
}


# ---------------------------------------------------------------------------
# the counter


@dataclass
class CostSummary:
    """Per-chip totals, JAX's ``CostSummary`` fields. ``ops`` keeps every
    (op, shapes) entry's ``[flops, bytes, calls]``, so summaries combine
    linearly (:meth:`scaled`, :meth:`plus`); ``top_*`` are read off it."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_raw: dict = field(default_factory=dict)
    cross_pod_bytes: float = 0.0
    trip_counts: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)

    @property
    def total_collective(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, key: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        e = self.ops.setdefault(key, [0.0, 0.0, 0])
        e[0] += flops
        e[1] += nbytes
        e[2] += 1

    def scaled(self, c: float) -> "CostSummary":
        return CostSummary(self.flops * c, self.hbm_bytes * c,
                           trip_counts=dict(self.trip_counts),
                           ops={k: [f * c, b * c, n * c]
                                for k, (f, b, n) in self.ops.items()})

    def plus(self, other: "CostSummary") -> "CostSummary":
        ops = {k: list(v) for k, v in self.ops.items()}
        for k, (f, b, n) in other.ops.items():
            e = ops.setdefault(k, [0.0, 0.0, 0])
            e[0] += f
            e[1] += b
            e[2] += n
        return CostSummary(self.flops + other.flops,
                           self.hbm_bytes + other.hbm_bytes,
                           trip_counts={**self.trip_counts,
                                        **other.trip_counts},
                           ops={k: v for k, v in ops.items()
                                if abs(v[2]) > 1e-9})

    def _top(self, i: int, n: int) -> list:
        rows = sorted(((v[i], v[2], k) for k, v in self.ops.items()
                       if v[i] > 0), reverse=True)
        return rows[:n]

    @property
    def top_flops(self) -> list:
        """(flops, calls, op and shapes), largest first."""
        return self._top(0, TOP)

    @property
    def top_hbm(self) -> list:
        return self._top(1, TOP)


# ops that move no bytes: views, and allocations whose contents nothing
# has written yet
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "detach", "alias"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}


def _shapes(ts) -> str:
    return ",".join("x".join(map(str, t.shape)) for t in ts)


def matmul_flops(name: str, args) -> float:
    """2 x the result's elements x the contracted size."""
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    out = a.shape[:-1] + b.shape[-1:]
    return 2.0 * math.prod(out) * a.shape[-1]


def conv_flops(x, w, out) -> float:
    """2 x the output's elements x (input channels a group x the kernel's
    spatial size), JAX's kernel elements over output features."""
    return 2.0 * out.numel() * (w.numel() / max(w.shape[0], 1))


class Counter(TorchDispatchMode):
    """Counts every op run under it into :attr:`summary`; meta tensors
    only. Enter it with :meth:`scope` (the mode and the kernels' counting
    scope together)."""

    def __init__(self):
        super().__init__()
        self.summary = CostSummary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        for t in ins:
            if not (t.is_meta or t.device.type == "cpu"):
                raise ValueError(f"op_cost counts meta tensors; {func} got "
                                 f"one on {t.device}")
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.is_view or name in _NO_BYTES:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in ins if t.is_meta]
        outs = [t for t in outs if t.is_meta]
        if not ins and not outs:
            return out  # host work: the step's keys and scalars
        flops = 0.0
        if name in _MATMULS:
            flops = matmul_flops(name, args)
        elif name == "convolution":
            flops = conv_flops(args[0], args[1], outs[0])
        seen, nbytes = set(), 0
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                nbytes += t.numel() * t.element_size()
        self.summary.add(f"aten.{name}({_shapes(ins)})", flops, nbytes)
        return out

    def kernel(self, name: str, *args, **kwargs):
        """A port kernel's stand-in: its work formula counted, meta outputs
        of its shapes returned."""
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor) and not t.is_meta:
                raise ValueError(f"op_cost: kernel {name} got a tensor on "
                                 f"{t.device}")
        work, outputs = STAND_INS[name]
        nbytes, flops = work(*args, **kwargs)
        tensors = [t for t in args if isinstance(t, torch.Tensor)]
        self.summary.add(f"kernel.{name}({_shapes(tensors)})", flops, nbytes)
        return outputs(*args, **kwargs)  # allocations: no bytes counted

    def scope(self):
        """The mode and the kernels' counting scope, entered together."""
        from contextlib import ExitStack

        from repro_torch.kernels import dispatch

        stack = ExitStack()
        stack.enter_context(dispatch.counting(self))
        stack.enter_context(self)
        return stack


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CostSummary)``: ``fn`` run once under a
    fresh :class:`Counter` on meta inputs."""
    c = Counter()
    with c.scope():
        out = fn(*args, **kwargs)
    return out, c.summary


# ---------------------------------------------------------------------------
# a cell's step


def _units(cfg) -> tuple:
    """The depth units of ``cfg``: ``[(name, count, depth of one unit)]``
    and the depths to count at, as (depth, {unit: count}) pairs."""
    if cfg.family == "hybrid":
        ae = cfg.attn_every
        g, tail = cfg.n_layers // ae, cfg.n_layers % ae
        units = [("groups", g, ae)] + ([("tail_layers", tail, 1)]
                                       if tail else [])
        return units, [(ae, {"groups": 1}), (2 * ae, {"groups": 2})] + (
            [(ae + 1, {"groups": 1, "tail_layers": 1})] if tail else [])
    units = [("layers", cfg.n_layers, 1)]
    return units, [(1, {"layers": 1}), (2, {"layers": 2})]


def _set_len(cache: dict, depth: int) -> None:
    for k, v in cache.items():
        if isinstance(v, dict):
            _set_len(v, depth)
        elif k == "len":
            cache[k] = depth


def _meta_params(cfg, param_dtype, requires_grad: bool):
    from repro_torch.models.convert import FAMILIES

    mod = FAMILIES[cfg.family](cfg, META, param_dtype)
    for p in mod.parameters():
        p.requires_grad_(requires_grad)
    return mod


def serving_step_cost(cfg, shape, batch: int) -> CostSummary:
    """One serving step of the cell model of ``cfg`` (``launch/dryrun``'s
    build: bf16 weights and compute, flash attention) at ``batch`` on the
    meta device: a prefill on an empty cache, or one decode token against
    a ``seq_len - 1``-deep one."""
    from repro_torch.launch import dryrun, specs

    at = dataclasses.replace(shape, global_batch=batch)
    cell = dryrun.build_cell(None, None, batch, META, cfg=cfg, shape=at)
    params = _meta_params(cfg, cell.model.param_dtype, False)
    inputs = specs.batch_specs(cfg, at)
    c = Counter()
    with torch.no_grad():
        cache = cell.model.init_cache(batch, at.seq_len)
        if at.kind == "decode":
            _set_len(cache, at.seq_len - 1)
        with c.scope():
            cell.step(params, inputs, cache)
    return c.summary


def silo_step_cost(cfg, seq_len: int, seqs: int) -> CostSummary:
    """One silo's loss forward and backward (the cell model: bf16, remat,
    flash) over ``seqs`` sequences of ``seq_len``, every parameter's
    gradient taken (an unused one as zeros, as the train step takes
    them), on the meta device."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun, specs

    at = dataclasses.replace(SHAPES["train_4k"], seq_len=seq_len,
                             global_batch=seqs)
    model = dryrun.cell_model(cfg, META)
    params = _meta_params(cfg, model.param_dtype, True)
    batch = specs.batch_specs(cfg, at)
    c = Counter()
    with c.scope():
        loss = model.loss(params, batch)
        torch.autograd.grad(loss, list(params.parameters()),
                            materialize_grads=True)
    return c.summary


class _FreeLoss(torch.autograd.Function):
    """A loss over the weights that moves no byte: an empty scalar, and
    empty gradients of the weights' shapes and types."""

    @staticmethod
    def forward(ctx, *weights):
        ctx.specs = [(w.shape, w.dtype) for w in weights]
        return torch.empty((), device=META)

    @staticmethod
    def backward(ctx, _):
        return tuple(torch.empty(shape, dtype=dtype, device=META)
                     for shape, dtype in ctx.specs)


def _free_loss(params, batch):
    from repro_torch.models import packing

    return _FreeLoss.apply(*tree_flatten(packing.param_tree(params))[0])


def state_step_cost(cfg) -> CostSummary:
    """The train step's passes over the train state, counted as they run:
    ``distributed/steps.build_train_step``'s step (the dry run's cell: the
    scan tier over its silos, its privacy, AdamW) on the cell model's meta
    train state, each silo's loss and gradients stood in for by a loss
    that moves nothing (their cost is :func:`silo_step_cost`'s). So it
    counts each silo's norm, clip and accumulation, the noise, the
    optimizer and the bf16 weights' write-back, under keys
    ``state.<op>(<shapes>)``."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed import steps
    from repro_torch.launch import dryrun, specs

    model = dryrun.cell_model(cfg, META)
    run_cfg = RunConfig(model=cfg, privacy=dryrun.train_privacy(),
                        optimizer=dryrun.TRAIN_OPTIMIZER)
    state = steps.init_train_state(
        model, run_cfg, (0, 0), params=_meta_params(cfg, model.param_dtype,
                                                    True))
    at = dataclasses.replace(SHAPES["train_4k"],
                             global_batch=dryrun.TRAIN_SILOS)
    step = steps.build_train_step(dataclasses.replace(model,
                                                      loss=_free_loss),
                                  run_cfg)
    c = Counter()
    with c.scope():
        step(state, specs.batch_specs(cfg, at), (0, 0),
             timer=steps.StageTimer(META))
    out = CostSummary()
    for key, (f, b, n) in c.summary.ops.items():
        if key.startswith("aten.ones_like("):
            continue  # the gradients' seeds: the silos' own, counted there
        out.ops["state." + key] = [f, b, n]
        out.flops += f
        out.hbm_bytes += b
    return out


def _at_depth(cfg, depth: int):
    return dataclasses.replace(cfg, n_layers=depth)


def step_cost(cfg, shape, batch: int) -> CostSummary:
    """The counted cost of the cell (``cfg``, ``shape``) at ``batch``: the
    model's step at one and at two units of depth, one unit's cost their
    difference, times its count (:func:`_units`). A train cell's step is
    its silos' forward and backward at ``batch`` over the silos'
    sequences each (one silo counted, times the silos), and the passes
    over its state at full depth (:func:`state_step_cost`: the packed
    layout's padding does not grow linearly with depth)."""
    from repro_torch.launch import dryrun

    units, depths = _units(cfg)
    silos = dryrun.TRAIN_SILOS
    if shape.kind == "train":
        seqs = max(batch // silos, 1)

        def at(d):
            return silo_step_cost(_at_depth(cfg, d), shape.seq_len, seqs)
    else:
        def at(d):
            return serving_step_cost(_at_depth(cfg, d), shape, batch)
    counted = {d: at(d) for d, _ in depths}
    (d1, _), (d2, _) = depths[:2]
    first = units[0][0]
    per = {first: counted[d2].plus(counted[d1].scaled(-1))}
    if len(depths) > 2:
        d3 = depths[2][0]
        per[units[1][0]] = counted[d3].plus(counted[d1].scaled(-1))
    total = counted[d1].plus(per[first].scaled(-1))   # the rest of the step
    for name, n, _ in units:
        total = total.plus(per[name].scaled(n))
    if shape.kind == "train":
        total = total.scaled(silos).plus(state_step_cost(cfg))
        total.trip_counts["silos"] = silos
    for name, n, _ in units:
        total.trip_counts[name] = n
    return total


def hlo_cost_record(summary: CostSummary) -> dict:
    """The dry-run record's ``hlo_cost`` entry, JAX's keys
    (``repro/launch/dryrun.py:198-205``)."""
    return {
        "flops_per_chip": summary.flops,
        "hbm_bytes_per_chip": summary.hbm_bytes,
        "collective_bytes_weighted": dict(summary.collective_bytes),
        "collective_bytes_raw": dict(summary.collective_raw),
        "cross_pod_bytes": summary.cross_pod_bytes,
        "while_trip_counts": dict(summary.trip_counts),
    }
