#!/usr/bin/env python3
"""Measure the wire tier's stream kernels (``clip_mask_kernel<false>``,
``clip_mask_kernel<true>``, ``noise_stream_kernel``) side by side on one
GPU: each variant is a tree's sources with a few text edits, compiled by
``nvcc`` into a library of its own under ``$TMPDIR`` and timed in one
process on the same inputs.

    python3 tools/time_stream_variants.py [--parent DIR] [--sass DIR] [NAME ...]

``--parent DIR`` adds the variants built from another tree's sources (the
``src/`` of an unpacked parent checkout); ``--sass DIR`` writes each
variant's SASS there; default: every variant whose tree is there. The
variants:

  parent        the parent tree's sources as they are;
  base          this checkout's sources as they are;
  nomode        clip_mask's streams drawn group after group (r_i and r_nxt,
                then xi_t, then xi_{t-1}), never all four in one pipeline;
  imad          the threefry adds as multiply-adds by a 1 the compiler
                cannot see (gridDim.y): IMAD on the FMA pipe, not IADD3 on
                the INT32 pipe;
  s1, s4        normals pipelined in stages of 1 or 4 chains (not 2);
                noise_stream's two chains in one stage under s4;
  w1            one element a thread, 256 threads a block, 8 blocks an SM
                (the parent's layout on the new grid);
  w4            four elements a thread (16-byte accesses), 64 threads a
                block;
  two           half the blocks, so every thread takes two groups: what a
                warp's first group costs beyond its second.

For each variant, at the wire tier's P = 235,520 (MNIST-MLP3): row 8
(``clip_mask_f32``, silo 1, nxt 3, both flags), row 14
(``clip_mask_ext_f32`` reading xi and xi_{t-1}) and row 13
(``noise_stream_f32``), each on the card (50 launches in a CUDA graph, the
mean of 20 replays); row 8 at the training shape (P = 1,547,255,808, CUDA
events over 3 calls). Every output is compared with the first variant's
bit for bit (the parent's, itself bit-equal to the plain version). Two
rounds, the variants in turn and then in reverse.

What each kernel takes: ``nvcc -Xptxas -v`` (registers, spills) and, from
the runtime, registers, local memory and the blocks an SM holds
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), for the three stream
kernels of every variant and, from the first variant's tree, for the other
users of ``grid_stride_blocks`` (``noise_batch``, ``clip_accumulate``) and
for ``zsmask``.

Where a launch's time goes: each variant is built a second time with
per-block spans (``clock64`` and ``%globaltimer`` at the first warp's
start and the last warp's end, and ``%smid``), one launch a shape: the
blocks an SM ran and how many at once, blocks that started after another
on the same SM ended (a second wave), the spread of block starts (the
ramp) and ends (the tail), the cycles a block took, the SM clock.

The card's name and power limit come first; the last line is the JSON
record.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

KERN = Path("repro_torch") / "kernels"
STREAM_FILES = ("dp_fused/csrc/clip_mask.cu", "dp_fused/csrc/noise_stream.cu")
OTHER_FILES = ("dp_fused/csrc/noise_batch.cu", "dp_clip/csrc/clip_accumulate.cu",
               "zsmask/csrc/zsmask.cu")
# kernel expressions and their block size, by file
PROBES = {"clip_mask.cu": (("clip_mask_kernel<false>", "CM_THREADS"),
                           ("clip_mask_kernel<true>", "CM_THREADS")),
          "noise_stream.cu": (("noise_stream_kernel", "NS_THREADS"),),
          "noise_batch.cu": (("noise_batch_kernel", "NB_THREADS"),),
          "clip_accumulate.cu": (("clip_accumulate_kernel", "CA_THREADS"),),
          "zsmask.cu": (("zsmask_kernel", "ZS_THREADS"),)}
SPAN_KERNELS = {"clip_mask.cu": "clip_mask_kernel",
                "noise_stream.cu": "noise_stream_kernel"}


def _const(name: str, value: int) -> tuple:
    return (rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


def _layout(cm: tuple, ns: tuple) -> list:
    """Edits for clip_mask's (width, threads, stage, min blocks) and
    noise_stream's."""
    return [_const(f"{k}_{n}", v) for k, knobs in (("CM", cm), ("NS", ns))
            for n, v in zip(("WIDTH", "THREADS", "STAGE", "MIN_BLOCKS"), knobs)]


def _text(old: str, new: str) -> tuple:
    return (re.escape(old), new.replace("\\", "\\\\"))


# the threefry adds as integer multiply-adds by gridDim.y, 1 at run time
# and unknown to the compiler: they issue as IMAD on the FMA pipe, not as
# IADD3 on the INT32 pipe
IMAD_ADDS = [_text("x0[n] += x1[n];", "x0[n] = x1[n] * gridDim.y + x0[n];"),
             _text("x0[n] += ks[(i + 1) % 3];",
                   "x0[n] = ks[(i + 1) % 3] * gridDim.y + x0[n];"),
             _text("x1[n] += ks[(i + 2) % 3] + (uint32_t)(i + 1);",
                   "x1[n] = (ks[(i + 2) % 3] + (uint32_t)(i + 1)) * gridDim.y "
                   "+ x1[n];")]

VARIANTS = {
    "parent": ("parent", []),
    "base": ("base", []),
    "nomode": ("base", [_text("if (pair && prev && !read_x && !read_v)",
                              "if (false)")]),
    "imad": ("base", IMAD_ADDS),
    "s1": ("base", _layout((2, 128, 1, 7), (2, 128, 1, 7))),
    "s4": ("base", _layout((2, 128, 4, 7), (2, 128, 2, 7))),
    "w1": ("base", _layout((1, 256, 2, 8), (1, 256, 1, 8))),
    "w4": ("base", _layout((4, 64, 2, 7), (4, 64, 2, 7))),
    "two": ("base", [_text("long long b = (lay.groups + threads - 1) / threads;",
                           "long long b = (lay.groups + 2 * threads - 1) / "
                           "(2 * threads);")]),
}
P_WIRE = 235_520
P_TRAIN = 1_547_255_808
KR, KX, KP = (3704974950, 1863054868), (2705940334, 2639757084), \
    (4086990474, 1067026239)
SPAN_WORDS = 5  # smid, clock64 start, end, globaltimer start, end

PRELUDE = """
static __device__ unsigned long long* repro_probe_spans;
static __device__ unsigned long long* repro_probe_warps;
static __device__ __forceinline__ unsigned long long repro_probe_warpid() {
  unsigned w;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(w));
  return w;
}
static __device__ __forceinline__ unsigned long long repro_probe_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
static __device__ __forceinline__ unsigned long long repro_probe_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
"""
SPAN_BEGIN = ("\n  const unsigned long long repro_c0 = (unsigned long long)clock64(),"
              " repro_g0 = repro_probe_gt();\n")
SPAN_END = """
  {
    const unsigned long long repro_c1 = (unsigned long long)clock64(),
                             repro_g1 = repro_probe_gt();
    unsigned long long* repro_s = repro_probe_spans;
    if (repro_s != nullptr && (threadIdx.x & 31) == 0) {
      repro_s += 5ull * blockIdx.x;
      repro_s[0] = repro_probe_smid();
      atomicMin(repro_s + 1, repro_c0);
      atomicMax(repro_s + 2, repro_c1);
      atomicMin(repro_s + 3, repro_g0);
      atomicMax(repro_s + 4, repro_g1);
      unsigned long long* repro_w = repro_probe_warps +
          4ull * (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32);
      repro_w[0] = repro_probe_smid();
      repro_w[1] = repro_probe_warpid();
      repro_w[2] = repro_c0;
      repro_w[3] = repro_c1;
    }
  }
"""


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def body_span(text: str, name: str) -> tuple:
    """(index after the opening brace, index of the closing brace) of the
    __global__ function ``name``'s body."""
    m = re.search(r"__global__[^;{]*?\b" + name + r"\s*\(", text, re.S)
    if m is None:
        raise ValueError(f"no __global__ {name}")
    i, depth = m.end(), 1
    while depth:
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        i += 1
    i = text.index("{", i) + 1
    start, depth = i, 1
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    return start, i - 1


def with_spans(text: str, stem: str, kernel: str) -> str:
    a, b = body_span(text, kernel)
    text = text[:a] + SPAN_BEGIN + text[a:b] + SPAN_END + text[b:]
    last = list(re.finditer(r"^#include .*$", text, re.M))[-1].end()
    text = text[:last] + "\n" + PRELUDE + text[last:]
    return text + (f"\nREPRO_API int probe_spans_{stem}(void* p, void* w) {{\n"
                   f"  cudaError_t e = cudaMemcpyToSymbol(repro_probe_spans, &p, "
                   f"sizeof(p));\n"
                   f"  if (e != cudaSuccess) return e;\n"
                   f"  return cudaMemcpyToSymbol(repro_probe_warps, &w, "
                   f"sizeof(w));\n}}\n")


def with_probes(text: str, fname: str) -> str:
    stem = Path(fname).stem
    for i, (kern, threads) in enumerate(PROBES[fname]):
        text += f"""
REPRO_API int probe_{stem}_{i}(int* o) {{
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, {kern});
  if (e != cudaSuccess) return e;
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  o[2] = {threads};
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 3, {kern}, {threads}, 0);
}}
"""
    return text


def write_tree(src_kernels: Path, out: Path, edits: list, files: tuple,
               spans: bool) -> list:
    """Copy the headers and ``files`` under ``out``, both edited; returns
    the .cu paths."""
    (out / "csrc").mkdir(parents=True, exist_ok=True)
    for h in (src_kernels / "csrc").glob("*.cuh"):
        text = h.read_text()
        for pat, rep in edits:
            text = re.sub(pat, rep, text)
        (out / "csrc" / h.name).write_text(text)
    cus = []
    for rel in files:
        text = (src_kernels / rel).read_text()
        for pat, rep in edits:
            text = re.sub(pat, rep, text)
        name = Path(rel).name
        text = with_probes(text, name)
        if spans and name in SPAN_KERNELS:
            text = with_spans(text, Path(rel).stem, SPAN_KERNELS[name])
        dst = out / name
        dst.write_text(text)
        cus.append(dst)
    return cus


def compile_lib(cus: list, inc: Path, so: Path) -> tuple:
    """nvcc each source (-Xptxas -v) and link; (ok, ptxas text)."""
    exe = _build.nvcc()
    objs, logs = [], []
    for cu in cus:
        obj = cu.with_suffix(".o")
        r = subprocess.run([exe, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                            str(inc), "-c", str(cu), "-o", str(obj)],
                           capture_output=True, text=True)
        logs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            return False, "\n".join(logs)
        objs.append(obj)
    r = subprocess.run([exe, *_build.NVCC_FLAGS, "-shared", *map(str, objs),
                        "-o", str(so)], capture_output=True, text=True)
    logs.append(r.stdout + r.stderr)
    return r.returncode == 0, "\n".join(logs)


def ptxas_summary(text: str) -> dict:
    """Registers and spills a kernel, from ``-Xptxas -v``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, {})["spill_bytes"] = [int(m.group(1)),
                                                     int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def sass_counts(so: Path, name: str, out: Path | None) -> dict:
    """Each stream kernel's instructions a normal in its loop
    (``chip_smoke.stream_ops``) from the library's SASS, which is written
    to ``out``/<name>.sass when ``out`` is given."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    r = subprocess.run([str(Path(_build.nvcc()).with_name("cuobjdump")),
                        "-sass", str(so)], capture_output=True, text=True)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.sass").write_text(r.stdout)
    return {k: chip_smoke.stream_ops(r.stdout, rx) for k, rx in (
        ("clip_mask", chip_smoke.ROW8_SASS),
        ("clip_mask_ext", r"clip_mask_kernelILb1EE"),
        ("noise_stream", "noise_stream_kernel"))}


class Lib:
    """A variant's library with the production entry points bound."""

    def __init__(self, so: Path):
        P, I, L, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint32)
        self.lib = lib = ctypes.CDLL(str(so))
        for name, args in (
                ("clip_mask_f32", [P, P, L] + [U] * 8 + [P, I, I, P]),
                ("clip_mask_ext_f32", [P] * 4 + [L] + [U] * 8 + [P, I, I, P]),
                ("noise_stream_f32", [P, L, U, U, U, P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, I
        self.stream = torch.cuda.current_stream().cuda_stream

    def _ok(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    def clip_mask(self, g, out, sc):
        s = torch.cuda.current_stream().cuda_stream
        self._ok(self.lib.clip_mask_f32(g.data_ptr(), out.data_ptr(),
                                        g.numel(), *KR, *KX, *KP, 1, 3,
                                        sc.data_ptr(), 1, 1, s), "clip_mask")
        return out

    def clip_mask_ext(self, g, xi, xp, out, sc):
        s = torch.cuda.current_stream().cuda_stream
        self._ok(self.lib.clip_mask_ext_f32(
            g.data_ptr(), xi.data_ptr(), xp.data_ptr(), out.data_ptr(),
            g.numel(), *KR, *KX, *KP, 1, 3, sc.data_ptr(), 1, 1, s),
            "clip_mask_ext")
        return out

    def noise_stream(self, key, out):
        s = torch.cuda.current_stream().cuda_stream
        self._ok(self.lib.noise_stream_f32(out.data_ptr(), out.numel(), *key,
                                           1, s), "noise_stream")
        return out

    def probes(self, fname: str) -> list:
        stem = Path(fname).stem
        rows = []
        for i, (kern, _) in enumerate(PROBES[fname]):
            o = (ctypes.c_int * 4)()
            self._ok(getattr(self.lib, f"probe_{stem}_{i}")(o), kern)
            rows.append({"kernel": kern, "registers": o[0],
                         "local_bytes": o[1], "threads": o[2],
                         "blocks_per_sm": o[3]})
        return rows


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, n: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay) / n


def spans_of(lib: Lib, stem: str, launch, max_blocks: int) -> dict:
    """One launch with per-block spans, read back and summarised."""
    buf = torch.zeros(max_blocks, SPAN_WORDS, dtype=torch.int64, device="cuda")
    buf[:, 1] = -1  # the atomicMin slots start at the largest unsigned value
    buf[:, 3] = -1
    warps = torch.zeros(max_blocks * 32, 4, dtype=torch.int64, device="cuda")
    setter = getattr(lib.lib, f"probe_spans_{stem}")
    setter.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    setter.restype = ctypes.c_int
    lib._ok(setter(buf.data_ptr(), warps.data_ptr()), "spans")
    launch()
    torch.cuda.synchronize()
    lib._ok(setter(None, None), "spans")
    per_sp = sp_timelines(warps.cpu().numpy().view(np.uint64))
    s = buf.cpu().numpy().view(np.uint64)
    s = s[s[:, 2] > 0].astype(np.float64)
    sm, c0, c1, g0, g1 = s.T
    t0 = g0.min()
    gt = np.unique(np.concatenate([g0, g1]))
    res = float(np.diff(gt).min()) if len(gt) > 1 else None
    cyc = c1 - c0
    per_sm, late, conc, sm_cyc = {}, 0, [], []
    for k in np.unique(sm):
        idx = np.where(sm == k)[0]
        a, b = c0[idx], c1[idx]
        per_sm[int(k)] = len(idx)
        late += int(sum((a[i] > b).any() for i in range(len(idx))))
        ev = sorted([(x, 1) for x in a] + [(x, -1) for x in b],
                    key=lambda e: (e[0], e[1]))
        cur = top = 0
        for _, d in ev:
            cur += d
            top = max(top, cur)
        conc.append(top)
        sm_cyc.append(b.max() - a.min())
    longest = int(np.argmax(g1 - g0))
    mhz = cyc[longest] / (g1[longest] - g0[longest]) * 1e3 \
        if g1[longest] > g0[longest] else None
    pct = lambda x: [float(np.percentile(x, q)) for q in (0, 50, 90, 100)]
    return {
        "blocks": int(len(s)), "sms": len(per_sm),
        "blocks_per_sm_max": max(per_sm.values()),
        "blocks_per_sm_min": min(per_sm.values()),
        "concurrent_per_sm_max": max(conc), "late_blocks": late,
        "span_us": float((g1.max() - t0) / 1e3),
        "start_us_p0_50_90_100": [x / 1e3 for x in pct(g0 - t0)],
        "end_us_p0_50_90_100": [x / 1e3 for x in pct(g1 - t0)],
        "block_cycles_min_mean_max": [float(cyc.min()), float(cyc.mean()),
                                      float(cyc.max())],
        "sm_busy_cycles_mean_max": [float(np.mean(sm_cyc)),
                                    float(np.max(sm_cyc))],
        "sm_mhz": mhz, "globaltimer_step_ns": res, **per_sp}


def sp_timelines(w: np.ndarray) -> dict:
    """Per scheduler (an SM's warp slot mod 4): its warps' spans in SM
    cycles, from the first warp's start. Means over schedulers of the span,
    of the first warp's end, and of the tail, the cycles during which at
    most two of its warps were still running; the warps a scheduler ran."""
    w = w[w[:, 3] > 0].astype(np.float64)
    spans, firsts, tails, counts = [], [], [], []
    for sm in np.unique(w[:, 0]):
        on = w[w[:, 0] == sm]
        for q in range(4):
            x = on[on[:, 1] % 4 == q]
            if not len(x):
                continue
            t0, ends = x[:, 2].min(), np.sort(x[:, 3])
            spans.append(ends[-1] - t0)
            firsts.append(ends[0] - t0)
            tails.append(ends[-1] - (ends[-3] if len(ends) >= 3 else t0))
            counts.append(len(x))
    m = lambda v: float(np.mean(v)) if v else None
    return {"sp_span_cycles_mean": m(spans), "sp_first_end_cycles_mean":
            m(firsts), "sp_tail_cycles_mean": m(tails),
            "warps_per_sp_min_max": [int(min(counts)), int(max(counts))]
            if counts else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_stream_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    trees = {"base": ROOT / "src" / KERN}
    if "--parent" in args:
        i = args.index("--parent")
        trees["parent"] = Path(args[i + 1]).resolve() / KERN
        del args[i:i + 2]
    sass_dir = None
    if "--sass" in args:
        i = args.index("--sass")
        sass_dir = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    names = args or [n for n, (t, _) in VARIANTS.items() if t in trees]
    card = card_line()
    log(card)
    tmp = Path(tempfile.mkdtemp(prefix="stream_variants_",
                                dir=os.environ.get("TMPDIR")))
    jobs = []
    for n in names:
        tree = trees[VARIANTS[n][0]]
        for spans in (False, True):
            d = tmp / (n + ("-spans" if spans else ""))
            files = STREAM_FILES + (OTHER_FILES if n == names[0]
                                    and not spans else ())
            cus = write_tree(tree, d, VARIANTS[n][1], files, spans)
            jobs.append((n, spans, cus, d / "csrc", d / "lib.so"))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as ex:
        built = list(ex.map(lambda j: compile_lib(j[2], j[3], j[4]), jobs))
    libs, spans_libs, record = {}, {}, {"card": card, "variants": {}}
    for (n, spans, cus, _, so), (ok, text) in zip(jobs, built):
        if not ok:
            log(f"[build] {n}{' spans' if spans else ''} FAILED:\n{text[-3000:]}")
            continue
        if spans:
            spans_libs[n] = Lib(so)
            continue
        libs[n] = Lib(so)
        rec = record["variants"].setdefault(n, {})
        rec["sass"] = sass_counts(so, n, sass_dir)
        rec["ptxas"] = ptxas_summary(text)
        rec["runtime"] = [r for c in cus for r in libs[n].probes(c.name)]
        log(f"[build] {n}: ptxas {json.dumps(rec['ptxas'])}")
        log(f"[sass] {n}: {json.dumps(rec['sass'])}")
        for r in rec["runtime"]:
            log(f"[probe] {n}: {json.dumps(r)}")
    names = [n for n in names if n in libs]
    if not names:
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    sc = torch.tensor([0.731, 0.6928, 9.6, 0.7, 0.6], device=dev)
    g = torch.randn(P_WIRE, generator=gen, device=dev) * 0.01
    first = libs[names[0]]
    xi = first.noise_stream(KX, torch.empty(P_WIRE, device=dev))
    xp = first.noise_stream(KP, torch.empty(P_WIRE, device=dev))
    want = {"clip_mask": first.clip_mask(g, torch.empty_like(g), sc),
            "clip_mask_ext": first.clip_mask_ext(g, xi, xp,
                                                 torch.empty_like(g), sc),
            "noise_stream": first.noise_stream(KX, torch.empty_like(g))}
    gt = torch.randn(P_TRAIN, generator=gen, device=dev) * 0.01
    out_t = torch.empty_like(gt)
    want["train"] = first.clip_mask(gt, torch.empty_like(gt), sc)
    out = torch.empty_like(g)
    calls = lambda lib: {
        "clip_mask": lambda: lib.clip_mask(g, out, sc),
        "clip_mask_ext": lambda: lib.clip_mask_ext(g, xi, xp, out, sc),
        "noise_stream": lambda: lib.noise_stream(KX, out)}
    for n in names:
        lib, rec = libs[n], record["variants"][n]
        eq = {}
        for k, fn in calls(lib).items():
            eq[k] = bool(torch.equal(fn(), want[k]))
        eq["train"] = bool(torch.equal(lib.clip_mask(gt, out_t, sc),
                                       want["train"]))
        rec["bit_equal_to_" + names[0]] = eq
        log(f"[equal] {n} vs {names[0]}: {json.dumps(eq)}")
    for rnd, order in enumerate((names, names[::-1])):
        for n in order:
            lib, rec = libs[n], record["variants"][n]
            t = {k: graph_ms(fn) for k, fn in calls(lib).items()}
            t["train"] = cuda_ms(lambda: lib.clip_mask(gt, out_t, sc), reps=3,
                                 warmup=1)
            for k, v in t.items():
                rec.setdefault("ms", {}).setdefault(k, []).append(v)
            log(f"[time] round {rnd} {n}: " + " | ".join(
                f"{k} {v:.5f} ms" for k, v in t.items()))
    del want["train"], out_t
    for n in names:
        if n not in spans_libs:
            continue
        lib, rec = spans_libs[n], record["variants"][n]
        o = torch.empty_like(g)
        rows = {
            "clip_mask": spans_of(lib, "clip_mask",
                                  lambda: lib.clip_mask(g, o, sc), 1 << 16),
            "clip_mask_ext": spans_of(
                lib, "clip_mask", lambda: lib.clip_mask_ext(g, xi, xp, o, sc),
                1 << 16),
            "noise_stream": spans_of(lib, "noise_stream",
                                     lambda: lib.noise_stream(KX, o), 1 << 16),
            "train": spans_of(lib, "clip_mask",
                              lambda: lib.clip_mask(gt, gt, sc), 1 << 16)}
        rec["spans"] = rows
        for k, r in rows.items():
            log(f"[spans] {n} {k}: {json.dumps(r)}")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    record["clocks_after"] = clocks.strip()
    log(card)
    log(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
