#!/usr/bin/env python3
"""Time variants of the scans' backward kernels (``wkv_bwd``, ``ssd_bwd``)
side by side on one GPU: each variant is this checkout's sources with a
few text edits, compiled by ``nvcc`` into a library of its own under
``$TMPDIR`` and timed at the training shapes and at S 512 in one process,
on the same inputs.

    python3 tools/time_bwd_variants.py [NAME ...]   # default: every variant
    python3 tools/time_bwd_variants.py --phases     # where a block's cycles go

A variant that changes the arithmetic computes wrong gradients on purpose
(it removes work to measure what that work costs): its line prints its
largest difference from the base variant's outputs, and only ``base`` is a
kernel of the port. The variants:

  base         the sources as they are;
  noshfl       the lanes' halving without its shuffles (each lane adds its
               own other half): the shuffles' cost;
  onesite      ``walk_back`` with one call site of each half, each token's
               state re-stepped from the sub-checkpoint (6 steps a
               sub-chunk, not 4) and no second register tile;
  serial       each token's sums right after its partials (no overlap of
               two tokens' shuffle chains);
  reorder      the gradients' multiply-adds with their shared operand in
               the same slot (products commute: the same bits);
  nostep       ``walk_back`` without its state steps (the reverse walk on
               the sub-checkpoints' states): the steps' cost;
  nopassstart  without the sums each pass takes before its walk (c_t for
               ``wkv_bwd``, dt_t (x_t . dy_t) for ``ssd_bwd``).

Times are the card's (20 calls in a CUDA graph, the mean of 10 replays),
each call both launches (the scan and the sum over b or heads). The card's
name and power limit come first; the ptxas register counts print beside
each variant.

``--phases`` builds the sources with ``clock64()`` read by thread 0 of
each block at the walk's phase boundaries and prints, for each kernel at
the training shape and at S 512, the mean SM cycles a block spends in: the
forward walk; the start of each reverse pass (the last sub-chunk's combine,
the ``cp.async`` wait and the sync); the sums a pass takes before its
walk; the sub-checkpoints with their sync and each sub-chunk's sync and
combine; the reverse walks (``walk_back``); and in all. Then the time of
``ssd_bwd``'s second launch alone (the sum over heads) and the SM clock
``nvidia-smi`` reads.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

K = ROOT / "src" / "repro_torch" / "kernels"
FILES = {"scan_tile.cuh": K / "csrc" / "scan_tile.cuh",
         "common.cuh": K / "csrc" / "common.cuh",
         "error.cu": K / "csrc" / "error.cu",
         "wkv_bwd.cu": K / "rwkv6" / "csrc" / "wkv_bwd.cu",
         "ssd_bwd.cu": K / "mamba2" / "csrc" / "ssd_bwd.cu"}

WALK = """  for (int e = nq; e > 0; e -= 2) {
    tile_from_smem<THREADS>(slot, x);
    if (e >= 2) {
      for (int s = 0; s < e - 2; ++s) step(x, t0 + s);
#pragma unroll
      for (int f = 0; f < E; ++f) y[f] = x[f];
      step(y, t0 + e - 2);
      grad(t0 + e - 1, y, pa);
      grad(t0 + e - 2, x, pb);
      emit(t0 + e - 1, pa);
      emit(t0 + e - 2, pb);
    } else {
      grad(t0, x, pa);
      emit(t0, pa);
    }
  }"""
WALK_ONE = """  for (int t = t0 + nq - 1; t >= t0; --t) {
    tile_from_smem<THREADS>(slot, x);
    for (int s = t0; s < t; ++s) step(x, s);
    grad(t, x, pa);
    emit(t, pa);
  }"""
WALK_SERIAL = WALK.replace("""      grad(t0 + e - 1, y, pa);
      grad(t0 + e - 2, x, pb);
      emit(t0 + e - 1, pa);
      emit(t0 + e - 2, pb);""", """      grad(t0 + e - 1, y, pa);
      emit(t0 + e - 1, pa);
      grad(t0 + e - 2, x, pb);
      emit(t0 + e - 2, pb);""")
WALK_NOSTEP = WALK.replace(
    "      for (int s = 0; s < e - 2; ++s) step(x, t0 + s);\n", "").replace(
    "      step(y, t0 + e - 2);\n", "")
PASS_START = ("        if (tt < nt)\n#pragma unroll\n          for (int y = 0;",
              "        if (tt < 0)\n#pragma unroll\n          for (int y = 0;")
VARIANTS = {
    "base": [],
    "noshfl": [
        ("scan_tile.cuh",
         "v[i] = (up ? hi : lo) + __shfl_xor_sync(FULL_MASK, up ? lo : hi, S);",
         "v[i] = (up ? hi : lo) + (up ? lo : hi);"),
        ("scan_tile.cuh",
         "v[i] += __shfl_xor_sync(FULL_MASK, v[i], S >> l);",
         "v[i] += v[i];")],
    "onesite": [("scan_tile.cuh", WALK, WALK_ONE)],
    "serial": [("scan_tile.cuh", WALK, WALK_SERIAL)],
    "reorder": [
        ("wkv_bwd.cu", """            sdr = fmaf(s, dd[q4], sdr);
            sdk = fmaf(g, vv[q4], sdk);
            sdw = fmaf(g, s, sdw);
            pt.adv[q4] = fmaf(g, kk[i], pt.adv[q4]);""",
         """            sdr = fmaf(s, dd[q4], sdr);
            sdw = fmaf(s, g, sdw);
            sdk = fmaf(vv[q4], g, sdk);
            pt.adv[q4] = fmaf(kk[i], g, pt.adv[q4]);"""),
        ("ssd_bwd.cu", """            pt.hb[i] = fmaf(Ht, bb[q4], pt.hb[i]);
            pt.dd[1] = fmaf(Ht, hprev, pt.dd[1]);
            pt.red[q4] = fmaf(Ht, xdt, pt.red[q4]);
            pt.red[4 + q4] = fmaf(hprev, dyy[i], pt.red[4 + q4]);""",
         """            pt.hb[i] = fmaf(Ht, bb[q4], pt.hb[i]);
            pt.red[q4] = fmaf(Ht, xdt, pt.red[q4]);
            pt.dd[1] = fmaf(hprev, Ht, pt.dd[1]);
            pt.red[4 + q4] = fmaf(hprev, dyy[i], pt.red[4 + q4]);""")],
    "nostep": [("scan_tile.cuh", WALK, WALK_NOSTEP)],
    "nopassstart": [("wkv_bwd.cu", *PASS_START), ("ssd_bwd.cu", *PASS_START)],
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name: str, edits: list, root: Path, src_dir: Path | None = None):
    """(the variant's library with both C entries bound, its registers);
    the sources are this checkout's with ``edits``, or those already in
    ``src_dir``."""
    d = root / name
    if src_dir is None:
        d.mkdir()
        for dst, src in FILES.items():
            s = src.read_text()
            for fname, old, new in edits:
                if fname == dst:
                    if old not in s:
                        raise RuntimeError(f"{name}: {fname} no longer has "
                                           f"{old[:60]!r}")
                    s = s.replace(old, new)
            (d / dst).write_text(s)
    cus = ("wkv_bwd.cu", "ssd_bwd.cu", "error.cu")
    procs = [subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(d),
         "-c", str(d / f), "-o", str(d / f"{f}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f in cus]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{name}: nvcc failed\n" + "\n".join(logs))
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
                    *(str(d / f"{f}.o") for f in cus), "-o",
                    str(d / "lib.so")], check=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    w, s = lib.wkv_bwd_f32, lib.ssd_bwd_f32
    w.argtypes = [_P] * 9 + [ctypes.c_longlong] + [_P] * 7 + [_I] * 4 + [_P]
    s.argtypes = [_P] * 9 + [ctypes.c_longlong] + [_P] * 8 + [_I] * 5 + [_P]
    w.restype = s.restype = _I
    return (w, s), re.findall(r"Used (\d+) registers", "\n".join(logs))


def cases(dev):
    """wkv at (4, S, 64, 64) and ssd at (4, S, 112, 64, 64), S 64 and 512,
    with a state and its cotangent: (inputs, outputs, scratch, shape)."""
    g = torch.Generator(device=dev).manual_seed(0)
    n = lambda *s: torch.randn(*s, device=dev, generator=g)
    e = lambda *s: torch.empty(*s, device=dev)
    out = {"wkv": [], "ssd": []}
    for S in (64, 512):
        B, H, N = 4, 64, 64
        xs = [n(B, S, H, N) * .5 for _ in range(3)] + [
            torch.sigmoid(n(B, S, H, N)) * .5 + .45, n(H, N) * .3,
            n(B, H, N, N) * .1, n(B, S, H, N), n(B, H, N, N) * .1]
        outs = [e(B, S, H, N) for _ in range(4)] + [e(H, N), e(B, H, N, N)]
        scratch = [e(max(B * H * (-(-S // 16) - 2) * N * N, 1)), e(B, H, N)]
        out["wkv"].append((xs, outs, scratch, (B, S, H, N)))
        B, nh, P, N = 4, 112, 64, 64
        xs = [n(B, S, nh, P) * .5, torch.nn.functional.softplus(n(B, S, nh)),
              -n(B, S, nh).abs() * .5, n(B, S, N) * .5, n(B, S, N) * .5,
              n(B, nh, P, N) * .1, n(B, S, nh, P), n(B, nh, P, N) * .1]
        outs = [e(B, S, nh, P), e(B, S, nh), e(B, S, nh), e(B, S, N),
                e(B, S, N), e(B, nh, P, N)]
        scratch = [e(max(B * nh * (-(-S // 16) - 2) * P * N, 1)),
                   e(B, S, nh, N), e(B, S, nh, N)]
        out["ssd"].append((xs, outs, scratch, (B, S, nh, P, N)))
    return out


def launch_wkv(fn, case):
    xs, o, (ck, dp), (B, S, H, N) = case
    err = fn(*(t.data_ptr() for t in xs), ck.data_ptr(), ck.numel(),
             dp.data_ptr(), *(t.data_ptr() for t in o), B, S, H, N,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"wkv_bwd: CUDA error {err}"


def launch_ssd(fn, case):
    xs, o, (ck, pb, pc), (B, S, nh, P, N) = case
    err = fn(*(t.data_ptr() for t in xs), ck.data_ptr(), ck.numel(),
             pb.data_ptr(), pc.data_ptr(), *(t.data_ptr() for t in o),
             B, S, nh, P, N, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"ssd_bwd: CUDA error {err}"


def card_ms(fn, calls: int = 20, replays: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / replays / calls


PHASES = ("forward walk", "pass starts", "pass-start sums",
          "sub-checkpoints, syncs, combines", "reverse walks")


def phase_sources(d: Path) -> None:
    """The sources with the phase clock, into d (thread 0 of each block
    adds the cycles since the last mark into its phase's counter)."""
    marks = [
        ("namespace {\n", "__device__ unsigned long long g_phase[1024 * 8];\n"
         "namespace {\n"),
        ("  float X[E], Y[E]",
         "  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tc = clock64(),"
         " t00 = tc;\n  auto mark = [&](int i) { const unsigned long long n ="
         " clock64(); ph[i] += n - tc; tc = n; };\n  float X[E], Y[E]"),
        ("  // the reverse walk\n", "  mark(0);\n  // the reverse walk\n"),
        ("    cp_async_commit();\n    const float* buf = smem + (p & 1) * K::BUF;"
         "\n    //", "    mark(1);\n    cp_async_commit();\n    const float* buf"
         " = smem + (p & 1) * K::BUF;\n    //"),
        ("    // the sub-checkpoints, from the state before the pass\n",
         "    mark(2);\n    // the sub-checkpoints, from the state before the"
         " pass\n"),
        ("      walk_back<THREADS>(", "      mark(3);\n      walk_back<THREADS>("),
        ("      __syncthreads();  // the sub-chunk's",
         "      mark(4);\n      __syncthreads();  // the sub-chunk's"),
    ]
    flush = ("  mark(3);\n  if (threadIdx.x == 0) { for (int i = 0; i < 7; ++i)"
             " g_phase[blockIdx.x * 8 + i] = ph[i]; g_phase[blockIdx.x * 8 + 7] ="
             " clock64() - t00; }\n")
    for dst, src in FILES.items():
        s = src.read_text()
        if dst in ("wkv_bwd.cu", "ssd_bwd.cu"):
            for old, new in marks + [("  store_tile(ds0 + sbase, G);",
                                      flush + "  store_tile(ds0 + sbase, G);"),
                                     ("  store_tile(dh0 + hbase, Hc);",
                                      flush + "  store_tile(dh0 + hbase, Hc);")]:
                if old in s:
                    s = s.replace(old, new, 1)
                elif "store_tile" not in old:
                    raise RuntimeError(f"{dst} no longer has {old[:60]!r}")
            name = dst.split("_")[0]
            s += (f"\nREPRO_API int phase_read_{name}(unsigned long long* h, int n)"
                  " { return cudaMemcpyFromSymbol(h, g_phase, n * 8); }\n")
            if name == "ssd":
                s += ("REPRO_API int ssd_heads_sum(const float* pb, const float* pc,"
                      " float* dB, float* dC, long long BS, int nh, int N,"
                      " cudaStream_t st) { ssd_dbc_kernel<<<(unsigned)((BS * N +"
                      " 255) / 256), 256, 0, st>>>(pb, pc, dB, dC, BS, nh, N);"
                      " return cudaGetLastError(); }\n")
        (d / dst).write_text(s)


def phases(dev, data, root: Path) -> None:
    d = root / "phases"
    d.mkdir()
    phase_sources(d)
    (w, s), _ = build("phases", [], d.parent, src_dir=d)
    lib = ctypes.CDLL(str(d / "lib.so"))
    for name, fn, launch, blocks in (("wkv_bwd", w, launch_wkv, 256),
                                     ("ssd_bwd", s, launch_ssd, 448)):
        read = getattr(lib, f"phase_read_{name[:3]}")
        read.argtypes, read.restype = [_P, _I], _I
        for case in data[name[:3]]:
            for _ in range(3):
                launch(fn, case)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (blocks * 8))()
            assert read(buf, blocks * 8) == 0
            cyc = torch.tensor(list(buf), dtype=torch.float64).view(blocks, 8)
            mean = cyc.mean(0)
            parts = " | ".join(f"{p} {mean[i]:.0f}" for i, p in enumerate(PHASES))
            print(f"{name} S {case[3][1]}: cycles a block: {parts} | in all "
                  f"{mean[7]:.0f} (most {cyc[:, 7].max():.0f})", flush=True)
    heads = lib.ssd_heads_sum
    heads.argtypes, heads.restype = [_P] * 4 + [ctypes.c_longlong, _I, _I, _P], _I
    xs, o, (ck, pb, pc), (B, S, nh, P, N) = data["ssd"][0]
    ms = card_ms(lambda: heads(pb.data_ptr(), pc.data_ptr(), o[3].data_ptr(),
                               o[4].data_ptr(), B * S, nh, N,
                               torch.cuda.current_stream().cuda_stream))
    print(f"ssd_bwd's sum over heads alone, S {S}: {ms:.4f} ms on the card")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"SM clock (now, max): {clocks}")


def main(names: list) -> int:
    if not torch.cuda.is_available():
        print("time_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    data = cases(dev)
    root = Path(tempfile.mkdtemp(prefix="bwd_variants_"))
    base = None
    try:
        if names == ["--phases"]:
            phases(dev, data, root)
            return 0
        for name in names or list(VARIANTS):
            (w, s), regs = build(name, VARIANTS[name], root)
            t = [card_ms(lambda c=c: launch_wkv(w, c)) for c in data["wkv"]]
            t += [card_ms(lambda c=c: launch_ssd(s, c)) for c in data["ssd"]]
            outs = [x.clone() for c in (data["wkv"][0], data["ssd"][0])
                    for x in c[1]]
            if name == "base":
                base = outs
            diff = "-" if base is None else "%.3g" % max(
                (a - b).abs().max().item() for a, b in zip(outs, base))
            print(f"{name:12s} registers {regs} | wkv_bwd main {t[0]:.4f} "
                  f"S 512 {t[1]:.4f} | ssd_bwd main {t[2]:.4f} S 512 "
                  f"{t[3]:.4f} ms | max diff from base {diff}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
