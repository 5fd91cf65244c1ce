"""The yardstick of the wire tier's stream kernels in ``chip_smoke.py``,
on the CPU: the bounds of rows 8, 13 and 14 come from clip_mask's
per-normal SASS counts as the one-element-a-thread layout compiled them,
pinned
(``CLIP_MASK_OPS``), so a redesigned kernel and its parent are held to one
bound; ``stream_ops`` reads a live build's counts off ``cuobjdump -sass``
text whatever its loop holds (one element, or several unrolled), and says
"no loop" rather than raising where no loop draws a normal. The per-leaf
normal draw's bounds (rows 17-18) come the same way from its pinned counts
(``NORMAL_OPS``), which ``normal_ops`` reads off a build with its float64
steps and conversions on pipes of their own; the buffer mask's (row 10's
``zsmask_buffer``) from zsmask's pinned counts (``ZSMASK_OPS``). The canned
texts here have the shape ``cuobjdump -sass`` prints."""
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

P_WIRE = 235_520          # MNIST-MLP3's packed length
P_TRAIN = 1_547_255_808   # qwen2.5-3b at 12 layers (its n_params too)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("row,P,streams,words,want,digits", [
    ("13 noise_stream", P_WIRE, 1, 1, 0.0009, 4),
    ("14 clip_mask_ext", P_WIRE, 2, 4, 0.0018, 4),
    ("8 clip_mask, wire", P_WIRE, 4, 2, 0.0036, 4),
    ("8 clip_mask, training", P_TRAIN, 4, 2, 23.82, 2)])
def test_pinned_counts_give_the_kernel_table_bounds(row, P, streams, words,
                                                    want, digits):
    """PERF.md's bounds of rows 8, 13 and 14, from the pinned counts:
    instruction issue bounds each, above the bytes and every pipe."""
    parts = chip_smoke.stream_bound(P, streams, chip_smoke.CLIP_MASK_OPS,
                                    words)
    assert round(max(parts.values()), digits) == want, (row, parts)
    assert max(parts, key=parts.get) == "issue", (row, parts)
    assert chip_smoke.CLIP_MASK_OPS["issue"] == 128.75


# one normal's arithmetic in a canned loop: a threefry2x32 (20 rounds of
# add, rotate, xor, and the key injections), the uniforms, log, sqrt and
# the cosine polynomial; what stream_ops counts a normal by pipe
NORMAL = (["IADD3", "SHF.L.W.U32.HI", "LOP3.LUT"] * 20
          + ["IMAD.IADD"] * 6 + ["I2FP.F32.U32"] * 2 + ["FADD", "FMUL"] * 2
          + ["MUFU.LG2", "FFMA", "FFMA", "MUFU.RSQ", "FMUL"]
          + ["FFMA"] * 8 + ["FSETP.GEU.AND", "IMAD.MOV.U32 R3, RZ"])
PER_NORMAL = {"alu": 61.0, "imad": 6.0, "fp32+imad": 6.0 + 15.0,
              "mufu": 2.0, "issue": 61.0 + 6.0 + 15.0 + 2.0 + 2.0}


def canned_sass(kernel: str, normals: int, loop: bool, body=NORMAL) -> str:
    """``cuobjdump -sass`` text of one kernel: a prologue, ``normals``
    copies of ``body`` (one normal's arithmetic), then (``loop``) a
    backward branch to the first, and the exit; another kernel's loop
    before it, which must not be read."""
    lines, addr = [], 0

    def emit(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     f"                 /* 0x000fe20000000f00 */")
        addr += 0x10

    lines.append("        Function : _Z5otherv")
    emit("MUFU.RSQ R2, R2")
    emit("BRA 0x0")
    lines.append(f"        Function : {kernel}")
    addr = 0
    emit("MOV R1, c[0x0][0x28]")
    emit("S2R R0, SR_CTAID.X")
    top = addr
    for _ in range(normals):
        for op in body:
            emit(op if " " in op else f"{op} R4, R5, R6")
    if loop:
        emit(f"@!P0 BRA 0x{top:x}")
    emit("EXIT")
    emit(f"BRA 0x{addr:x}")
    return "\n".join(lines) + "\n"


KERNEL = "_ZN12_GLOBAL__N_116clip_mask_kernelILb0EEEvPKf"


@pytest.mark.parametrize("normals", [1, 2, 4])
def test_stream_ops_counts_a_normal_whatever_the_loop_holds(normals):
    """A one-normal loop and the same loop unrolled twice or four times
    give the same counts a normal."""
    r = chip_smoke.stream_ops(canned_sass(KERNEL, normals, True),
                              chip_smoke.ROW8_SASS)
    assert r["normals_in_loop"] == normals
    for k, v in PER_NORMAL.items():
        assert r[k] == pytest.approx(v), (k, r)


@pytest.mark.parametrize("case", ["no loop", "no normal in the loop"])
def test_stream_ops_says_no_loop_and_never_raises(case):
    """A body with no loop, and a loop that draws no normal: reported as
    "no loop" with the reason, no counts; the strict reading the
    live-bounded kernels use raises on it."""
    text = canned_sass(KERNEL, 2, case != "no loop")
    if case == "no normal in the loop":
        text = text.replace("MUFU.RSQ R4", "MUFU.RCP R4")
    r = chip_smoke.stream_ops(text, chip_smoke.ROW8_SASS)
    assert r["loop"] is None and r["why"], r
    assert "issue" not in r
    with pytest.raises(RuntimeError, match="no per-normal count"):
        chip_smoke.live_stream_ops(text, chip_smoke.ROW8_SASS)


def test_stream_ops_counts_a_loop_with_a_rotation_moved_out():
    """A loop whose first-round rotation the compiler moved out of it (a
    counter the same for every element) is still counted, its rotations a
    normal reported below 20; the strict reading refuses it."""
    text = canned_sass(KERNEL, 2, True).replace("SHF.L.W.U32.HI",
                                                "USHF.L.W.U32.HI", 1)
    r = chip_smoke.stream_ops(text, chip_smoke.ROW8_SASS)
    assert r["normals_in_loop"] == 2 and r["rotations"] == 19.5
    assert r["alu"] == pytest.approx(PER_NORMAL["alu"] - 0.5)
    assert chip_smoke.live_stream_ops(canned_sass(KERNEL, 2, True),
                                      chip_smoke.ROW8_SASS)["rotations"] == 20
    with pytest.raises(RuntimeError, match="19.5 rotations"):
        chip_smoke.live_stream_ops(text, chip_smoke.ROW8_SASS)


def test_stream_ops_reads_only_its_kernel():
    """The other kernel's loop (one normal, no rotations) before it is not
    read, and a kernel the text does not hold fails loudly."""
    r = chip_smoke.stream_ops(canned_sass(KERNEL, 1, True),
                              chip_smoke.ROW8_SASS)
    assert r["normals_in_loop"] == 1 and r["mufu"] == 2.0
    with pytest.raises(RuntimeError, match="no SASS"):
        chip_smoke.stream_ops(canned_sass(KERNEL, 1, True), "zsmask_kernel")


# one jax.random.normal's arithmetic in a canned loop: a threefry2x32, the
# mantissa uniform, log1pf, then erf_inv's eight steps, each a widening, a
# float64 multiply-add and a narrowing; what normal_ops counts a normal by
# pipe
ERF_NORMAL = (["IADD3", "SHF.L.W.U32.HI", "LOP3.LUT"] * 20 + ["IMAD.IADD"] * 4
              + ["FADD", "FMUL", "FMNMX", "MUFU.LG2", "FFMA"]
              + ["F2F.F64.F32", "DFMA", "F2F.F32.F64"] * 8
              + ["FSETP.GEU.AND", "FSEL", "FMUL", "IMAD.MOV.U32 R3, RZ"])
ERF_PER_NORMAL = {"alu": 63.0, "imad": 4.0, "fp32+imad": 8.0, "mufu": 1.0,
                  "fp64": 8.0, "conv64": 16.0, "issue": 96.0}
NORMAL_KERNEL = ("_ZN41_GLOBAL__N__d8991193_9_normal_cu_d788736d13normal_kernel"
                 "ILi0EEEvPfx12StreamLayoutyjjjjPKfS4_S4_i")


@pytest.mark.parametrize("normals", [1, 4])
def test_normal_ops_counts_a_normal_whatever_the_loop_holds(normals):
    r = chip_smoke.normal_ops(canned_sass(NORMAL_KERNEL, normals, True,
                                          ERF_NORMAL),
                              chip_smoke.NORMAL_SASS["normal"])
    assert r["normals_in_loop"] == normals
    for k, v in ERF_PER_NORMAL.items():
        assert r[k] == pytest.approx(v), (k, r)
    # the two-key kernel's name is another instantiation: not in this text
    with pytest.raises(RuntimeError, match="no SASS"):
        chip_smoke.normal_ops(canned_sass(NORMAL_KERNEL, 1, True, ERF_NORMAL),
                              chip_smoke.NORMAL_SASS["normal_combine"])


def test_normal_ops_refuses_a_loop_with_no_draw():
    text = canned_sass(NORMAL_KERNEL, 2, True, ERF_NORMAL).replace(
        "DFMA", "FFMA")
    with pytest.raises(RuntimeError, match="draws a normal"):
        chip_smoke.normal_ops(text, chip_smoke.NORMAL_SASS["normal"])


@pytest.mark.parametrize("kernel,n,streams,words,want", [
    ("normal", 1 << 22, 1, 1, 0.0212),
    ("normal", 311_164_928, 1, 1, 1.5696),
    ("normal_combine", 311_164_928, 2, 2, 3.2159),
    ("normal_combine", 1 << 22, 2, 2, 0.0433)])
def test_pinned_normal_counts_give_the_kernel_table_bounds(kernel, n,
                                                           streams, words,
                                                           want):
    """PERF.md's bounds of rows 17 and 18 from the pinned counts:
    instruction issue bounds each, above the bytes, the integer pipe and
    the conversions."""
    parts = chip_smoke.normal_bound(n, streams, words,
                                    chip_smoke.NORMAL_OPS[kernel])
    assert round(max(parts.values()), 4) == want, parts
    assert max(parts, key=parts.get) == "issue", parts
    assert parts["alu"] > parts["conv64"] > parts["bytes"], parts


@pytest.mark.parametrize("cell,n,streams,want", [
    ("CNN6", 307_498, 3, 0.0036),
    ("CNN6, the correction fused in", 307_498, 4, 0.0047),
    ("WRN28", 5_849_050, 3, 0.0677),
    ("WRN28, the correction fused in", 5_849_050, 4, 0.0902),
    ("qwen2.5-3b at 12 layers", P_TRAIN, 3, 17.8988),
    ("qwen2.5-3b at 12 layers, the correction fused in", P_TRAIN, 4,
     23.8651)])
def test_pinned_zsmask_counts_give_the_tree_bounds(cell, n, streams, want):
    """PERF.md's bounds of row 10's tree sub-rows (``zsmask_buffer``) from
    zsmask's pinned counts (``ZSMASK_OPS``): 3 normals an element, 4 with
    the lambda correction fused in; instruction issue bounds each, above
    the bytes (the buffer read and written once)."""
    parts = chip_smoke.stream_bound(n, streams, chip_smoke.ZSMASK_OPS)
    assert round(max(parts.values()), 4) == want, (cell, parts)
    assert max(parts, key=parts.get) == "issue", (cell, parts)
    assert chip_smoke.ZSMASK_OPS["issue"] == 129.0
