"""The port stands alone: importing every ``repro_torch`` module,
``chip_smoke.py`` and ``examples/collaborative_mnist_torch.py`` leaves
``jax`` and every ``repro`` module out of ``sys.modules``. Checked in a
fresh interpreter, since this test process imports both packages."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
spec = importlib.util.spec_from_file_location(
    "collaborative_mnist_torch", "examples/collaborative_mnist_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 92, names
# the training slices' modules are among those imported
for name in ("core.prng", "core.flatbuf", "core.clipping", "core.barrier",
             "core.noise_correction", "core.dp_pipeline",
             "core.privacy.bounds", "core.privacy.ledger",
             "kernels.zsmask.threefry", "kernels.dp_clip.ops",
             "kernels.dp_fused.ops", "kernels.dp_fused.ref",
             "kernels.dp_fused.dp_fused", "optim.optimizers",
             "optim.schedules", "distributed.steps", "data.synthetic",
             "runtime.trainer", "analysis.report", "launch.train",
             # the per-example and per-leaf slice
             "core.masking", "kernels.dispatch", "kernels.zsmask.ref",
             "kernels.zsmask.zsmask", "kernels.zsmask.ops",
             "kernels.dp_clip.dp_clip", "kernels.dp_clip.ref",
             # the ssm and hybrid serving slice
             "configs.rwkv6_7b", "configs.zamba2_7b", "kernels.rwkv6.ref",
             "kernels.rwkv6.rwkv6", "kernels.rwkv6.ops", "kernels.mamba2.ref",
             "kernels.mamba2.mamba2", "kernels.mamba2.ops", "models.rwkv6",
             "models.rwkv_stack", "models.mamba2", "models.hybrid",
             # the wire tier
             "configs.paper_models", "models.small", "core.tee",
             "core.tee.attestation", "core.tee.kds", "core.tee.sandbox",
             "core.tee.channels", "core.tee.merkle", "core.tee.wire",
             "core.tee.components", "runtime.elastic", "runtime.straggler",
             # the wire tier's speculative and fault-tolerant rounds
             "core.tee.faults"):
    assert "repro_torch." + name in names, name
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("[]")
