"""The port stands alone: importing every ``repro_torch`` module,
``chip_smoke.py`` and the port's examples (``examples/*_torch.py``) leaves
``jax`` and every ``repro`` module out of ``sys.modules``. Checked in a
fresh interpreter, since this test process imports both packages. And no
import statement in those files, at module level or inside a function (the
phases of ``chip_smoke.py``, ``--bf16`` among them, import inside
``main``), names ``jax`` or ``repro``."""
import ast
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
for ex in ("collaborative_mnist_torch", "quickstart_torch",
           "serve_confidential_torch", "federated_healthcare_torch"):
    spec = importlib.util.spec_from_file_location(ex, f"examples/{ex}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 100, names
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
             "core.tee.faults",
             # training the ssm and hybrid families (the scans' backward
             # in kernels.rwkv6.* and kernels.mamba2.*)
             "models.packing", "models.registry", "models.convert",
             # the other dense archs
             "configs.stablelm_3b", "configs.phi3_mini_3_8b",
             "configs.mistral_large_123b",
             # ledger wiring and persistence
             "core.accountant", "data.pipeline", "checkpoint",
             "checkpoint.checkpointer",
             # bf16 serving and the rest of serving
             "api", "launch.serve", "runtime.server",
             "runtime.serving.paged_cache", "runtime.serving.scheduler",
             "runtime.serving.load", "kernels.flash_attention.flash_attention",
             "kernels.paged_attention.paged_attention",
             "kernels.paged_attention.ops", "models.attention",
             "models.transformer", "models.hybrid",
             # the long-context cells: the one-card dry run
             "launch.mesh", "launch.specs", "launch.dryrun",
             # the MoE, VLM and encoder families
             "models.moe", "configs.phi35_moe_42b", "configs.qwen3_moe_235b",
             "configs.qwen2_vl_72b", "configs.hubert_xlarge",
             # the last of the JAX package: the counted step cost, the
             # sharding rules, compression
             "analysis.op_cost", "distributed.sharding_rules",
             "distributed.compression"):
    assert "repro_torch." + name in names, name
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("[]")


def _imported(path: pathlib.Path) -> set:
    """The top-level package of every import statement in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_import_statement_names_jax_or_repro():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "examples").glob("*_torch.py")),
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    assert len(files) > 100
    for path in files:
        bad = _imported(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    assert "repro_torch" in _imported(ROOT / "chip_smoke.py")
