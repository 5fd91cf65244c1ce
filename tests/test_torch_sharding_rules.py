"""The sharding rules (``repro_torch.distributed.sharding_rules``) against
the JAX package's: every arch's parameter specs (the meta-device specs of
``launch/specs.params_specs``, equal to JAX's leaf by leaf) through
``params_pspecs``, and ``spec_for`` on activations' logical names with
dims that divide and dims that do not (a kv_heads of 3 on a model axis of
2), on the meshes (1,), (4,) data, (2, 2) data x model and (2, 2, 2) pod
x data x model. JAX's side runs under a mesh of that shape in a one-thread
subprocess with 8 host devices (as ``tests/test_multidevice.py`` builds
its (2, 2, 2) mesh); a ``PartitionSpec`` shorter than the rank (JAX's
``P()`` for a leaf no rule names) is padded with ``None``. Then the
one-card mesh: every spec ``None``, ``constrain`` the identity."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import MeshConfig
from repro_torch.distributed import sharding_rules as sr
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import mesh_config

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((1,), ("data",)), "data4": ((4,), ("data",)),
          "dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
# activations' logical names and dims: a kv_heads of 3 that no model axis
# of 2 divides, a batch of 6 that (pod, data) of 4 does not, the rest
# divisible
SPEC_CASES = [
    (("batch", "seq", "kv_heads", "dhead"), (8, 16, 3, 8)),
    (("batch", "seq", "heads", "dhead"), (8, 16, 4, 8)),
    (("batch", "seq", "dmodel"), (6, 32, 64)),
    (("batch", "seq_tp", "ff"), (4, 32, 96)),
    (("seq", "vocab"), (32, 250)),
    (("experts", "fsdp", None), (8, 64, 24)),
    (("layers", "unknown", None), (2, 4, 4)),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp
from repro import configs
from repro.compat import AxisType, make_mesh, set_mesh
from repro.distributed import sharding_rules as sr
from repro.launch import specs
from repro.models.registry import build_model

meshes = json.loads(sys.argv[1])
cases = json.loads(sys.argv[2])

def plain(spec, nd):
    out = [list(a) if isinstance(a, tuple) else a for a in spec]
    return out + [None] * (nd - len(out))

def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v

trees = {}
for arch in configs.ARCH_IDS:
    m = build_model(configs.get_config(arch), param_dtype=jnp.bfloat16,
                    compute_dtype=jnp.bfloat16, remat=True, use_flash=True)
    trees[arch] = specs.params_specs(m)
out = {}
for name, (shape, axes) in meshes.items():
    mesh = make_mesh(tuple(shape), tuple(axes),
                     axis_types=(AxisType.Auto,) * len(axes))
    with set_mesh(mesh):
        out[name] = {
            "spec_for": [plain(sr.spec_for(tuple(l), dims=tuple(d)), len(d))
                         for l, d in cases],
            "params": {arch: {p: plain(s, n) for (p, s), (_, n) in zip(
                flat(sr.params_pspecs(t)),
                ((p, x.ndim) for p, x in flat(t)))}
                for arch, t in trees.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                        json.dumps(MESHES), json.dumps(SPEC_CASES)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def _plain(spec) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_for_equals_jax(jax_specs, mesh_name):
    mesh = MeshConfig(*MESHES[mesh_name])
    got = [_plain(sr.spec_for(logical, dims, mesh))
           for logical, dims in SPEC_CASES]
    assert got == jax_specs[mesh_name]["spec_for"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_pspecs_equal_jax(jax_specs, mesh_name, arch):
    mesh = MeshConfig(*MESHES[mesh_name])
    params = specs.params_specs(dryrun.cell_model(get_config(arch),
                                                  specs.META))
    got = {p: _plain(s) for p, s in _flat(sr.params_pspecs(params, mesh))}
    assert got == jax_specs[mesh_name]["params"][arch]


def test_the_larger_meshes_shard_and_fall_back():
    """The cases hold what they are for: on (2, 2, 2) the kv_heads of 3
    and the batch of 6 fall back to replication, the divisible dims
    shard, the pod axis joins data for batch."""
    mesh = MeshConfig(*MESHES["pdm"])
    assert sr.spec_for(*SPEC_CASES[0], mesh) == (("pod", "data"), ("pod",
                                                 "data"), None, None)
    assert sr.spec_for(*SPEC_CASES[1], mesh)[2] == "model"
    assert sr.spec_for(*SPEC_CASES[2], mesh)[0] is None
    wk = sr.param_spec("layers.attn.wk", (36, 2048, 256), mesh)
    assert wk == (None, "data", "model")


def test_one_card_is_all_replicated_and_constrain_is_the_identity():
    mesh = mesh_config()
    params = specs.params_specs(dryrun.cell_model(get_config("qwen2.5-3b"),
                                                  specs.META))
    for _, spec in _flat(sr.params_pspecs(params, mesh)):
        assert all(a is None for a in spec)
    x = torch.randn(4, 8, 2, 16)
    assert sr.constrain(x, "batch", "seq", "kv_heads", "dhead",
                        mesh=mesh) is x
    assert sr.constrain(x, "batch", "seq", "kv_heads", "dhead",
                        mesh=MeshConfig(*MESHES["dm"])) is x
    with pytest.raises(ValueError, match="names for a"):
        sr.constrain(x, "batch", "seq", mesh=mesh)
