"""Gradient compression (``repro_torch.distributed.compression``) against the
JAX package's: ``compress_leaf`` bit for bit (int8 values and residuals) at
a number and at a tensor scale; ``reduce_compressed`` over stacked ``(n,
...)`` leaves bit for bit against JAX's ``reduce_compressed`` inside
``shard_map`` on a 4-device host mesh, in a one-thread subprocess (the
harness of ``tests/test_torch_barrier.py``), over two steps with the
residuals carried; and JAX's own error-feedback bound
(``tests/test_runtime.py::test_compression_error_feedback_unbiased``)
repeated on the port."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression

ROOT = Path(__file__).resolve().parents[1]
N = 4
SHAPES = {"w": (N, 8, 16), "blk/b": (N, 33), "blk/z": (N, 5)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("scale_kind", ["number", "tensor"])
def test_compress_leaf_bit_equal_to_jax(scale_kind):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((7, 129)) * 0.3).astype(np.float32)
    ef = (rng.standard_normal((7, 129)) * 1e-3).astype(np.float32)
    x = g + ef
    scale = float(np.abs(x).max()) / 127.0
    if scale_kind == "tensor":
        jscale, tscale = jnp.float32(scale), torch.tensor(scale)
    else:
        jscale = tscale = scale
    jq, jr = jcomp.compress_leaf(jnp.asarray(g), jnp.asarray(ef), jscale)
    tq, tr = compression.compress_leaf(torch.from_numpy(g),
                                       torch.from_numpy(ef), tscale)
    assert tq.dtype == torch.int8 and tr.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(np.abs(tq.numpy()).max()) == 127


def test_init_error_feedback_zeros_every_leaf():
    tree = _tree({p: torch.ones(s, dtype=torch.bfloat16)
                  for p, s in SHAPES.items()})
    ef = compression.init_error_feedback(tree)
    for p, t in _flat(ef).items():
        assert t.dtype == np.float32 and t.shape == SHAPES[p]
        assert not t.any()


JAX_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import AxisType, make_mesh, set_mesh, shard_map
from repro.distributed import compression

z = np.load(sys.argv[1])
paths = sorted({k.split(":", 1)[1] for k in z.files})

def tree(prefix):
    out = {}
    for p in paths:
        node = out
        *parents, name = p.split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[name] = jnp.asarray(z[prefix + ":" + p])
    return out

mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Explicit,))

def body(g, e):
    g = jax.tree.map(lambda a: a[0], g)
    e = jax.tree.map(lambda a: a[0], e)
    agg, new_ef = compression.reduce_compressed(g, e, ("data",))
    return agg, jax.tree.map(lambda a: a[None], new_ef)

spec = lambda t, s: jax.tree.map(lambda _: s, t)
g0, e = tree("g0"), tree("ef")
fn = jax.jit(shard_map(body, mesh=mesh,
                       in_specs=(spec(g0, P("data")), spec(g0, P("data"))),
                       out_specs=(spec(g0, P()), spec(g0, P("data"))),
                       check_vma=False))
out = {}
with set_mesh(mesh):
    for step in ("g0", "g1"):
        agg, e = fn(tree(step), e)
        for p in paths:
            a, r = agg, e
            for k in p.split("/"):
                a, r = a[k], r[k]
            out[step + ":agg:" + p] = np.asarray(a)
            out[step + ":ef:" + p] = np.asarray(r)
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_reduce(tmp_path_factory):
    """Two steps' stacked gradients (one leaf all zero, its scale set by
    the residual alone), a first residual, and JAX's reduce of both steps
    with the residual carried, on a 4-device host mesh."""
    rng = np.random.default_rng(3)
    inp = {}
    for step in ("g0", "g1"):
        for p, s in SHAPES.items():
            a = (rng.standard_normal(s) * rng.uniform(0.01, 3.0, (N,) + (1,)
                                                      * (len(s) - 1)))
            inp[f"{step}:{p}"] = (0 * a if p == "blk/z" else a) \
                .astype(np.float32)
    for p, s in SHAPES.items():
        inp[f"ef:{p}"] = (rng.standard_normal(s) * 1e-2).astype(np.float32)
    d = tmp_path_factory.mktemp("compression")
    np.savez(d / "in.npz", **inp)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"
    return inp, dict(np.load(d / "out.npz"))


def test_reduce_compressed_bit_equal_to_jax_shard_map(jax_reduce):
    inp, want = jax_reduce
    ef = _tree({p: torch.from_numpy(inp[f"ef:{p}"]) for p in SHAPES})
    for step in ("g0", "g1"):
        g = _tree({p: torch.from_numpy(inp[f"{step}:{p}"]) for p in SHAPES})
        agg, ef = compression.reduce_compressed(g, ef)
        got_agg, got_ef = _flat(agg), _flat(ef)
        for p, s in SHAPES.items():
            assert got_agg[p].shape == s[1:] and got_ef[p].shape == s
            np.testing.assert_array_equal(got_agg[p],
                                          want[f"{step}:agg:{p}"])
            np.testing.assert_array_equal(got_ef[p], want[f"{step}:ef:{p}"])


def test_reduce_compressed_is_the_quantised_sum(jax_reduce):
    """The aggregate within half a quantisation step a silo of the true
    sum, and the residuals exactly what the quantisation left."""
    inp, _ = jax_reduce
    g = {p: torch.from_numpy(inp[f"g0:{p}"]) for p in SHAPES}
    ef = {p: torch.zeros(s) for p, s in SHAPES.items()}
    agg, new_ef = compression.reduce_compressed(_tree(g), _tree(ef))
    for p in SHAPES:
        scale = max(float(g[p].abs().max()), 1e-12) / 127.0
        got = _flat(agg)[p]
        np.testing.assert_allclose(got, g[p].sum(0).numpy(), rtol=0,
                                   atol=N * scale / 2 * (1 + 1e-5))
        np.testing.assert_allclose(got, (g[p] - torch.from_numpy(
            _flat(new_ef)[p])).sum(0).numpy(), rtol=0, atol=1e-5 * N * 127
            * scale)


def test_error_feedback_keeps_the_residual_bounded():
    """JAX's test on the port: 50 steps of 0.1-scaled normals, each
    quantised at its own scale with the residual carried; the cumulative
    dequantised sum stays within 0.05 of the cumulative gradient."""
    gen = torch.Generator().manual_seed(0)
    ef = torch.zeros(256)
    total_q = torch.zeros(256)
    total = torch.zeros(256)
    for _ in range(50):
        g = torch.randn(256, generator=gen) * 0.1
        scale = float((g + ef).abs().max()) / 127.0
        q, ef = compression.compress_leaf(g, ef, scale)
        total_q += q.float() * scale
        total += g
    assert float((total - total_q).abs().max()) < 0.05
