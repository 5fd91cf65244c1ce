"""Per-example clipping: the plain versions of the ``per_example_sumsq`` and
``clip_sum`` kernels, the tree-level ``clip_and_sum_tree`` (packed and
perleaf), ``per_example_clipped_grad`` and ``silo_grad`` against the JAX
package on the same numpy inputs and weights.

``sumsq`` is held to JAX's ``per_example_sumsq`` in interpret mode and to
its oracle; ``clip_sum`` to ``dp_fused/ref.clip_sum_ref`` (JAX's Pallas
``clip_sum_pallas`` does not run on this jax: ``ROADMAP.md`` queue 3).

Tolerances, each with what was measured on this CPU:
* sums of squares and norms: fp32 sums in another order, held to
  ``RTOL`` = 1e-6 relative (measured 1.2e-7 on (4, 8192), 3.6e-7 on the
  smoke model's per-example norms);
* clipped sums: the clip factors move with the norms, and the sum over
  examples is a fold against XLA's reduction: ``clip_sum`` on rows of
  norms 0.9 to 903 held to ``SUM_RTOL`` = 1e-6 of the largest value
  (measured 1.6e-7); the smoke model's sums to ``ATOL`` = 1e-6 absolute
  on values up to 0.11 (measured 8.2e-8);
* losses: 1e-5 relative (measured 1.6e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import barrier as jbarrier
from repro.core import clipping as jclip
from repro.core import flatbuf as jflat
from repro.kernels.dp_clip import ops as jclip_ops
from repro.kernels.dp_clip import ref as jclip_ref
from repro.kernels.dp_clip.dp_clip import per_example_sumsq
from repro.kernels.dp_fused import ref as jfused_ref
from repro_torch.api import Session
from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import barrier, clipping, flatbuf
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_clip import ops as clip_ops
from repro_torch.kernels.dp_clip import ref as clip_ref
from repro_torch.kernels.dp_fused import ops as fused_ops
from repro_torch.kernels.dp_fused import ref as fused_ref
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy

RTOL = 1e-6
ATOL = 1e-6
SUM_RTOL = 1e-6
LOSS_RTOL = 1e-5
ARCH = "qwen2.5-3b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(B, D, seed):
    """(B, D) rows with norms spread over three decades."""
    g = np.random.default_rng(seed).standard_normal((B, D)).astype(np.float32)
    return g * np.logspace(-2, 1, B, dtype=np.float32)[:, None]


def test_sumsq_plain_matches_jax():
    g = _rows(4, 8192, seed=0)
    before = dispatch.launch_counts()
    got = clip_ops.sumsq(torch.from_numpy(g)).numpy()
    assert dispatch.launch_counts() == before  # CPU: the plain version
    for want in (per_example_sumsq(jnp.asarray(g), interpret=True),
                 jclip_ref.per_example_sumsq_ref(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)


def test_sumsq_reads_columns_of_a_wider_buffer():
    """One leaf's columns of the (B, P) buffer, rows P apart, in place."""
    g = torch.from_numpy(_rows(3, 1000, seed=1))
    cols = g[:, 200:700]
    assert not cols.is_contiguous()
    torch.testing.assert_close(clip_ops.sumsq(cols),
                               (cols.double() ** 2).sum(1).float(),
                               rtol=RTOL, atol=0)
    torch.testing.assert_close(clip_ops.clipped_sum(cols, torch.ones(3)),
                               cols.sum(0), rtol=0, atol=1e-5)


@pytest.mark.parametrize("clip_bound", [0.5, 50.0, 1e4])
def test_clip_sum_plain_matches_jax_ref(clip_bound):
    """Rows clipped (C below their norms), some (C between) and none."""
    g = _rows(4, 8192, seed=2)
    got_sum, got_norms = fused_ops.clip_sum_packed(torch.from_numpy(g),
                                                   clip_bound)
    want_sum, want_norms = jfused_ref.clip_sum_ref(jnp.asarray(g), clip_bound)
    np.testing.assert_allclose(got_norms.numpy(), np.asarray(want_norms),
                               rtol=RTOL)
    want_sum = np.asarray(want_sum)
    np.testing.assert_allclose(got_sum.numpy(), want_sum,
                               atol=SUM_RTOL * np.abs(want_sum).max(), rtol=0)


def _grad_trees(B, seed):
    """Per-example grads shaped like a small model's (a stacked leaf among
    them), as (JAX tree, port tree)."""
    rng = np.random.default_rng(seed)
    leaves = {"a": rng.standard_normal((B, 37)), "b": rng.standard_normal(
        (B, 3, 50)), "c.d": rng.standard_normal((B, 129)),
        "e": rng.standard_normal((B, 2, 2, 64))}
    leaves = {k: (v * np.logspace(-1, 1, B)[(slice(None),) + (None,) *
                                             (v.ndim - 1)]).astype(np.float32)
              for k, v in leaves.items()}
    jtree = {"a": leaves["a"], "b": leaves["b"], "c": {"d": leaves["c.d"]},
             "e": leaves["e"]}
    ttree = {k: ([torch.from_numpy(np.ascontiguousarray(v[:, l]))
                  for l in range(v.shape[1])] if k == "e"
                 else torch.from_numpy(v)) for k, v in leaves.items()}
    return jax.tree.map(jnp.asarray, jtree), ttree


@pytest.mark.parametrize("impl", ["packed", "perleaf"])
def test_clip_and_sum_tree_matches_jax(impl):
    jtree, ttree = _grad_trees(4, seed=3)
    jsum, jnorms = jclip_ops.clip_and_sum_tree(jtree, 2.0, impl=impl)
    dispatch.reset_launches()
    tsum, tnorms = clip_ops.clip_and_sum_tree(ttree, 2.0, impl=impl)
    assert sum(dispatch.launch_counts().values()) == 0
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms), rtol=RTOL)
    tl = flatbuf.layout_of(tsum)
    np.testing.assert_allclose(flatbuf.pack(tl, tsum).numpy(),
                               np.asarray(jflat.pack(jflat.layout_of(jsum),
                                                     jsum)), atol=ATOL, rtol=0)
    assert len(tsum["e"]) == 2  # the stacked leaf comes back as its layers


def test_packed_and_perleaf_routes_agree():
    """The (B, P) buffer of the same per-example grads through both routes
    (``pack_rows`` is JAX's ``layout_of(tree, batch_dims=1)`` packing)."""
    jtree, ttree = _grad_trees(5, seed=4)
    layout = flatbuf.layout_of({k: [t[0] for t in v] if isinstance(v, list)
                                else v[0] for k, v in ttree.items()})
    buf = flatbuf.pack_rows(layout, ttree)
    jl = jflat.layout_of(jtree, batch_dims=1)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jflat.pack(jl,
                                                                     jtree)))
    a, na = clip_ops.clip_and_sum_tree(buf, 1.5, "packed", layout=layout)
    b, nb = clip_ops.clip_and_sum_tree(buf, 1.5, "perleaf", layout=layout)
    torch.testing.assert_close(na, nb, rtol=RTOL, atol=0)
    torch.testing.assert_close(flatbuf.pack(layout, a),
                               flatbuf.pack(layout, b), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def smoke():
    """The qwen2.5-3b smoke model's weights in both packages and a batch of
    4 examples of 16 tokens."""
    js = JaxSession.from_config(ARCH, privacy=JaxPrivacy(enabled=True))
    ts = Session.from_config(ARCH, device="cpu",
                             privacy=PrivacyConfig(enabled=True))
    weights = params_to_numpy(transformer.init(
        torch.Generator().manual_seed(0), ts.cfg, "cpu"))
    batch = js.synthetic_batches(4, 16)()
    tbatch = {k: torch.as_tensor(np.array(v), dtype=torch.long)
              for k, v in batch.items()}
    return (js, jax.tree.map(jnp.asarray, weights), batch, ts,
            params_from_jax(weights, ts.cfg, "cpu"), tbatch)


def _packed_jax(tree, jparams):
    return np.asarray(jflat.pack(jflat.layout_of(jparams), tree))


def _packed(tree):
    return flatbuf.pack(flatbuf.layout_of(tree), tree).numpy()


@pytest.mark.parametrize("impl", ["packed", "perleaf"])
def test_per_example_clipped_grad_matches_jax(smoke, impl):
    js, jparams, batch, ts, tparams, tbatch = smoke
    jsum, jnorms, jloss = jax.jit(lambda p, b: jclip.per_example_clipped_grad(
        js.model.loss, p, b, 1.0, impl=impl))(jparams, batch)
    tsum, tnorms, tloss = clipping.per_example_clipped_grad(
        ts.model.loss, tparams, tbatch, 1.0, impl=impl)
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms), rtol=RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_packed(tsum), _packed_jax(jsum, jparams),
                               atol=ATOL, rtol=0)
    assert float(tnorms.min()) > 1.0  # every example clipped at C = 1
    # the weights are left as they were found
    assert not any(p.requires_grad for p in tparams.parameters())


@pytest.mark.parametrize("mode,enabled", [("per_example", True),
                                          ("per_microbatch", True),
                                          ("per_silo", True),
                                          ("per_silo", False)])
def test_silo_grad_matches_jax(smoke, mode, enabled):
    js, jparams, batch, ts, tparams, tbatch = smoke
    jpriv = JaxPrivacy(enabled=enabled, clip_mode=mode)
    jg, jn, jloss = jax.jit(lambda p, b: jbarrier.silo_grad(
        js.model.loss, p, b, jpriv, 0.5))(jparams, batch)
    tg, tn, tloss = barrier.silo_grad(
        ts.model.loss, tparams, tbatch,
        PrivacyConfig(enabled=enabled, clip_mode=mode), 0.5)
    assert tn.shape == np.asarray(jn).shape
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_packed(tg), _packed_jax(jg, jparams),
                               atol=ATOL, rtol=0)
