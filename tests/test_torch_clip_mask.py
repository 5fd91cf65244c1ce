"""The plain version of the ``clip_mask`` kernel (one silo's barrier-tier
contribution) against the JAX package: its jnp oracle ``clip_mask_ref`` and
``clip_mask_pallas`` in interpret mode (as the JAX package's own CPU tests
run it), on the same numpy inputs.

The threefry bits are equal; libm's ``log`` is not bit-portable, and XLA
may fuse the Pallas body's multiply-adds, so each normal may differ by an
ulp or two of its value. The mask term ``b * (r_i - r_nxt)`` carries that
difference times ``b``: with ``|r| <= 5`` at these sizes, a few fp32 ulps
of ``b * 10`` bound it, held to ``ATOL_PER_B * b`` (``4 * 2**-23 * 10``,
about 4.8e-6 per unit of ``b``); measured max 1.1e-5 at ``b`` = 9.6
(4.6e-5 allowed).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_fused import ref as jref
from repro.kernels.dp_fused.dp_fused import clip_mask_pallas
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_fused import ops, ref

ATOL_PER_B = 4 * 2.0 ** -23 * 10
KR, KX, KP = ((3704974950, 1863054868), (2705940334, 2639757084),
              (4086990474, 1067026239))
B_SCALE = np.float32(9.6)  # mask_scale 8 * sigma 0.3 * C 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(P, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(P).astype(np.float32)


def _jax(fn, g, *, silo, n, scale, sigma_c, lam, use_pairwise, use_prev,
         **kw):
    args = (jnp.asarray(g), jnp.float32(scale), jnp.asarray(KR, jnp.uint32),
            jnp.asarray(KX, jnp.uint32), jnp.asarray(KP, jnp.uint32), silo, n,
            jnp.float32(sigma_c), jnp.float32(B_SCALE), jnp.float32(lam))
    return np.asarray(fn(*args, use_pairwise=use_pairwise, use_prev=use_prev,
                         **kw))


@pytest.mark.parametrize("use_pairwise,use_prev", [(True, True), (True, False),
                                                   (False, True),
                                                   (False, False)])
@pytest.mark.parametrize("overrides", [False, True])
def test_clip_mask_plain_matches_jax(use_pairwise, use_prev, overrides):
    """All four flag combinations, with the static-ring defaults and with
    the active-ring overrides (``nxt`` skipping a dropped silo, per-stream
    stds of the active counts)."""
    P, silo, n = 4096, 1, 4
    g = _inputs(P, seed=2 * use_pairwise + use_prev)
    kw = dict(silo=silo, n=n, scale=0.731, sigma_c=1.2, lam=0.7,
              use_pairwise=use_pairwise, use_prev=use_prev)
    over = dict(nxt=3, noise_scale=np.float32(1.2 / np.sqrt(3.0)),
                prev_noise_scale=np.float32(0.6)) if overrides else {}
    before = dispatch.launch_counts()
    got = ops.clip_mask(torch.from_numpy(g), kw["scale"], KR, KX, KP, silo, n,
                        kw["sigma_c"], B_SCALE, kw["lam"], use_pairwise,
                        use_prev, **over).numpy()
    assert dispatch.launch_counts() == before  # CPU: the plain version
    jover = {k: (v if k == "nxt" else jnp.float32(v)) for k, v in over.items()}
    for fn in (jref.clip_mask_ref,
               lambda *a, **k: clip_mask_pallas(*a, interpret=True, **k)):
        want = _jax(fn, g, **kw, **jover)
        np.testing.assert_allclose(got, want, atol=ATOL_PER_B * B_SCALE,
                                   rtol=0)
    # the terms are there: not the clipped gradient alone
    assert np.abs(got - g * np.float32(0.731)).max() > 0.1


def test_clip_mask_window_equals_the_whole():
    """``base`` offsets the counters: a window of a long buffer is the same
    slice of the whole buffer's contribution (how chip_smoke checks the
    kernel)."""
    g = torch.from_numpy(_inputs(6144, seed=7))
    args = (0.5, KR, KX, KP, 2, 4, 1.2, 9.6, 0.7)
    whole = ref.clip_mask_ref(g, *args, nxt=0)
    part = ref.clip_mask_ref(g[1000:5000], *args, nxt=0, base=1000)
    assert torch.equal(part, whole[1000:5000])


def test_clip_mask_writes_in_place():
    g = torch.from_numpy(_inputs(2048, seed=8))
    want = ops.clip_mask(g, 0.5, KR, KX, KP, 0, 4, 1.2, 9.6, 0.7)
    out = ops.clip_mask(g, 0.5, KR, KX, KP, 0, 4, 1.2, 9.6, 0.7, out=g)
    assert out is g and torch.equal(g, want)


def test_external_streams_raise():
    g = torch.zeros(1024)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 8"):
        ops.clip_mask(g, 1.0, KR, KX, KP, 0, 4, 1.2, 9.6, 0.7, xi=g)
    with pytest.raises(NotImplementedError, match="item 8"):
        ref.clip_mask_ref(g, 1.0, KR, KX, KP, 0, 4, 1.2, 9.6, 0.7, xp=g)
