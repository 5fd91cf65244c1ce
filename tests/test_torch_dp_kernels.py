"""The plain versions of the two DP kernels against the JAX package: the
Pallas kernels in interpret mode (as the JAX package's own CPU tests run
them) and their jnp oracles, on the same numpy inputs.

``clip_accumulate``: fp32 sums of the same products in another order
(measured max 7.2e-7 on sums of up to 8 unit normals); held to 2e-6.
``noise_batch``: the threefry bits are equal and the fold is the same, but
libm's ``log`` is not bit-portable (and XLA may fuse the Pallas body's
multiply-adds): measured max 4.8e-7 on values up to 3.6; held to 3e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_clip import ref as jclip_ref
from repro.kernels.dp_clip.dp_clip import clip_accumulate as jclip_pallas
from repro.kernels.dp_fused import ref as jnoise_ref
from repro.kernels.dp_fused.dp_fused import noise_batch_pallas
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_clip import ops as clip_ops
from repro_torch.kernels.dp_fused import ops as noise_ops


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLIP_ATOL = 2e-6
NOISE_ATOL = 3e-6
KX, KP = (2705940334, 2639757084), (4086990474, 1067026239)


@pytest.mark.parametrize("n,P", [(4, 4096), (5, 1536), (8, 2048)])
def test_clip_accumulate_plain_matches_jax(n, P):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, P)).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[1] = 0.0  # a dropped silo
    before = dispatch.launch_counts()
    got = clip_ops.clip_accumulate(torch.from_numpy(g), torch.from_numpy(s))
    assert dispatch.launch_counts() == before  # CPU: the plain version
    for want in (jclip_pallas(jnp.asarray(g), jnp.asarray(s), interpret=True),
                 jclip_ref.clip_accumulate_ref(jnp.asarray(g), jnp.asarray(s))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=CLIP_ATOL, rtol=0)


@pytest.mark.parametrize("n,use_prev", [(1, True), (4, True), (4, False),
                                        (5, True)])
def test_noise_batch_plain_matches_jax(n, use_prev):
    rng = np.random.default_rng(10 + n)
    P = 2048
    g = rng.standard_normal(P).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, n).astype(np.float32)
    lams = np.full(n, 0.7, np.float32)
    if n > 1:
        scales[1] = lams[1] = 0.0   # a silo gated off
    lams[-1] = 0.0                  # a lambda gate of 0
    s_prev = np.float32(0.15)
    got = noise_ops.noise_batch(torch.from_numpy(g), KX, KP,
                                torch.from_numpy(scales),
                                torch.from_numpy(lams), s_prev, use_prev)
    args = (jnp.asarray(g), jnp.asarray(KX, jnp.uint32),
            jnp.asarray(KP, jnp.uint32), jnp.asarray(scales),
            jnp.asarray(lams), s_prev)
    for want in (noise_batch_pallas(*args, use_prev=use_prev, interpret=True),
                 jnoise_ref.noise_batch_ref(*args, use_prev=use_prev)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=NOISE_ATOL, rtol=0)
    assert not torch.equal(got, torch.from_numpy(g))


def test_noise_batch_window_equals_the_whole():
    """``base`` offsets the counters: a window of a long buffer is the same
    slice of the whole buffer's noise (how chip_smoke checks the kernel)."""
    from repro_torch.kernels.dp_fused import ref
    g = torch.randn(4096)
    s = torch.tensor([0.1, 0.2, 0.3])
    lam = torch.tensor([0.7, 0.0, 0.7])
    whole = ref.noise_batch_ref(g, KX, KP, s, lam, 0.2)
    part = ref.noise_batch_ref(g[1000:3000], KX, KP, s, lam, 0.2, base=1000)
    assert torch.equal(part, whole[1000:3000])
