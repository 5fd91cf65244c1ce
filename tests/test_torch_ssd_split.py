"""The SSD scan kernel's summation order, on the CPU.

``ref.ssd_split_ref`` is the CUDA kernel's order in plain torch
(``csrc/ssd.cu``): the recurrence token by token, each state row's n dealt
to G threads in chunks of 4, y_t[p] the sum of the G partials in group
order. It is held to JAX's ``ssd_pallas`` in interpret mode (as the
JAX package's own CPU tests run it), to JAX's ``ssd_sequential`` and to the
port's plain versions on the same numpy inputs, within the JAX package's
bound for its kernel against the recurrence, 5e-5
(``tests/test_kernels.py:164-180``). The kernel stages 8 tokens a pass:
the lengths are S 1, a ragged 23 (past two whole passes), and 40 (five), at the smoke configs' width (P = N = 16) and zamba2-7b's (P = N =
64). The kernel is held to the split version on the card
(``tests/test_torch_cuda_kernels.py``), which also holds the built
library's groups to the wrapper's ``GROUPS``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2 import ref as jref
from repro.kernels.mamba2.mamba2 import ssd_pallas
from repro_torch.kernels.mamba2 import ref
from repro_torch.kernels.mamba2.mamba2 import GROUPS

SSD_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, nh, P, N, seed=0):
    """The JAX package's test distribution: x ~ 0.5 N(0, 1), dt a softplus
    of N(0, 1), log decay -0.5 |N(0, 1)|, B and C ~ 0.5 N(0, 1), an incoming
    state ~ 0.1 N(0, 1)."""
    g = np.random.default_rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)
    xh = n(B, S, nh, P) * 0.5
    dt = np.log1p(np.exp(n(B, S, nh))).astype(np.float32)
    la = (-np.abs(n(B, S, nh)) * 0.5).astype(np.float32)
    return xh, dt, la, n(B, S, N) * 0.5, n(B, S, N) * 0.5, \
        n(B, nh, P, N) * 0.1


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("S", [1, 23, 40])
@pytest.mark.parametrize("B,nh,P,N", [(2, 3, 16, 16), (1, 2, 64, 64)])
def test_split_ref_matches_pallas_and_the_plain_versions(B, nh, P, N, S):
    xs = _inputs(B, S, nh, P, N, seed=S)
    txs = [torch.as_tensor(x) for x in xs]
    y, h = ref.ssd_split_ref(*txs, GROUPS[(P, N)])
    assert y.shape == (B, S, nh, P) and h.shape == (B, nh, P, N)
    # ssd_pallas takes chunk = min(chunk, S): one chunk of S tokens here
    y_pal, h_pal = ssd_pallas(*map(jnp.asarray, xs), chunk=64,
                              interpret=True)
    y_seq, h_seq = jref.ssd_sequential(*map(jnp.asarray, xs))
    y_chk, h_chk = ref.ssd_chunked_ref(*txs)
    for got, want in ((y, y_pal), (h, h_pal), (y, y_seq), (h, h_seq),
                      (y, y_chk.numpy()), (h, h_chk.numpy())):
        _close(got, want)


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16])
def test_split_ref_any_grouping_is_the_recurrence(groups):
    """The grouping changes the order of the sum, never its value: every G
    with 4 G dividing N gives the sequential recurrence within fp32
    rounding."""
    txs = [torch.as_tensor(x) for x in _inputs(2, 19, 2, 16, 64, seed=9)]
    y, h = ref.ssd_split_ref(*txs, groups)
    y_seq, h_seq = ref.ssd_sequential(*txs)
    torch.testing.assert_close(y, y_seq, atol=1e-5, rtol=0)
    torch.testing.assert_close(h, h_seq, atol=1e-5, rtol=0)


def test_split_ref_refuses_a_grouping_that_does_not_divide_n():
    txs = [torch.as_tensor(x) for x in _inputs(1, 2, 1, 16, 16)]
    for groups in (0, 3, 8):
        with pytest.raises(ValueError, match="must divide N"):
            ref.ssd_split_ref(*txs, groups)
