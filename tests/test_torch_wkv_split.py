"""The WKV scan kernel's summation order, on the CPU.

``ref.wkv_split_ref`` is the CUDA kernel's order in plain torch
(``csrc/wkv.cu``): the recurrence token by token, each state column split
into G runs of N / G consecutive n, o_t[j] the sum of the runs' partials in
run order, the state read before it is updated. It is held to JAX's
``wkv_pallas`` in interpret mode (as the JAX package's own CPU tests run
it), to JAX's ``wkv_sequential`` and to the port's plain versions on the
same numpy inputs, within the JAX package's bounds for its kernel against
the recurrence (``tests/test_kernels.py:66-96``): 2e-5, and 1e-4 under
strong decay (w = 0.05). The kernel stages 16 tokens a pass: the lengths
are S 1, a ragged 23, and 40 (two whole passes and a ragged third), at
every head size the kernel is instantiated for (16, 32, 64; rwkv6-7b's is
64). The kernel is held to the split version on the card
(``tests/test_torch_cuda_kernels.py``), which also holds the built
library's groups to the wrapper's ``GROUPS``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ref as jref
from repro.kernels.rwkv6.rwkv6 import wkv_pallas
from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.rwkv6 import GROUPS, HEAD_SIZES

WKV_ATOL = 2e-5
STRONG_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, N, seed=0, w=None):
    """The JAX package's test distribution: r, k, v ~ 0.5 N(0, 1), decay in
    (0.45, 0.95), u ~ 0.3 N(0, 1), an incoming state ~ 0.1 N(0, 1)."""
    g = np.random.default_rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)
    r, k, v = n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5
    if w is None:
        w = (1 / (1 + np.exp(-n(B, S, H, N)))) * 0.5 + 0.45
    else:
        w = np.full((B, S, H, N), w, np.float32)
    return r, k, v, w.astype(np.float32), n(H, N) * 0.3, n(B, H, N, N) * 0.1


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _against_all(xs, groups, atol):
    """The split version against wkv_pallas (one chunk of S tokens: the
    Pallas kernel needs S % chunk == 0), JAX's recurrence and the port's
    plain versions."""
    txs = [torch.as_tensor(x) for x in xs]
    o, st = ref.wkv_split_ref(*txs, groups)
    B, S, H, N = xs[0].shape
    assert o.shape == (B, S, H, N) and st.shape == (B, H, N, N)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    o_pal, s_pal = wkv_pallas(*map(jnp.asarray, xs), chunk=S, interpret=True)
    o_seq, s_seq = jref.wkv_sequential(*map(jnp.asarray, xs))
    o_chk, s_chk = ref.wkv_chunked_ref(*txs)
    for got, want in ((o, o_pal), (st, s_pal), (o, o_seq), (st, s_seq),
                      (o, o_chk.numpy()), (st, s_chk.numpy())):
        _close(got, want, atol)


@pytest.mark.parametrize("S", [1, 23, 40])
@pytest.mark.parametrize("N", HEAD_SIZES)
def test_split_ref_matches_pallas_and_the_plain_versions(N, S):
    _against_all(_inputs(2, S, 2, N, seed=S), GROUPS[N], WKV_ATOL)


def test_split_ref_under_strong_decay():
    """w = 0.05 (log-decay -3.0 a step) at rwkv6-7b's head size, past two
    passes: finite and within the JAX package's strong-decay bound."""
    _against_all(_inputs(1, 40, 2, 64, seed=7, w=0.05), GROUPS[64],
                 STRONG_ATOL)


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_split_ref_any_grouping_is_the_recurrence(groups):
    """The grouping changes the order of the sum, never its value: every G
    that divides N gives the sequential recurrence within fp32 rounding."""
    txs = [torch.as_tensor(x) for x in _inputs(2, 19, 2, 16, seed=9)]
    o, st = ref.wkv_split_ref(*txs, groups)
    o_seq, s_seq = ref.wkv_sequential(*txs)
    torch.testing.assert_close(o, o_seq, atol=1e-5, rtol=0)
    torch.testing.assert_close(st, s_seq, atol=1e-5, rtol=0)


def test_split_ref_refuses_a_grouping_that_does_not_divide_n():
    txs = [torch.as_tensor(x) for x in _inputs(1, 2, 1, 16)]
    for groups in (0, 3):
        with pytest.raises(ValueError, match="must divide N"):
            ref.wkv_split_ref(*txs, groups)
