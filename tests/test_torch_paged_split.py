"""The paged-attention kernel's split decomposition, on the CPU.

``ref.paged_attention_split_ref`` is the CUDA kernel's own algorithm in
plain torch: the slot's pages in contiguous runs, each run an online
softmax into a partial (m, l, acc), the pages wholly past the causal limit
not walked, the runs merged in ascending order. It is held to the plain
version (``ref.paged_attention_ref``) and to the JAX Pallas kernel in
interpret mode on the same numpy inputs; the CUDA kernel is held to it on
the card (``tests/test_torch_cuda_kernels.py``). ``plan`` is the wrapper's
choice of row tile and split count, checked here at the serving shapes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import \
    paged_attention_pallas
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    ROW_TILES, TILE_TOKENS, plan)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 on all sides; the split partials, the materialized softmax and the
# Pallas online softmax sum in different orders (measured max |diff| below
# 5e-7), so the bound is fp32 rounding with headroom
ATOL = RTOL = 1e-5

# slots, query heads, kv heads, head dim, pool pages, page size, pages a slot
B, HQ, HKV, D, N, P, NP = 4, 8, 2, 16, 40, 4, 7
S = NP * P


def _inputs(C, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, HQ, D)).astype(np.float32)
    kp = rng.standard_normal((N, P, HKV, D)).astype(np.float32)
    vp = rng.standard_normal((N, P, HKV, D)).astype(np.float32)
    tables = np.stack([rng.permutation(N)[:NP] for _ in range(B)]
                      ).astype(np.int32)
    # the smoke's q_starts: a fresh slot, one a third in, a full one, and
    # an inactive one (every row fully masked)
    q_start = np.array([0, S // 3, S - C, -1], np.int32)
    return q, kp, vp, tables, q_start


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# splits that leave runs of 7, 4+3, 3+3+1, 2+2+2+1 and 1 page; with 3 and
# 4, slot 0 (q_start 0) has splits with no visible page
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("C", [1, 4, 16])
def test_split_ref_matches_plain_and_pallas(C, splits):
    q, kp, vp, tables, qs = _inputs(C)
    got = ref.paged_attention_split_ref(*_torch(q, kp, vp, tables, qs),
                                        splits)
    assert got.dtype == torch.float32 and got.shape == (B, C, HQ, D)
    assert torch.isfinite(got).all()  # the inactive slot too
    plain = ref.paged_attention_ref(*_torch(q, kp, vp, tables, qs))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=RTOL)
    want = np.asarray(paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, qs)), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _attend_named(q, kp, vp, tables, qs):
    """Attention of each row over the named pages only (an id outside
    [0, N) names none): a masked softmax over the positions those pages
    hold, NEG_INF for the causal mask, as the kernel computes it."""
    C, G = q.shape[1], HQ // HKV
    out = np.empty_like(q)
    for b in range(B):
        js = [j for j in range(NP) if 0 <= tables[b, j] < N]
        k = np.concatenate([kp[tables[b, j]] for j in js])  # (n*P, HKV, D)
        v = np.concatenate([vp[tables[b, j]] for j in js])
        pos = np.concatenate([j * P + np.arange(P) for j in js])
        for c in range(C):
            for h in range(HQ):
                s = k[:, h // G] @ q[b, c, h] / math.sqrt(D)
                s = np.where(pos <= qs[b] + c, s, ref.NEG_INF)
                p = np.exp(s - s.max())
                out[b, c, h] = p @ v[:, h // G] / p.sum()
    return out


@pytest.mark.parametrize("C", [1, 4, 16])
def test_split_ref_skips_an_unnamed_page(C):
    """An out-of-range id is skipped, never read: in a page every row of
    slot 1 sees, in a page past slot 0's causal limit, and in the inactive
    slot, whose rows average over the named pages alone."""
    q, kp, vp, tables, qs = _inputs(C, seed=1)
    tables[1, 1] = N          # visible (q_start S/3 = 9 reaches page 2)
    tables[0, 6] = -5         # past slot 0's limit for every C here
    tables[3, 3] = N + 100    # the inactive slot
    want = _attend_named(q, kp, vp, tables, qs)
    for splits in (1, 3, 4):
        got = ref.paged_attention_split_ref(*_torch(q, kp, vp, tables, qs),
                                            splits)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_split_ref_equals_plain_without_the_skip():
    """Page 0 unnamed: no row is sure to see a named position, so every
    named page is walked (no causal skip) and the result is the masked
    softmax over the named pages."""
    q, kp, vp, tables, qs = _inputs(4, seed=2)
    tables[:, 0] = -1
    want = _attend_named(q, kp, vp, tables, qs)
    got = ref.paged_attention_split_ref(*_torch(q, kp, vp, tables, qs), 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("C,rows,splits", [
    (1, 8, 16),     # decode: 8 rows, 16 runs of 2 pages (one 32-token tile)
    (4, 32, 16),    # speculative verify (spec_k 4): 32 rows
    (16, 64, 16),   # prefill chunk: 128 rows in 2 tiles, 16 runs of 2 pages
])
def test_plan_at_the_serving_shapes(C, rows, splits):
    """qwen2.5-3b (16 query heads, 2 kv heads), 4 slots of 32 pages of 16
    tokens, on the H100's 132 SMs: runs of one 32-token tile, 128 blocks
    (decode, verify) and 256 (chunk) a call, against 8 for one block per
    (slot, kv head)."""
    assert plan(4, 2, 8 * C, 32, 16, 132) == (rows, splits)


@pytest.mark.parametrize("B_,Hkv,GC,nP,P_", [
    (1, 1, 1, 1, 16), (64, 8, 8, 4, 16), (3, 2, 200, 13, 4), (2, 4, 33, 9, 8),
    (4, 2, 8, 7, 4), (1, 1, 8, 40, 64), (2, 2, 16, 5, 3),
])
def test_plan_runs_cover_every_page_once(B_, Hkv, GC, nP, P_):
    """Every split walks at least one page, a whole tile of tokens where
    the slot holds one, and the runs tile [0, nP)."""
    rows, splits = plan(B_, Hkv, GC, nP, P_, 132)
    assert rows in ROW_TILES and (GC <= rows or rows == ROW_TILES[-1])
    assert 1 <= splits <= nP
    pps = -(-nP // splits)
    runs = [range(s * pps, min(nP, (s + 1) * pps)) for s in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [j for r in runs for j in r] == list(range(nP))
    assert splits == 1 or pps * P_ >= TILE_TOKENS
