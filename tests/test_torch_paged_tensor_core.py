"""The bf16 paged-attention kernel's tensor-core design, on the CPU.

``ref.paged_attention_split_model`` is the arithmetic of
``paged_attention_tc_kernel`` (``csrc/paged_attention.cu``) in plain torch:
each slot's walk cut into chunks of 128 tokens, a chunk wholly past the walk
an empty partial, each warp's 32 tokens an online softmax over two tiles of
16 keys with p entering ``P V`` as three bf16 terms (``split3_bf16``: hi +
mid + lo == p), the block's warps merged in order and the chunks in
ascending order. It is held to the JAX Pallas
kernel in interpret mode (``paged_attention_pallas`` on bf16 q and pools,
fp32 out) and to the plain version (``ref.paged_attention_ref``) on the same
numpy inputs rounded to bf16; the CUDA kernel is held to it on the card
(``tests/test_torch_cuda_kernels.py``). ``plan_tc`` is the wrapper's choice
of row tile and chunk count.

Gates: the fp32 bound of ``tests/test_torch_bf16_serving.py`` (``PAGED_ATOL``
/ ``PAGED_RTOL``, 1e-5 each), none loosened. The inputs are bf16 values, so
their products are exact in fp32 on every side, and p enters whole; what
differs is the order of the sums (measured here: at most 4.8e-7 from the
plain version and from JAX's kernel). Two terms, as the flash pair splits
p, would leave up to 2^-16 of each p (``test_split3_is_exact``), which on a
row with a few visible keys moves the output by that share of its V values:
the size of the gate.

The cases: G 1 at d_head 80 and 96 (stablelm-3b's and phi3-mini-3.8b's head
dims, two heads), G 2, 4 and 16 (qwen3-moe's group), C 1, 4 and 16; the
smoke's q_starts {0, S/3, S - C, -1} (an inactive slot, and slots whose walk
ends inside the first of two or three chunks), ragged page sizes (5, 12)
whose tiles straddle pages, an unnamed page and an unnamed page 0.
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
    TC_ROW_TILES, TC_THREADS, plan_tc)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_torch_bf16_serving.py's paged gate: fp32 out on every side
PAGED_ATOL = PAGED_RTOL = 1e-5
BF16 = torch.bfloat16


def _inputs(B, C, Hq, Hkv, D, P, nP, seed=0, q_start=None):
    """bf16 q and pools (as fp32 numpy arrays holding bf16 values), a pool
    of B*nP pages each slot names nP of, and the smoke's q_starts."""
    rng = np.random.default_rng(seed)
    N = B * nP
    S = nP * P

    def bf16(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(BF16).float().numpy()

    q = bf16((B, C, Hq, D))
    kp, vp = bf16((N, P, Hkv, D)), bf16((N, P, Hkv, D))
    tables = np.stack([rng.permutation(N)[:nP] for _ in range(B)]
                      ).astype(np.int32)
    if q_start is None:
        q_start = [0, S // 3, S - C, -1][:B]
    return q, kp, vp, tables, np.asarray(q_start, np.int32)


def _torch(q, kp, vp, tables, qs):
    return ([torch.from_numpy(a).to(BF16) for a in (q, kp, vp)]
            + [torch.from_numpy(tables), torch.from_numpy(qs)])


def _pallas(q, kp, vp, tables, qs):
    out = paged_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(qs), interpret=True)
    assert out.dtype == jnp.float32
    return np.asarray(out)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=PAGED_ATOL, rtol=PAGED_RTOL)


# B, C, Hq, Hkv, D, P, nP: S = nP * P over two or three 128-token chunks
CASES = [
    (4, 1, 2, 2, 80, 16, 16),     # G 1 decode, stablelm-3b's d_head
    (4, 4, 2, 2, 80, 16, 16),     # G 1 verify (spec_k 4)
    (4, 16, 2, 2, 80, 16, 16),    # G 1 chunk: 16 rows, ordinary tiles
    (4, 1, 2, 2, 96, 16, 16),     # phi3-mini-3.8b's d_head
    (4, 4, 2, 2, 96, 16, 16),
    (4, 16, 2, 2, 96, 16, 16),
    (4, 1, 4, 2, 32, 16, 16),     # G 2
    (4, 4, 4, 2, 32, 16, 16),     # G 2 verify: 8 rows, transposed
    (4, 1, 8, 2, 16, 12, 24),     # G 4 (phi3.5-moe), ragged pages of 12
    (4, 4, 8, 2, 16, 12, 24),     # 16 rows
    (4, 16, 8, 2, 16, 5, 60),     # 64 rows in 4 tiles; pages of 5
    (3, 1, 16, 1, 16, 16, 20),    # G 16 (qwen3-moe): 16 rows
    (3, 4, 16, 1, 16, 16, 20),    # 64 rows
    (3, 16, 16, 1, 16, 16, 20),   # 256 rows in 16 tiles
]


@pytest.mark.parametrize("B,C,Hq,Hkv,D,P,nP", CASES)
def test_split_model_matches_pallas_and_plain(B, C, Hq, Hkv, D, P, nP):
    arrays = _inputs(B, C, Hq, Hkv, D, P, nP)
    args = _torch(*arrays)
    got = ref.paged_attention_split_model(*args)
    assert got.dtype == torch.float32 and got.shape == (B, C, Hq, D)
    assert torch.isfinite(got).all()  # the inactive slot too
    _close(got.numpy(), _pallas(*arrays))
    _close(got.numpy(), ref.paged_attention_ref(*args).numpy())


def test_split_model_one_chunk_and_a_walk_past_the_first():
    """nP * P within one chunk (the block writes the output itself), and
    q_starts whose walks end in the first, second and third chunk of 300
    tokens."""
    for P, nP, q_start in ((8, 9, [0, 30, 71]), (12, 25, [100, 140, 299])):
        arrays = _inputs(3, 1, 8, 2, 32, P, nP, seed=P, q_start=q_start)
        args = _torch(*arrays)
        got = ref.paged_attention_split_model(*args)
        _close(got.numpy(), _pallas(*arrays))
        _close(got.numpy(), ref.paged_attention_ref(*args).numpy())


def _attend_named(q, kp, vp, tables, qs):
    """Attention of each row over the named pages only (an id outside
    [0, N) names none), as the kernel computes it, in float64."""
    B, C, Hq, D = q.shape
    N, P, Hkv, _ = kp.shape
    nP, G = tables.shape[1], Hq // Hkv
    out = np.empty(q.shape, np.float64)
    for b in range(B):
        js = [j for j in range(nP) if 0 <= tables[b, j] < N]
        k = np.concatenate([kp[tables[b, j]] for j in js]).astype(np.float64)
        v = np.concatenate([vp[tables[b, j]] for j in js]).astype(np.float64)
        pos = np.concatenate([j * P + np.arange(P) for j in js])
        for c in range(C):
            for h in range(Hq):
                s = k[:, h // G] @ q[b, c, h] / math.sqrt(D)
                s = np.where(pos <= qs[b] + c, s, ref.NEG_INF)
                p = np.exp(s - s.max())
                out[b, c, h] = p @ v[:, h // G] / p.sum()
    return out


@pytest.mark.parametrize("C", [1, 4, 16])
def test_split_model_skips_an_unnamed_page(C):
    """An out-of-range id is skipped, never read: in a page slot 1 sees, in
    a page past slot 0's walk and in the inactive slot, whose rows average
    over the named pages alone. The fp32 kernel's split algorithm skips
    them alike."""
    arrays = _inputs(4, C, 4, 2, 32, 8, 20, seed=1)
    q, kp, vp, tables, qs = arrays
    N = kp.shape[0]
    tables[1, 2] = N          # visible: slot 1 walks to S/3 = 53
    tables[0, 17] = -5        # past slot 0's walk
    tables[3, 3] = N + 100    # the inactive slot walks every named page
    args = _torch(*arrays)
    got = ref.paged_attention_split_model(*args)
    assert torch.isfinite(got).all()
    _close(got.numpy(), _attend_named(*arrays))
    _close(got.numpy(), ref.paged_attention_split_ref(*args, 3).numpy())


def test_split_model_walks_everything_without_page_zero():
    """Page 0 unnamed: no row is sure to see a named position, so every
    named position is walked, past q_start too, and a row that sees no
    named key is the uniform average over the named pages."""
    arrays = _inputs(4, 4, 2, 2, 80, 16, 16, seed=2)
    arrays[3][:, 0] = -1
    args = _torch(*arrays)
    got = ref.paged_attention_split_model(*args)
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), _attend_named(*arrays))


def test_split3_is_exact():
    """hi + mid + lo == x for every significand of one binade (x - hi keeps
    at most 16 of x's 24 bits, x - hi - mid at most 8, which bf16 holds),
    and for values of both signs from 2^-100 to 2^100 (below about 2^-110
    lo leaves bf16's normal range; a p that small adds nothing); two terms
    leave up to 2^-16 of x."""
    one = torch.arange(1 << 23, dtype=torch.int32) | (127 << 23)
    x = one.view(torch.float32)                      # [1, 2), every value
    rng = np.random.default_rng(4)
    wide = torch.from_numpy((rng.standard_normal(1 << 16) * np.exp2(
        rng.integers(-100, 100, 1 << 16))).astype(np.float32))
    wide = wide[wide.abs() >= 2.0 ** -100]
    for v in (x, wide, -x):
        hi, mid, lo = ref.split3_bf16(v)
        for t in (hi, mid, lo):
            assert torch.equal(t, t.to(BF16).float())
        assert torch.equal(hi + mid + lo, v)
    hi, mid, _ = ref.split3_bf16(x)
    two = (x - hi - mid.to(BF16).float()).abs() / x
    assert 0 < float(two.max()) <= 2.0 ** -16


def test_walk_end():
    """The walk stops after the last row's limit only where every row sees
    position 0 (q_start >= 0 and page 0 named); otherwise it spans S."""
    assert ref.paged_walk_end(0, 3, 1, 8, 512) == 1
    assert ref.paged_walk_end(170, 3, 4, 8, 512) == 174
    assert ref.paged_walk_end(511, 3, 1, 8, 512) == 512
    assert ref.paged_walk_end(508, 3, 16, 8, 512) == 512  # clipped to S
    assert ref.paged_walk_end(-1, 3, 1, 8, 512) == 512    # inactive
    assert ref.paged_walk_end(5, 8, 1, 8, 512) == 512     # page 0 unnamed
    assert ref.paged_walk_end(5, -1, 1, 8, 512) == 512


@pytest.mark.parametrize("GC,nP,P,rows,chunks", [
    (1, 32, 16, 8, 4),      # Hkv 32 decode: transposed, 4 chunks of 128
    (4, 32, 16, 8, 4),      # Hkv 32 verify
    (16, 32, 16, 16, 4),    # Hkv 32 chunk, qwen3-moe decode
    (8, 32, 16, 8, 4),      # qwen2.5-3b decode: 8 rows, transposed
    (32, 32, 16, 16, 4),    # qwen2.5-3b verify: 2 tiles of 16
    (128, 32, 16, 16, 4),   # qwen2.5-3b chunk: 8 tiles
    (9, 9, 8, 16, 1),       # one chunk: the block writes the output
    (3, 25, 12, 8, 3),      # 300 tokens: a ragged last chunk
])
def test_plan_tc(GC, nP, P, rows, chunks):
    """The row tile (8: the scores transposed, up to 8 folded rows; else
    16) and ceil(nP * P / 128) chunks, from shapes alone."""
    assert plan_tc(GC, nP, P) == (rows, chunks)
    assert rows in TC_ROW_TILES
    assert chunks * ref.TC_CHUNK_TOKENS >= nP * P > (chunks - 1) * \
        ref.TC_CHUNK_TOKENS
    # a block is 4 warps, each walking its share of the chunk
    assert TC_THREADS // 32 * ref.TC_WARP_TOKENS == ref.TC_CHUNK_TOKENS
    assert ref.TC_WARP_TOKENS % ref.TC_TILE_KEYS == 0
