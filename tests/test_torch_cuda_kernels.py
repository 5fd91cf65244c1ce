"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports only torch and the port, so it runs on the GPU machine as
it is (``python -m pytest -q tests/test_torch_cuda_kernels.py``); without a
CUDA device every test skips. ``chip_smoke.py`` repeats the full-width
checks on every run; these add the edges: more head dims, row tiles past
one block, isolation against poisoned pages, rollback ranges past the row
and with scalar stores, the page pools' batched zeroing (one and two pools,
pages and tokens, past one launch's index capacity, indices outside the
pool, one launch an event from ``PagePool``), argument checks, the DP
kernels' bit-equality with their plain versions (``clip_mask`` in every
flag combination and in place, ``zsmask`` at counter offsets past 2**31 and
wrapping; 64-bit offsets past 2**31 elements), the per-example kernels
(``per_example_sumsq`` and ``clip_sum``: within their stated tolerance of
the plain versions, bit-identical across launches, the clipped sum
bit-equal to the plain fold at the kernel's norms), the two scans (``wkv``
and ``ssd`` at every instantiated width, S 1, ragged lengths past two
staged passes, S 512, strong decay; each against its split algorithm and
its launch configuration's groups against the wrapper's and one wave at
the main shapes; misaligned data refused) and
flash attention at d_head 112, and the smoke-size serving slice (plain and
speculative; the ssm and hybrid families), the fused and barrier training
slices (packed and perleaf: the perleaf mask one ``zsmask_buffer`` launch
a silo, its lambda-corrected instantiation, the per-leaf clip route
``per_example_sumsq_tree`` and ``clip_accumulate`` once each) and
per-example clipping on the card
against the CPU, and the wire tier's rounds (``clip_mask`` once per active silo per
round, pipelined == serial on the card, card against CPU; the speculative
rounds' ``noise_stream`` and external-stream ``clip_mask`` bit-equal to
their plain versions and to ``clip_mask``'s in-kernel draw, speculative and
fault-free tolerant rounds == serial on the card), and the scans'
backward (``wkv_bwd`` and ``ssd_bwd`` against their plain reverse scans at
the training shapes, ragged lengths, S 1 and strong decay, and across their
16-token passes at every width, bit-identical across launches, no state
cotangent bit-equal to a zero one; their launch configurations and
checkpoint scratch; the ``autograd.Function`` of each scan launching both
kernels; the smoke ssm and hybrid training, fused and barrier, on the card
against the CPU), and the per-leaf normal draw (``normal`` and
``normal_combine`` bit-equal to their plain versions at ragged sizes and at
counters past 2**32, ``corrected_noise`` one launch a leaf tensor and within NOISY_ATOL of the
CPU, whose ``log1p`` is libm's), and bf16 serving (flash attention's bf16
instantiation on the tensor cores within one bf16 ulp of its plain version
and within the gate of its split model, bit-equal across launches, paged
attention on bf16 q and pools
on the tensor cores within the fp32 tolerance of its plain version and of
its split model, bit-equal across launches, the page pools' zeroing on
bf16 pools bit for bit, dtype mixes refused, the smoke config served in
bf16 in every mode on the bf16 instantiations only, card against CPU).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import Session
from repro_torch.configs.base import MeshConfig, OptimizerConfig, PrivacyConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.dp_clip import ops as clip_ops
from repro_torch.kernels.dp_clip import ref as clip_ref
from repro_torch.kernels.dp_fused import ops as noise_ops
from repro_torch.kernels.dp_fused import ref as noise_ref
from repro_torch.kernels.dp_fused.dp_fused import (clip_mask_cuda,
                                                   clip_mask_ext_cuda,
                                                   clip_sum_cuda,
                                                   stream_config)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2 import ref as ssd_ref
from repro_torch.kernels.mamba2.mamba2 import SHAPES as SSD_SHAPES
from repro_torch.kernels.mamba2.mamba2 import GROUPS as SSD_GROUPS
from repro_torch.kernels.mamba2.mamba2 import kernel_config as ssd_config
from repro_torch.kernels.mamba2.mamba2 import bwd_config as ssd_bwd_config
from repro_torch.kernels.mamba2.mamba2 import \
    bwd_scratch_floats as ssd_bwd_scratch
from repro_torch.kernels.mamba2.mamba2 import ssd_bwd_cuda, ssd_cuda
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.kernels.paged_attention.paged_attention import \
    pool_zero_cuda
from repro_torch.kernels.paged_attention.paged_attention import \
    plan as paged_plan
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.kernels.rwkv6.rwkv6 import HEAD_SIZES as WKV_HEAD_SIZES
from repro_torch.kernels.rwkv6.rwkv6 import GROUPS as WKV_GROUPS
from repro_torch.kernels.rwkv6.rwkv6 import kernel_config as wkv_config
from repro_torch.kernels.rwkv6.rwkv6 import bwd_config as wkv_bwd_config
from repro_torch.kernels.rwkv6.rwkv6 import \
    bwd_scratch_floats as wkv_bwd_scratch
from repro_torch.kernels.rwkv6.rwkv6 import wkv_bwd_cuda, wkv_cuda
from repro_torch.kernels.zsmask import ops as zs_ops
from repro_torch.kernels.zsmask import ref as zs_ref
from repro_torch.kernels.zsmask.zsmask import zsmask_cuda
from repro_torch.runtime.server import WaveServer
from repro_torch.runtime.serving import PagePool, zipf_requests
from repro_torch.runtime.serving.scheduler import _draft_of

# kernel vs plain version, fp32 on the card: sums in another order
ATOL = RTOL = 1e-5
# per_example_sumsq / clip_sum norms (fp64 sums) against the plain
# version's chunked fp32 dot products (about 1e-7 relative)
SUMSQ_RTOL = 1e-6
# the smoke-size slice, card vs CPU: fp32 products in other orders
SLICE_ATOL = SLICE_RTOL = 1e-4
# the scans against their plain chunked versions: the JAX package's bounds
# for its kernels against the recurrence (tests/test_kernels.py)
WKV_ATOL, WKV_STRONG_ATOL, SSD_ATOL = 2e-5, 1e-4, 5e-5
# the smoke-size slice in bf16, card vs CPU and one serving mode against
# another: each package's bf16 logits lie about 0.05 from its fp32 logits at
# |logit| up to 4, and the port's lie within 0.042 of JAX's
# (tests/test_torch_bf16_serving.py); two bf16 runs whose products and
# attention round at other places are held to the same bound as that file
BF16_SLICE_ATOL = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


def _paged(dev, B, C, Hq, Hkv, D, N, P, nP, q_start, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, C, Hq, D, device=dev, generator=g)
    kp = torch.randn(N, P, Hkv, D, device=dev, generator=g)
    vp = torch.randn(N, P, Hkv, D, device=dev, generator=g)
    tables = torch.stack([torch.randperm(N, device=dev, generator=g)[:nP]
                          for _ in range(B)]).to(torch.int32).contiguous()
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, qs


@pytest.mark.parametrize("B,C,Hq,Hkv,D,N,P,nP,q_start", [
    (4, 1, 16, 2, 128, 64, 16, 8, [0, 40, 127, -1]),     # full-width decode
    (4, 16, 16, 2, 128, 64, 16, 8, [0, 40, 112, -1]),    # full-width chunk
    (2, 32, 16, 2, 128, 32, 16, 4, [0, 20]),             # 256 rows: 2 tiles
    (3, 4, 4, 2, 64, 12, 8, 3, [5, 0, 17]),
    (2, 1, 4, 4, 32, 8, 16, 2, [9, 30]),
    (3, 4, 4, 2, 16, 12, 8, 3, [-1, 3, 8]),              # smoke head dim
    # the smoke's q_starts {0, S/3, S - C, -1} at C 1, 4 (a verify) and 16,
    # odd page counts (splits of unequal runs)
    (4, 1, 16, 2, 128, 160, 16, 32, [0, 170, 511, -1]),
    (4, 4, 16, 2, 128, 160, 16, 32, [0, 170, 508, -1]),
    (4, 16, 16, 2, 128, 160, 16, 32, [0, 170, 496, -1]),
    (4, 4, 16, 2, 128, 64, 16, 7, [0, 37, 108, -1]),
    (4, 16, 16, 2, 128, 64, 16, 9, [0, 48, 128, -1]),
    (4, 4, 8, 2, 64, 40, 4, 13, [0, 17, 48, -1]),
    # stablelm-3b (d_head 80) and phi3-mini-3.8b (96): MHA, 32 kv heads, a
    # row's P.V outputs on 20 or 24 lanes; the serving shapes and odd pages
    (4, 1, 32, 32, 80, 160, 16, 32, [0, 170, 511, -1]),
    (4, 4, 32, 32, 80, 160, 16, 32, [0, 170, 508, -1]),
    (4, 16, 32, 32, 80, 160, 16, 32, [0, 170, 496, -1]),
    (4, 1, 32, 32, 96, 160, 16, 32, [0, 170, 511, -1]),
    (4, 4, 32, 32, 96, 160, 16, 32, [0, 170, 508, -1]),
    (4, 16, 32, 32, 96, 160, 16, 32, [0, 170, 496, -1]),
    (3, 4, 8, 4, 80, 40, 8, 9, [5, 60, -1]),
    (3, 16, 8, 8, 96, 40, 8, 9, [0, 33, 56]),
])
def test_paged_attention_kernel_matches_plain(cuda, B, C, Hq, Hkv, D, N, P,
                                              nP, q_start):
    args = _paged(cuda, B, C, Hq, Hkv, D, N, P, nP, q_start)
    n = dispatch.KERNELS["paged_attention"].launches
    got = paged_ops.paged_attention(*args)
    want = paged_ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["paged_attention"].launches == n + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("C,nP,q_start", [
    (16, 4, [0, 10, 48, -1]),     # 4 splits of one page
    (1, 12, [0, 70, 191, -1]),    # 12 splits, most past the causal limit
    (4, 12, [3, 40, 188, -1]),    # a verify's 32 rows
])
def test_paged_attention_reads_only_the_slots_own_pages(cuda, C, nP, q_start):
    """Pages no table row names hold NaN: one read of them would poison the
    output, also from a split that the causal limit leaves empty."""
    q, kp, vp, tables, qs = _paged(cuda, 4, C, 16, 2, 128, 64, 16, nP,
                                   q_start)
    want = paged_ops.paged_attention(q, kp, vp, tables, qs)
    named = torch.zeros(64, dtype=torch.bool, device=cuda)
    named[tables.long().flatten()] = True
    kp[~named] = float("nan")
    vp[~named] = float("nan")
    got = paged_ops.paged_attention(q, kp, vp, tables, qs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("C,nP,q_start", [
    (1, 32, [0, 170, 511, -1]),
    (4, 32, [0, 170, 508, -1]),
    (16, 32, [0, 170, 496, -1]),
    (16, 9, [0, 48, 128, -1]),
])
def test_paged_attention_kernel_matches_its_split_algorithm(cuda, C, nP,
                                                            q_start):
    """The kernel against ``paged_attention_split_ref`` at the split count
    the wrapper plans for this card: the same runs, the causal skip and the
    ascending combine."""
    args = _paged(cuda, 4, C, 16, 2, 128, 160, 16, nP, q_start)
    _, splits = paged_plan(4, 2, 8 * C, nP, 16,
                           torch.cuda.get_device_properties(cuda)
                           .multi_processor_count)
    assert splits > 1
    got = paged_ops.paged_attention(*args)
    want = paged_ref.paged_attention_split_ref(*args, splits)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_paged_attention_skips_an_unnamed_page(cuda):
    """An id outside [0, N) names no page: the kernel skips it, never reads
    it, as the split algorithm does, in a visible page, past the causal
    limit and in an inactive slot."""
    q, kp, vp, tables, qs = _paged(cuda, 3, 4, 16, 2, 128, 64, 16, 8,
                                   [40, 5, -1])
    tables[0, 1] = 64         # visible to every row of slot 0
    tables[1, 5] = -3         # past slot 1's causal limit
    tables[2, 2] = 1 << 20    # an inactive slot walks every named page
    got = paged_ops.paged_attention(q, kp, vp, tables, qs)
    _, splits = paged_plan(3, 2, 32, 8, 16, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    want = paged_ref.paged_attention_split_ref(q, kp, vp, tables, qs, splits)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_paged_reset_kernel_bit_equal_and_isolated(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    k = torch.randn(36, 40, 16, 2, 128, device=cuda, generator=g)
    v = torch.randn(36, 40, 16, 2, 128, device=cuda, generator=g)
    row = torch.tensor([7, 3, 7, 7, 19, 7], dtype=torch.int32, device=cuda)
    k0, v0 = k.clone(), v.clone()
    kr, vr = k.clone(), v.clone()
    n = dispatch.KERNELS["paged_reset"].launches
    paged_ops.paged_reset(k, v, row)
    paged_ref.paged_reset_ref(kr, vr, row)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["paged_reset"].launches == n + 1
    assert torch.equal(k, kr) and torch.equal(v, vr)
    keep = [i for i in range(40) if i not in (3, 7, 19)]
    assert torch.equal(k[:, keep], k0[:, keep])
    assert torch.equal(v[:, keep], v0[:, keep])
    assert (k[:, [3, 7, 19]] == 0).all() and (v[:, [3, 7, 19]] == 0).all()


@pytest.mark.parametrize("H,D,row,start,end", [
    (2, 128, [7, 3, 19, 30], 14, 17),     # full width, across a page
    (2, 128, [7, 3, 19, 30], 5, 60),      # four pages
    (2, 128, [7, 3, 19, 30], 60, 70),     # runs past the row: cut there
    (3, 5, [4, 4, 9], 2, 40),             # H*D = 15: scalar stores, repeats
])
def test_paged_rollback_kernel_bit_equal_and_isolated(cuda, H, D, row, start,
                                                      end):
    """Whole pools bit-equal to the plain version, +0.0 over NaN and
    negative lanes, every lane outside the range untouched."""
    g = torch.Generator(device=cuda).manual_seed(3)
    k = -torch.rand(36, 40, 16, H, D, device=cuda, generator=g)
    v = torch.randn(36, 40, 16, H, D, device=cuda, generator=g)
    k[:, row[0]] = float("nan")
    row = torch.tensor(row, dtype=torch.int32, device=cuda)
    kr, vr = k.clone(), v.clone()
    n = dispatch.KERNELS["paged_rollback"].launches
    paged_ops.paged_rollback(k, v, row, start, end)
    paged_ref.paged_rollback_ref(kr, vr, row, start, end)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["paged_rollback"].launches == n + 1
    for got, want in ((k, kr), (v, vr)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    dead = torch.zeros(40, 16, dtype=torch.bool, device=cuda)
    for p in range(max(start, 0), min(end, row.numel() * 16)):
        dead[int(row[p // 16]), p % 16] = True
    assert (k.view(torch.int32)[:, dead] == 0).all()
    assert (v.view(torch.int32)[:, dead] == 0).all()
    assert torch.isnan(k[:, int(row[0])][:, ~dead[int(row[0])]]).all()


def _pool_pair(dev, gen, L, N, P, H, D):
    """A stacked (k, v) pool with negative values and NaNs: a zeroed lane
    must be +0.0 to be bit-equal."""
    k = -torch.rand(L, N, P, H, D, device=dev, generator=gen)
    v = torch.randn(L, N, P, H, D, device=dev, generator=gen)
    k[:, 1, :, 0] = float("nan")
    return k, v


def _bits_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("slab", ["page", "token"])
@pytest.mark.parametrize("layers,H,D", [
    ((36,), 2, 128),      # the target pool alone (plain continuous mode)
    ((36, 4), 2, 128),    # target and a 4-layer draft: one launch for both
    ((3, 1), 3, 5),       # H*D = 15: scalar stores
])
def test_pool_zero_kernel_bit_equal_and_isolated(cuda, slab, layers, H, D):
    """Both pools bit-equal to the plain version (+0.0 over NaN and
    negative lanes), every slab outside the list untouched, repeats and
    indices outside the pool dropped, one launch."""
    g = torch.Generator(device=cuda).manual_seed(4)
    N, P = 40, 16
    pools = [_pool_pair(cuda, g, L, N, P, H, D) for L in layers]
    limit = N if slab == "page" else N * P
    idx = [1, 7, 3, 7, 19, 1, -1, limit, limit + 5]  # repeats, outside
    if slab == "token":
        idx += [30 * P + 15, 31 * P, 31 * P + 1]
    want = [(k.clone(), v.clone()) for k, v in pools]
    orig = [(k.clone(), v.clone()) for k, v in pools]
    n = dispatch.KERNELS["paged_" + ("reset" if slab == "page"
                                     else "rollback")].launches
    pool_zero_cuda(pools, np.array(idx), slab)
    paged_ref.pool_zero_ref(want, idx, slab)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["paged_" + ("reset" if slab == "page"
                                        else "rollback")].launches == n + 1
    named = torch.zeros(limit, dtype=torch.bool, device=cuda)
    named[[i for i in idx if 0 <= i < limit]] = True
    for (k, v), (kw, vw), (k0, v0) in zip(pools, want, orig):
        for got, w, o in ((k, kw, k0), (v, vw, v0)):
            assert _bits_equal(got, w)
            flat = got.view(got.shape[0], limit, -1).view(torch.int32)
            assert (flat[:, named] == 0).all()
            assert torch.equal(flat[:, ~named],
                               o.view(o.shape[0], limit, -1)
                               .view(torch.int32)[:, ~named])


def test_pool_zero_launches_once_a_chunk_past_capacity(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    N, P = 64, 16
    pools = [_pool_pair(cuda, g, L, N, P, 2, 128) for L in (4, 2)]
    want = [(k.clone(), v.clone()) for k, v in pools]
    idx = torch.randperm(N * P, generator=torch.Generator().manual_seed(0))
    idx = idx[:600].numpy()  # 256 a launch (csrc/pool_zero.cu): three
    n = dispatch.KERNELS["paged_rollback"].launches
    pool_zero_cuda(pools, idx, "token")
    paged_ref.pool_zero_ref(want, idx, "token")
    torch.cuda.synchronize()
    assert dispatch.KERNELS["paged_rollback"].launches == n + 3
    for (k, v), (kw, vw) in zip(pools, want):
        assert _bits_equal(k, kw) and _bits_equal(v, vw)
    # an empty list launches nothing
    pool_zero_cuda(pools, [], "page")
    assert dispatch.KERNELS["paged_rollback"].launches == n + 3


def test_pool_zero_refuses_what_the_kernel_does_not_take(cuda):
    k = torch.zeros(2, 8, 16, 2, 128, device=cuda)
    for other in (torch.zeros(1, 9, 16, 2, 128, device=cuda),
                  torch.zeros(1, 8, 16, 2, 64, device=cuda)):
        with pytest.raises(ValueError, match="differ"):
            pool_zero_cuda([(k, k.clone()), (other, other.clone())], [1],
                           "page")
    with pytest.raises(ValueError, match="CUDA"):
        pool_zero_cuda([(k.cpu(), k.cpu())], [1], "page")
    with pytest.raises(ValueError, match="all be on cuda or all on cpu"):
        paged_ops.pool_zero([(k, k.clone()), (k.cpu(), k.cpu())], [1],
                            "token")
    with pytest.raises(ValueError, match="dtype"):
        pool_zero_cuda([(k.double(), k.double())], [1], "page")
    with pytest.raises(ValueError, match="contiguous"):
        pool_zero_cuda([(k[..., ::2], k[..., ::2])], [1], "page")
    with pytest.raises(ValueError, match="one or two"):
        pool_zero_cuda([(k, k.clone())] * 3, [1], "page")


def test_page_pool_launches_once_an_event(cuda):
    """An admission zeroes its fresh pages in both pools with one launch,
    and a tick's tails with one; the pools as the plain version leaves
    them."""
    sess = Session.from_config("qwen2.5-3b")
    params = sess.init_params()
    draft_model, _ = _draft_of(sess.model, params, 1)
    pool = PagePool(sess.model, n_slots=3, n_pages=12, page_size=4,
                    pages_per_slot=4, draft_model=draft_model)
    for p in (pool.pages, pool.draft_pages):
        for t in p.values():
            t.fill_(-1.5)
    dispatch.reset_launches()
    for slot in range(3):
        assert pool.alloc(slot, 4)
    assert dispatch.launch_counts()["paged_reset"] == 3
    for p in (pool.pages, pool.draft_pages):
        for t in p.values():
            t.fill_(-1.5)
    kv = [(p["k_pages"], p["v_pages"]) for p in (pool.pages,
                                                  pool.draft_pages)]
    want = [(k.clone(), v.clone()) for k, v in kv]
    ranges = [(0, 6, 9), (1, 3, 3), (2, 13, 16), (1, 11, 14)]
    pool.rollback_many(ranges)
    tokens = sum((paged_ops.token_indices(pool.tables[s], 4, a, b)
                  for s, a, b in ranges), [])
    paged_ref.pool_zero_ref(want, tokens, "token")
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert counts["paged_rollback"] == 1 and counts["paged_reset"] == 3
    for (k, v), (kw, vw) in zip(kv, want):
        assert _bits_equal(k, kw) and _bits_equal(v, vw)
    L, _, _, H, D = kv[0][0].shape
    assert int((kv[0][0] == 0).sum()) == 9 * L * H * D  # 9 distinct tokens


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (4, 32, 16, 2, 128, True),     # direct-mode prefill
    (4, 1, 16, 2, 128, True),      # fewer rows than a block
    (4, 5, 16, 2, 128, True),
    (2, 5, 32, 32, 112, False),
    (2, 100, 16, 2, 128, True),    # ragged last tiles
    (1, 257, 8, 8, 64, True),
    (2, 13, 4, 2, 16, True),       # smoke head dim
    (2, 70, 4, 1, 32, False),
    (4, 32, 32, 32, 112, True),    # zamba2-7b's shared block
    (1, 77, 4, 2, 112, True),
    (4, 32, 32, 32, 112, False),
    (2, 33, 8, 8, 112, True),      # one row past the 32-row tile
    (2, 33, 8, 8, 112, False),
    (2, 100, 8, 4, 112, True),
    (2, 100, 8, 4, 112, False),
    (4, 32, 16, 2, 128, False),
    (2, 33, 16, 2, 128, True),
    (4, 32, 32, 32, 80, True),     # stablelm-3b's prefill
    (4, 32, 32, 32, 96, True),     # phi3-mini-3.8b's prefill
    (2, 77, 8, 4, 80, True),
    (2, 100, 8, 8, 96, False),
])
def test_flash_kernel_matches_plain(cuda, B, S, Hq, Hkv, D, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, S, Hq, D, device=cuda, generator=g)
    k = torch.randn(B, S, Hkv, D, device=cuda, generator=g)
    v = torch.randn(B, S, Hkv, D, device=cuda, generator=g)
    n = dispatch.KERNELS["flash_attention"].launches
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    want = flash_ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["flash_attention"].launches == n + 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, kp, vp, tables, qs = _paged(cuda, 2, 1, 4, 2, 128, 8, 16, 2, [0, 1])
    with pytest.raises(ValueError, match="dtype"):
        paged_ops.paged_attention(q.double(), kp, vp, tables, qs)
    with pytest.raises(ValueError, match="contiguous"):
        paged_ops.paged_attention(q[..., ::2], kp, vp, tables, qs)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(*(torch.zeros(1, 4, 2, 48, device=cuda)
                                    for _ in range(3)))
    with pytest.raises(ValueError, match="all be on cuda or all on cpu"):
        paged_ops.paged_attention(q, kp.cpu(), vp, tables, qs)
    pools = torch.zeros(2, 8, 16, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        paged_ops.paged_rollback(pools.double(), pools.double(), tables[0],
                                 0, 3)
    with pytest.raises(ValueError, match="5-d"):
        paged_ops.paged_rollback(pools[0], pools[0].clone(), tables[0], 0, 3)


def test_smoke_slice_on_card_matches_cpu_and_counts_launches(cuda):
    """The smoke config served on the card (kernels) and on the CPU (plain
    versions) from the same weights: same tokens, logits within tolerance,
    continuous == wave, and each mode launched its kernels."""
    gpu = Session.from_config("qwen2.5-3b")
    cpu = Session.from_config("qwen2.5-3b", device="cpu")
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    prompt = np.random.default_rng(0).integers(0, gpu.cfg.vocab_size, (3, 12))
    dispatch.reset_launches()
    a = gpu.serve(prompt=prompt, params=p_gpu, max_new_tokens=5)
    assert dispatch.launch_counts()["flash_attention"] == gpu.cfg.n_layers
    b = cpu.serve(prompt=prompt, params=p_cpu, max_new_tokens=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.logits.cpu(), b.logits, atol=SLICE_ATOL,
                               rtol=SLICE_RTOL)
    reqs = zipf_requests(6, gpu.cfg.vocab_size, min_len=3, max_len=20,
                         max_new_low=2, max_new_high=6, seed=1)
    out = {}
    for kind in ("wave", "continuous"):
        dispatch.reset_launches()
        out[kind] = gpu.serve(scheduler=kind, requests=copy.deepcopy(reqs),
                              params=p_gpu, max_batch=2, max_len=32,
                              page_size=4, prefill_chunk=4).tokens
        counts = dispatch.launch_counts()
    assert counts["paged_reset"] == len(reqs)
    assert counts["paged_attention"] % gpu.cfg.n_layers == 0
    assert counts["paged_attention"] > 0
    np.testing.assert_array_equal(out["wave"], out["continuous"])
    cont_cpu = cpu.serve(scheduler="continuous", requests=copy.deepcopy(reqs),
                         params=p_cpu, max_batch=2, max_len=32, page_size=4,
                         prefill_chunk=4).tokens
    np.testing.assert_array_equal(out["continuous"], cont_cpu)


def _spy_rollback_ticks(monkeypatch) -> list:
    """Counts, in a one-element list, the ``PagePool.rollback_many`` calls
    (one a speculative tick) that had a tail to erase."""
    ticks = [0]
    real = PagePool.rollback_many

    def spy(self, ranges):
        ranges = list(ranges)
        ticks[0] += any(end > start for _, start, end in ranges)
        real(self, ranges)

    monkeypatch.setattr(PagePool, "rollback_many", spy)
    return ticks


def test_smoke_speculative_on_card_matches_cpu(cuda, monkeypatch):
    """Speculative serving with a 1-layer draft on the card (kernels) and
    on the CPU (plain versions) from the same weights: the same tokens as
    plain decoding, the same proposals and acceptances, and on the card one
    reset launch an admission and one rollback launch a tick that rolled
    back, each covering the target and the draft pool."""
    gpu = Session.from_config("qwen2.5-3b")
    cpu = Session.from_config("qwen2.5-3b", device="cpu")
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    reqs = zipf_requests(6, gpu.cfg.vocab_size, min_len=3, max_len=20,
                         max_new_low=2, max_new_high=8, seed=2)
    kw = dict(scheduler="continuous", max_batch=2, max_len=32, page_size=4,
              prefill_chunk=4)
    plain = gpu.serve(requests=copy.deepcopy(reqs), params=p_gpu, **kw)
    ticks = _spy_rollback_ticks(monkeypatch)
    dispatch.reset_launches()
    a = gpu.serve(requests=copy.deepcopy(reqs), params=p_gpu,
                  speculative=True, draft_layers=1, **kw)
    counts, rolled = dispatch.launch_counts(), ticks[0]
    b = cpu.serve(requests=copy.deepcopy(reqs), params=p_cpu,
                  speculative=True, draft_layers=1, **kw)
    np.testing.assert_array_equal(a.tokens, plain.tokens)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.stats.spec_proposed, a.stats.spec_accepted) == \
        (b.stats.spec_proposed, b.stats.spec_accepted)
    # one launch for both pools: a reset an admission, a rollback a tick
    # that rolled back
    assert counts["paged_rollback"] == rolled > 0
    assert counts["paged_reset"] == len(reqs) + a.stats.preemptions
    assert counts["flash_attention"] == 0



# ---------------------------------------------------------------------------
# the DP kernels: bit-equal to their plain versions (the same separate fp32
# multiplies and adds, no FMA contraction, the same libm log and sqrt)

KX, KP = (2705940334, 2639757084), (4086990474, 1067026239)
KR = (3704974950, 1863054868)


def _clip_mask_args(dev):
    """Silo 1's scalars over a ring with silo 2 dropped (next active 3)."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return ((f(0.731), KR, KX, KP, 1, 4, f(1.2), f(9.6), f(0.7)),
            dict(nxt=3, noise_scale=f(0.6928), prev_noise_scale=f(0.6)))


@pytest.mark.parametrize("n,P", [(4, 1 << 20), (1, 7), (5, 4099), (3, 1024)])
def test_clip_accumulate_kernel_bit_equal(cuda, n, P):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(n, P, device=cuda, generator=g)
    s = torch.rand(n, device=cuda, generator=g)
    s[0] = 0.0  # a dropped silo
    c = dispatch.KERNELS["clip_accumulate"].launches
    got = clip_ops.clip_accumulate(x, s)
    want = clip_ref.clip_accumulate_ref(x, s)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["clip_accumulate"].launches == c + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,use_prev", [(1, True), (4, True), (4, False),
                                        (5, True)])
def test_noise_batch_kernel_bit_equal(cuda, n, use_prev):
    g = torch.Generator(device=cuda).manual_seed(4)
    P = 3 * 1024 + 5
    g_sum = torch.randn(P, device=cuda, generator=g)
    scales = torch.rand(n, device=cuda, generator=g) * 0.3
    lams = torch.full((n,), 0.7, device=cuda)
    if n > 1:
        scales[1] = 0.0          # a silo gated off
        lams[1] = 0.0
    lams[-1] = 0.0               # a lambda gate of 0
    c = dispatch.KERNELS["noise_batch"].launches
    got = noise_ops.noise_batch(g_sum, KX, KP, scales, lams, 0.075, use_prev)
    want = noise_ref.noise_batch_ref(g_sum, KX, KP, scales, lams, 0.075,
                                     use_prev)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["noise_batch"].launches == c + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_pairwise,use_prev", [(True, True),
                                                   (True, False),
                                                   (False, True),
                                                   (False, False)])
def test_clip_mask_kernel_bit_equal(cuda, use_pairwise, use_prev):
    g = torch.randn(3 * 1024 + 5, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    args, kw = _clip_mask_args(cuda)
    c = dispatch.KERNELS["clip_mask"].launches
    got = noise_ops.clip_mask(g, *args, use_pairwise, use_prev, **kw)
    want = noise_ref.clip_mask_ref(g, *args, use_pairwise, use_prev, **kw)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["clip_mask"].launches == c + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    inplace = g.clone()
    assert noise_ops.clip_mask(inplace, *args, use_pairwise, use_prev,
                               out=inplace, **kw) is inplace
    assert torch.equal(inplace, want)


def test_dp_kernels_index_past_2_31(cuda):
    """n * P > 2**31 for the aggregate and P > 2**31 for the noise: windows
    at both ends and across 2**31 equal the plain versions (64-bit offsets;
    the counter keeps JAX's uint32 index)."""
    n, P = 4, (1 << 29) + 4096
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(n, P, device=cuda, generator=g)
    s = torch.tensor([0.5, 1.0, 0.0, 0.25], device=cuda)
    got = clip_ops.clip_accumulate(x, s)
    W = 1 << 16
    for a in (0, P - W):
        assert torch.equal(got[a:a + W],
                           clip_ref.clip_accumulate_ref(x[:, a:a + W], s))
    del x, got
    P = (1 << 31) + 4096
    g_sum = torch.zeros(P, device=cuda)
    one = torch.ones(1, device=cuda)
    got = noise_ops.noise_batch(g_sum, KX, KP, one * 0.3, one * 0.7, 0.1)
    for a in (0, (1 << 31) - W // 2, P - W):
        want = noise_ref.noise_batch_ref(g_sum[a:a + W], KX, KP, one * 0.3,
                                         one * 0.7, 0.1, base=a)
        assert torch.equal(got[a:a + W], want)
    del got
    args, kw = _clip_mask_args(cuda)
    noise_ops.clip_mask(g_sum, *args, out=g_sum, **kw)  # in place
    for a in (0, (1 << 31) - W // 2, P - W):
        win = g_sum[a:a + W]
        want = noise_ref.clip_mask_ref(torch.zeros_like(win), *args, base=a,
                                       **kw)
        assert torch.equal(win, want)


def test_dp_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    s = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        clip_ops.clip_accumulate(x.double(), s)
    with pytest.raises(ValueError, match="scale"):
        clip_ops.clip_accumulate(x, s[:3])
    with pytest.raises(ValueError, match="all be on cuda or all on cpu"):
        clip_ops.clip_accumulate(x, s.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        noise_ops.noise_batch(x[:, 0], KX, KP, s, s, 0.1)
    with pytest.raises(ValueError, match="uint32"):
        noise_ops.noise_batch(x[0], (-1, 0), KP, s, s, 0.1)
    buf = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError, match="scalars"):
        clip_mask_cuda(buf[:64], s, KR, KX, KP, 0, 1)
    with pytest.raises(ValueError, match="disjoint"):
        clip_mask_cuda(buf[:64], torch.ones(5, device=cuda), KR, KX, KP, 0,
                       1, out=buf[32:96])


def test_smoke_training_on_card_matches_cpu(cuda):
    """Two quickstart steps of the smoke config on the card (kernels) and on
    the CPU (plain versions) from the same weights."""
    priv = PrivacyConfig(sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                         noise_lambda=0.7, n_silos=4)
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    gpu = Session.from_config("qwen2.5-3b", privacy=priv, optimizer=opt)
    cpu = Session.from_config("qwen2.5-3b", privacy=priv, optimizer=opt,
                              device="cpu")
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    dispatch.reset_launches()
    a = gpu.train(steps=2, batch_size=8, seq_len=16, log_every=0,
                  state=gpu.init_state(params=p_gpu))
    counts = dispatch.launch_counts()
    assert counts["clip_accumulate"] == 2 and counts["noise_batch"] == 2
    b = cpu.train(steps=2, batch_size=8, seq_len=16, log_every=0,
                  state=cpu.init_state(params=p_cpu))
    for ma, mb in zip(a.metrics, b.metrics):
        assert ma["epsilon"] == mb["epsilon"]
        np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-5)
        np.testing.assert_allclose(ma["clip_bound"], mb["clip_bound"],
                                   rtol=1e-5)
    assert a.state.noise_state.prev_key == b.state.noise_state.prev_key
    diff = (a.state.opt_state["master"].cpu()
            - b.state.opt_state["master"]).abs()
    assert diff.max() <= 2 * 2 * 1e-3  # at most a sign flip of two steps
    assert (diff > 1e-5).sum() <= 2


def test_smoke_barrier_training_on_card_matches_cpu(cuda):
    """Two quickstart steps of the smoke config on the barrier tier, a
    (4,) data mesh, silo 2 out at step 1, on the card (clip_mask) and on
    the CPU (plain versions) from the same weights."""
    priv = PrivacyConfig(sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                         noise_lambda=0.7, sync_path="barrier")
    kw = dict(privacy=priv, optimizer=OptimizerConfig(name="adamw", lr=1e-3),
              mesh=MeshConfig((4,), ("data",)))
    gpu = Session.from_config("qwen2.5-3b", **kw)
    cpu = Session.from_config("qwen2.5-3b", device="cpu", **kw)
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    sched = lambda t: [True, True, t != 1, True]
    dispatch.reset_launches()
    a = gpu.train(steps=2, batch_size=8, seq_len=16, log_every=0,
                  silo_schedule=sched, state=gpu.init_state(params=p_gpu))
    counts = dispatch.launch_counts()
    # 4 + 3: the dropped silo's row is zeroed, with no launch
    assert counts["clip_mask"] == 7 and sum(counts.values()) == 7
    b = cpu.train(steps=2, batch_size=8, seq_len=16, log_every=0,
                  silo_schedule=sched, state=cpu.init_state(params=p_cpu))
    for ma, mb in zip(a.metrics, b.metrics):
        assert ma["epsilon_per_silo"] == mb["epsilon_per_silo"]
        np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-5)
        np.testing.assert_allclose(ma["clip_bound"], mb["clip_bound"],
                                   rtol=1e-5)
    assert a.state.noise_state.prev_key == b.state.noise_state.prev_key
    diff = (a.state.opt_state["master"].cpu()
            - b.state.opt_state["master"]).abs()
    assert diff.max() <= 2 * 2 * 1e-3  # at most a sign flip of two steps


# ---------------------------------------------------------------------------
# the per-example and per-leaf kernels


@pytest.mark.parametrize("offset", [0, 12288, (1 << 31) + 5, (1 << 32) - 1000])
def test_zsmask_kernel_bit_equal(cuda, offset):
    """Counter offsets of a stacked leaf's layers, past 2**31 and wrapping
    inside the flat; in place; and the mask-only pass (b = 0, r drawn)."""
    g = torch.randn(3 * 1024 + 5, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    args = (KR, KX, 1, 4, 1.2, 9.6)
    c = dispatch.KERNELS["zsmask"].launches
    got = zs_ops.apply_zsmask(g, *args, offset=offset)
    want = zs_ref.zsmask_ref(g, *args, offset=offset)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["zsmask"].launches == c + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)
    inplace = g.clone()
    assert zs_ops.apply_zsmask(inplace, *args, offset=offset,
                               out=inplace) is inplace
    assert torch.equal(inplace, want)
    zeros = torch.zeros_like(g)
    assert torch.equal(zs_ops.apply_zsmask(zeros, KR, KP, 1, 4, 1.2, 0.0,
                                           offset=offset),
                       zs_ref.zsmask_ref(zeros, KR, KP, 1, 4, 1.2, 0.0,
                                         offset=offset))


@pytest.mark.parametrize("B,D,ld", [(4, 1 << 20, 1 << 20), (4, 4099, 5000),
                                    (1, 7, 7), (5, 300000, 400004),
                                    (3, 2048, 2048)])
def test_per_example_sumsq_kernel(cuda, B, D, ld):
    """Rows contiguous or ld apart (one leaf's columns of the per-example
    buffer), odd lengths; two launches give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(8)
    buf = torch.randn(B, ld, device=cuda, generator=g)
    buf *= torch.logspace(-2, 2, B, device=cuda)[:, None]
    x = buf[:, :D]
    c = dispatch.KERNELS["per_example_sumsq"].launches
    got = clip_ops.sumsq(x)
    again = clip_ops.sumsq(x)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["per_example_sumsq"].launches == c + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, clip_ref.per_example_sumsq_ref(x),
                               rtol=SUMSQ_RTOL, atol=0)
    torch.testing.assert_close(got, (x.double() ** 2).sum(1).float(),
                               rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("B,P,clip_bound", [(4, 1 << 20, 1.0),
                                            (4, 1 << 20, 600.0),
                                            (3, 4099, 5.0), (1, 1024, 1e9)])
def test_clip_sum_kernel(cuda, B, P, clip_bound):
    """Norms within SUMSQ_RTOL of the plain version's and bit-identical
    across launches; the sum bit-equal to the plain fold at the kernel's
    norms; the whole within tolerance of ``clip_sum_ref``."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(B, P, device=cuda, generator=g)
    x *= torch.logspace(-1, 1, B, device=cuda)[:, None]
    c = dispatch.KERNELS["clip_sum"].launches
    s, n = noise_ops.clip_sum_packed(x, clip_bound)
    s2, n2 = noise_ops.clip_sum_packed(x, torch.tensor(clip_bound,
                                                       device=cuda))
    torch.cuda.synchronize()
    assert dispatch.KERNELS["clip_sum"].launches == c + 2
    assert torch.equal(s, s2) and torch.equal(n, n2)
    want_s, want_n = noise_ref.clip_sum_ref(x, clip_bound)
    torch.testing.assert_close(n, want_n, rtol=SUMSQ_RTOL, atol=0)
    scale = torch.clamp(torch.tensor(clip_bound, device=cuda) / n, max=1.0)
    assert torch.equal(s, clip_ref.clip_accumulate_ref(x, scale))
    torch.testing.assert_close(s, want_s, rtol=0,
                               atol=SUMSQ_RTOL * want_s.abs().max().item())


def test_per_example_kernels_index_past_2_31(cuda):
    """B * P > 2**31 (8.6 GB): the norms of the full rows and windows of
    the sum at both ends, 64-bit offsets."""
    B, P = 4, (1 << 29) + 4096
    x = torch.randn(B, P, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(10))
    n_sq = clip_ops.sumsq(x)
    torch.testing.assert_close(n_sq, clip_ref.per_example_sumsq_ref(x),
                               rtol=SUMSQ_RTOL, atol=0)
    s, n = noise_ops.clip_sum_packed(x, 1.0)
    torch.testing.assert_close(n * n, n_sq, rtol=4 * 2.0 ** -23, atol=0)
    scale = torch.clamp(1.0 / n, max=1.0)
    W = 1 << 16
    for a in (0, P - W):
        assert torch.equal(s[a:a + W],
                           clip_ref.clip_accumulate_ref(x[:, a:a + W], scale))


def test_per_example_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        clip_ops.sumsq(x.double())
    with pytest.raises(ValueError, match="rows must be contiguous"):
        clip_ops.sumsq(x.t())
    with pytest.raises(ValueError, match="clip_bound"):
        clip_sum_cuda(x, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        clip_sum_cuda(x[:, :32], torch.ones(1, device=cuda))
    buf = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError, match="scalars"):
        zsmask_cuda(buf, torch.ones(3, device=cuda), KR, KX, 0, 1)
    with pytest.raises(ValueError, match="uint32"):
        zsmask_cuda(buf, torch.ones(2, device=cuda), KR, KX, 0, 1,
                    offset=1 << 32)
    with pytest.raises(ValueError, match="disjoint"):
        zsmask_cuda(buf[:64], torch.ones(2, device=cuda), KR, KX, 0, 1,
                    out=buf[32:96])


@pytest.mark.parametrize("impl,launches", [
    ("packed", {"clip_sum": 1}),
    ("perleaf", {"per_example_sumsq_tree": 1, "clip_accumulate": 1})])
def test_smoke_per_example_clipping_on_card_matches_cpu(cuda, impl, launches):
    """``per_example_clipped_grad`` on the smoke config, 4 examples, card
    (kernels) vs CPU (plain versions), from the same weights."""
    from repro_torch.core import clipping, flatbuf
    gpu = Session.from_config("qwen2.5-3b")
    cpu = Session.from_config("qwen2.5-3b", device="cpu")
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    batch = cpu.synthetic_batches(4, 16)()
    dispatch.reset_launches()
    a = clipping.per_example_clipped_grad(
        gpu.model.loss, p_gpu, {k: v.to(cuda) for k, v in batch.items()},
        1.0, impl=impl)
    torch.cuda.synchronize()
    counts = {k: v for k, v in dispatch.launch_counts().items() if v}
    assert counts == launches
    b = clipping.per_example_clipped_grad(cpu.model.loss, p_cpu, batch, 1.0,
                                          impl=impl)
    torch.testing.assert_close(a[1].cpu(), b[1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(a[2]), float(b[2]), rtol=1e-5)
    layout = flatbuf.layout_of(b[0])
    torch.testing.assert_close(flatbuf.pack(layout, a[0]).cpu(),
                               flatbuf.pack(layout, b[0]), rtol=0, atol=1e-6)


def test_smoke_perleaf_barrier_training_on_card_matches_cpu(cuda):
    """Two quickstart steps of the smoke config on the barrier tier under
    the perleaf policy, on the card (zsmask_buffer: one launch a silo, 4
    silos, 2 steps, each the lambda-corrected instantiation) and on the CPU
    from the same weights."""
    from repro_torch.kernels.dispatch import force_impl
    priv = PrivacyConfig(sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                         noise_lambda=0.7, sync_path="barrier")
    kw = dict(privacy=priv, optimizer=OptimizerConfig(name="adamw", lr=1e-3),
              mesh=MeshConfig((4,), ("data",)))
    gpu = Session.from_config("qwen2.5-3b", **kw)
    cpu = Session.from_config("qwen2.5-3b", device="cpu", **kw)
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    with force_impl("perleaf", kernel="dp_noise_tree"):
        dispatch.reset_launches()
        a = gpu.train(steps=2, batch_size=8, seq_len=16, log_every=0,
                      state=gpu.init_state(params=p_gpu))
        counts = dispatch.launch_counts()
        variants = dispatch.variant_counts()["zsmask_buffer"]
        b = cpu.train(steps=2, batch_size=8, seq_len=16, log_every=0,
                      state=cpu.init_state(params=p_cpu))
    assert counts["zsmask_buffer"] == 4 * 2
    assert sum(counts.values()) == counts["zsmask_buffer"]
    assert variants == {"plain": 0, "prev": 4 * 2, "bf16": 0,
                        "bf16_prev": 0}
    for ma, mb in zip(a.metrics, b.metrics):
        assert ma["epsilon"] == mb["epsilon"]
        np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-5)
        np.testing.assert_allclose(ma["clip_bound"], mb["clip_bound"],
                                   rtol=1e-5)
    assert a.state.noise_state.prev_key == b.state.noise_state.prev_key
    diff = (a.state.opt_state["master"].cpu()
            - b.state.opt_state["master"]).abs()
    assert diff.max() <= 2 * 2 * 1e-3  # at most a sign flip of two steps


def _wkv_inputs(dev, B, S, H, N, w=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *s: torch.randn(*s, device=dev, generator=g)
    r, k, v = n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5
    w = torch.sigmoid(n(B, S, H, N)) * 0.5 + 0.45 if w is None \
        else torch.full((B, S, H, N), w, device=dev)
    return r, k, v, w, n(H, N) * 0.3, n(B, H, N, N) * 0.1


# the kernel stages 16 tokens a pass (csrc/wkv.cu, WKV_T): 37 and 70 end in a
# ragged pass past two whole ones, 512 walks 32 passes
@pytest.mark.parametrize("B,S,H,N,w,atol", [
    (4, 32, 64, 64, None, WKV_ATOL),   # rwkv6-7b's prefill
    (4, 512, 64, 64, None, WKV_ATOL),  # a long prompt at the same width
    (2, 23, 4, 64, None, WKV_ATOL),    # ragged: the plain version recurs
    (2, 37, 4, 64, None, WKV_ATOL),
    (2, 1, 4, 64, None, WKV_ATOL),
    (3, 1, 2, 32, None, WKV_ATOL),
    (2, 37, 3, 32, None, WKV_ATOL),
    (2, 70, 3, 16, None, WKV_ATOL),
    (1, 1, 3, 16, None, WKV_ATOL),
    (1, 64, 2, 64, 0.05, WKV_STRONG_ATOL),
])
def test_wkv_kernel_matches_plain(cuda, B, S, H, N, w, atol):
    xs = _wkv_inputs(cuda, B, S, H, N, w)
    n = dispatch.KERNELS["wkv"].launches
    o, st = wkv_ops.wkv_chunked(*xs)
    po, pst = wkv_ref.wkv_chunked_ref(*xs)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["wkv"].launches == n + 1
    torch.testing.assert_close(o, po, atol=atol, rtol=0)
    torch.testing.assert_close(st, pst, atol=atol, rtol=0)


def _ssd_inputs(dev, B, S, nh, P, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *s: torch.randn(*s, device=dev, generator=g)
    return (n(B, S, nh, P) * 0.5, torch.nn.functional.softplus(n(B, S, nh)),
            -n(B, S, nh).abs() * 0.5, n(B, S, N) * 0.5, n(B, S, N) * 0.5,
            n(B, nh, P, N) * 0.1)


# the kernel stages 8 tokens a pass (csrc/ssd.cu, SSD_T): 23, 37 and 70 end in a
# ragged pass past two whole ones, 512 walks 64 passes
@pytest.mark.parametrize("B,S,nh,P,N", [
    (4, 32, 112, 64, 64),   # zamba2-7b's prefill
    (4, 512, 112, 64, 64),  # a long prompt at the same width
    (2, 23, 8, 64, 64),     # ragged: the plain version recurs
    (2, 37, 8, 64, 64),
    (2, 1, 8, 64, 64),
    (2, 70, 8, 16, 16),     # the smoke width
    (1, 5, 3, 16, 16),
    (1, 1, 3, 16, 16),
])
def test_ssd_kernel_matches_plain(cuda, B, S, nh, P, N):
    xs = _ssd_inputs(cuda, B, S, nh, P, N)
    n = dispatch.KERNELS["ssd"].launches
    y, h = ssd_ops.ssd_chunked(*xs)
    py, ph = ssd_ref.ssd_chunked_ref(*xs)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["ssd"].launches == n + 1
    torch.testing.assert_close(y, py, atol=SSD_ATOL, rtol=0)
    torch.testing.assert_close(h, ph, atol=SSD_ATOL, rtol=0)


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xs = _wkv_inputs(cuda, 1, 4, 2, 8)
    with pytest.raises(ValueError, match="head size 8"):
        wkv_cuda(*xs)
    xs = _wkv_inputs(cuda, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_cuda(xs[0].transpose(1, 2).contiguous().transpose(1, 2),
                 *xs[1:])
    ys = _ssd_inputs(cuda, 1, 4, 2, 16, 64)
    with pytest.raises(ValueError, match=r"\(P, N\) = \(16, 64\)"):
        ssd_cuda(*ys)
    ys = _ssd_inputs(cuda, 1, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="dtype"):
        ssd_cuda(ys[0].double(), *ys[1:])


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_scan_wrappers_refuse_misaligned_data(cuda):
    """The kernels stage their inputs with 16-byte copies: a contiguous
    view whose data is not 16-byte aligned raises, never launches."""
    xs = _wkv_inputs(cuda, 1, 4, 2, 16)
    n = dispatch.KERNELS["wkv"].launches
    for i, name in ((0, "r"), (1, "k"), (2, "v"), (3, "w"), (5, "state0")):
        args = list(xs)
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match=f"{name}: data must be 16-byte"):
            wkv_cuda(*args)
    ys = _ssd_inputs(cuda, 1, 4, 2, 16, 16)
    for i, name in ((0, "xh"), (3, "Bc"), (4, "Cc"), (5, "h0")):
        args = list(ys)
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match=f"{name}: data must be 16-byte"):
            ssd_cuda(*args)
    assert dispatch.KERNELS["wkv"].launches == n


@pytest.mark.parametrize("P,N", SSD_SHAPES)
def test_ssd_kernel_config_matches_groups(cuda, P, N):
    """The built library sums over the wrapper's ``GROUPS`` (the order the
    split tests check on the CPU), and the card holds a block of it: at
    zamba2-7b's width, the 4 x 112 blocks of its prefill in one wave."""
    cfg = ssd_config(P, N)
    assert cfg["groups"] == SSD_GROUPS[(P, N)]
    assert cfg["blocks_per_sm"] >= 1
    if (P, N) == (64, 64):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert cfg["blocks_per_sm"] * sms >= 4 * 112


@pytest.mark.parametrize("N", WKV_HEAD_SIZES)
def test_wkv_kernel_config_matches_groups(cuda, N):
    """As for ``ssd``: at rwkv6-7b's head size, the 4 x 64 blocks of its
    prefill in one wave."""
    cfg = wkv_config(N)
    assert cfg["groups"] == WKV_GROUPS[N]
    assert cfg["blocks_per_sm"] >= 1
    if N == 64:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert cfg["blocks_per_sm"] * sms >= 4 * 64


@pytest.mark.parametrize("B,S,nh,P,N", [
    (2, 37, 4, 64, 64), (2, 37, 3, 16, 16), (1, 1, 2, 64, 64)])
def test_ssd_kernel_matches_its_split_algorithm(cuda, B, S, nh, P, N):
    """The kernel against ``ssd_split_ref`` at its groups: the same
    partials in the same order, apart from the kernel's fused multiply-adds
    (fp32 rounding)."""
    xs = _ssd_inputs(cuda, B, S, nh, P, N, seed=4)
    y, h = ssd_cuda(*xs)
    py, ph = ssd_ref.ssd_split_ref(*xs, SSD_GROUPS[(P, N)])
    torch.cuda.synchronize()
    torch.testing.assert_close(y, py, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, ph, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,S,H,N", [
    (2, 37, 4, 64), (2, 37, 3, 32), (2, 37, 3, 16), (1, 1, 2, 64)])
def test_wkv_kernel_matches_its_split_algorithm(cuda, B, S, H, N):
    xs = _wkv_inputs(cuda, B, S, H, N, seed=4)
    o, st = wkv_cuda(*xs)
    po, pst = wkv_ref.wkv_split_ref(*xs, WKV_GROUPS[N])
    torch.cuda.synchronize()
    torch.testing.assert_close(o, po, atol=ATOL, rtol=0)
    torch.testing.assert_close(st, pst, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_smoke_ssm_serving_on_card_matches_cpu(cuda, arch):
    """The ssm and hybrid smoke configs served on the card (kernels) and on
    the CPU (plain versions) from the same weights: direct and wave give
    the same tokens, logits within tolerance, and the wave prefill ran the
    family's scan once a layer a wave."""
    gpu = Session.from_config(arch)
    cpu = Session.from_config(arch, device="cpu")
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    prompt = np.random.default_rng(0).integers(0, gpu.cfg.vocab_size, (3, 12))
    a = gpu.serve(prompt=prompt, params=p_gpu, max_new_tokens=5)
    b = cpu.serve(prompt=prompt, params=p_cpu, max_new_tokens=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.logits.cpu(), b.logits, atol=SLICE_ATOL,
                               rtol=SLICE_RTOL)
    reqs = zipf_requests(6, gpu.cfg.vocab_size, min_len=3, max_len=20,
                         max_new_low=2, max_new_high=6, seed=1)
    dispatch.reset_launches()
    wa = gpu.serve(scheduler="wave", requests=copy.deepcopy(reqs),
                   params=p_gpu, max_batch=2, max_len=32)
    counts = dispatch.launch_counts()
    wb = cpu.serve(scheduler="wave", requests=copy.deepcopy(reqs),
                   params=p_cpu, max_batch=2, max_len=32)
    np.testing.assert_array_equal(wa.tokens, wb.tokens)
    scan = "wkv" if arch == "rwkv6-7b" else "ssd"
    assert counts[scan] == gpu.cfg.n_layers * wa.stats.waves


# ---------------------------------------------------------------------------
# the wire tier


# wire rounds card vs CPU at sigma 0.5, C 1 (B = 4) and lr 0.5: each
# round's mean update carries the masks' fp32 residue (contributions reach
# 10 B; 8 ulps of 10 B a sum), moved by lr: over 3 rounds
WIRE_PARAM_ATOL = 3 * 0.5 * 8 * 2.0 ** -23 * 10 * 4.0
# the losses move with the params by that much over 784 inputs
WIRE_LOSS_RTOL = 1e-4


def test_wire_rounds_on_card_match_cpu_and_count_clip_mask(cuda):
    """MNIST-MLP3 (published width) over 4 silos, lambda 0.7, silo 1 out in
    round 1 and back (a full resync) in round 2: the card's session
    launches ``clip_mask`` once per active silo per round, pipelined rounds
    are bit-equal to serial ones on the card, and the card agrees with the
    CPU's plain versions from the same weights."""
    from repro_torch.api import CollaborativeSession
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.core import flatbuf
    from repro_torch.core.tee import wire
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.models.small import build_small_model, value_and_grad

    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y}
             for s in synthetic_mnist(n_train=256, n_test=16)[0].split(4)]
    priv = PrivacyConfig(sigma=0.5, clip_bound=1.0, noise_lambda=0.7)
    init = sm.init(torch.Generator().manual_seed(1))

    def update_fn(p, update, lr):
        return {k: v - lr * torch.as_tensor(update[k], device=v.device)
                for k, v in p.items()}

    def rounds(dev, pipelined):
        sess = CollaborativeSession.from_silos(silos, priv, device=dev)
        params = {k: v.to(dev) for k, v in init.items()}
        dispatch.reset_launches()
        losses = []
        for t in range(3):
            if t == 1:
                sess.drop_silo(1)
            if t == 2:
                sess.rejoin_silo(1)
            params, loss = sess.run(params, value_and_grad(sm.loss),
                                    update_fn, 0.5, 1, pipelined=pipelined)
            losses += loss
        packed = wire.pack_np(flatbuf.layout_of(params), params)
        return sess, packed, losses, dispatch.launch_counts()

    gs, gp, gl, counts = rounds(cuda, False)
    assert counts["clip_mask"] == 4 + 3 + 4 and sum(counts.values()) == 11
    assert gs.accountant.contributions == [4, 3, 4]
    assert gs.wire_stats["resync_bytes"] > 0
    ps, pp, pl, _ = rounds(cuda, True)
    np.testing.assert_array_equal(pp.view(np.uint32), gp.view(np.uint32))
    assert pl == gl and ps.wire_stats == gs.wire_stats
    cs, cp, cl, _ = rounds("cpu", False)
    np.testing.assert_allclose(gl, cl, rtol=WIRE_LOSS_RTOL)
    np.testing.assert_allclose(gp, cp, rtol=0, atol=WIRE_PARAM_ATOL)
    assert gs.epsilon() == cs.epsilon()
    assert gs.accountant.history == cs.accountant.history


# P on the edges of the stream kernels' layout (csrc/stream_grid.cuh),
# resolved on the card: one group of elements short of and past one whole
# resident grid (its blocks an SM x SMs x threads x elements a thread, as
# the built library reports them), past one resident wave of the old
# layout (8 blocks of 256 threads an SM, one element a thread), the wire
# shape (MNIST-MLP3) and a ragged length under it
STREAM_P = ("1", "7", "255", "3077", "grid-W", "grid+W", "235187", "235520",
            "oldwave+1")
# (g's offset, out's offset) into their buffers: out misaligned alone sends
# every load element by element; both misaligned alike keeps 16-byte
# accesses between a scalar head and tail
STREAM_VIEWS = {"aligned": (0, 0), "g[1:] out[1:]": (1, 1), "out[1:]": (0, 1)}


def _stream_p(name: str, kernel: str, dev) -> int:
    if name.isdigit():
        return int(name)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if name == "oldwave+1":
        return sms * 8 * 256 + 1
    cfg = stream_config(kernel)
    grid = sms * cfg["blocks_per_sm"] * cfg["threads"] * cfg["width"]
    return grid - cfg["width"] if name == "grid-W" else grid + cfg["width"]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("P", STREAM_P)
def test_noise_stream_kernel_bit_equal(cuda, P, offset):
    """At every edge of the layout and into a misaligned view (out[1:]:
    a scalar head and tail around 16-byte stores), one launch, nothing
    written outside the view."""
    P = _stream_p(P, "noise_stream", cuda)
    buf = torch.full((P + offset,), float("nan"), device=cuda)
    c = dispatch.KERNELS["noise_stream"].launches
    got = noise_ops.noise_stream(KX, 3, buf[offset:])
    want = noise_ref.noise_stream_ref(KX, 3, P, cuda)
    torch.cuda.synchronize()
    assert dispatch.KERNELS["noise_stream"].launches == c + 1
    assert got.data_ptr() == buf[offset:].data_ptr()
    assert torch.equal(got, want)
    assert torch.isnan(buf[:offset]).all()


@pytest.mark.parametrize("views", list(STREAM_VIEWS))
@pytest.mark.parametrize("P", STREAM_P)
@pytest.mark.parametrize("use_pairwise,use_prev", [(True, True),
                                                   (True, False),
                                                   (False, True),
                                                   (False, False)])
def test_clip_mask_ext_kernel_bit_equal(cuda, use_pairwise, use_prev, P,
                                        views):
    """Given ``noise_stream``'s buffers, the external-stream kernel equals
    its plain version and ``clip_mask``'s in-kernel draw bit for bit, at
    every edge of the layout and in misaligned views: every combination of
    a given and a null stream (both null through the C entry itself), in
    place too, one launch a call, nothing written outside the view."""
    P = _stream_p(P, "clip_mask_ext", cuda)
    go, oo = STREAM_VIEWS[views]
    gen = torch.Generator(device=cuda).manual_seed(6)
    g = torch.randn(P + go, device=cuda, generator=gen)[go:]
    args, kw = _clip_mask_args(cuda)
    xi = noise_ops.noise_stream(KX, 1, torch.empty(P + go, device=cuda)[go:])
    xp = noise_ops.noise_stream(KP, 1, torch.empty(P + go, device=cuda)[go:])
    want = noise_ref.clip_mask_ref(g, *args, use_pairwise, use_prev, xi=xi,
                                   xp=xp, **kw)
    flags = (use_pairwise, use_prev)

    def one_launch(kernel, call):
        buf = torch.full((P + oo,), float("nan"), device=cuda)
        c = dispatch.KERNELS[kernel].launches
        got = call(buf[oo:])
        torch.cuda.synchronize()
        assert dispatch.KERNELS[kernel].launches == c + 1, kernel
        assert got.data_ptr() == buf[oo:].data_ptr()
        assert torch.isnan(buf[:oo]).all()
        return got

    drawn = one_launch("clip_mask", lambda o: noise_ops.clip_mask(
        g, *args, *flags, out=o, **kw))
    assert torch.equal(drawn, want)
    for given in ({"xi": xi, "xp": xp}, {"xi": xi}, {"xp": xp}):
        got = one_launch("clip_mask_ext", lambda o: noise_ops.clip_mask(
            g, *args, *flags, out=o, **given, **kw))
        assert torch.equal(got, want), list(given)
    scalars = torch.stack([args[0], kw["noise_scale"], args[7], args[8],
                           kw["prev_noise_scale"]])
    got = one_launch("clip_mask_ext", lambda o: clip_mask_ext_cuda(
        g, None, None, scalars, KR, KX, KP, 1, kw["nxt"], *flags, out=o))
    assert torch.equal(got, want)
    inplace = g.clone()
    assert noise_ops.clip_mask(inplace, *args, *flags, xi=xi, xp=xp,
                               out=inplace, **kw) is inplace
    assert torch.equal(inplace, want)


def test_stream_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA gradient with CPU streams, or streams of another length or
    dtype, raise in the argument checks: never a quiet draw instead."""
    g = torch.zeros(1024, device=cuda)
    args, kw = _clip_mask_args(cuda)
    xi = noise_ops.noise_stream(KX, 1, torch.empty_like(g))
    for bad, match in ((xi.cpu(), "on cpu"), (xi[:512], "expected"),
                       (xi.double(), "dtype")):
        with pytest.raises(ValueError, match=match):
            noise_ops.clip_mask(g, *args, xi=bad, **kw)
        with pytest.raises(ValueError, match=match):
            noise_ops.clip_mask(g, *args, xp=bad, **kw)
    with pytest.raises(ValueError, match="disjoint"):
        noise_ops.clip_mask(g, *args, xi=xi, out=xi, **kw)
    with pytest.raises(ValueError, match="dtype"):
        noise_ops.noise_stream(KX, 1, torch.empty(8, dtype=torch.float64,
                                                  device=cuda))


def test_speculative_and_tolerant_wire_rounds_on_card_match_serial(cuda):
    """MNIST-MLP3 over 4 silos at lambda 0.7: 3 speculative rounds
    (``noise_stream`` on each miss and prefetch, the external-stream
    ``clip_mask`` once per silo per round, no in-kernel ``clip_mask``) and
    3 fault-free tolerant rounds (the handlers on worker threads, each on
    its own CUDA stream) are bit-equal to the serial ``step`` loop."""
    from repro_torch.api import CollaborativeSession
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.core import flatbuf
    from repro_torch.core.tee import wire
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.models.small import build_small_model, value_and_grad

    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y}
             for s in synthetic_mnist(n_train=256, n_test=16)[0].split(4)]
    priv = PrivacyConfig(sigma=0.5, clip_bound=1.0, noise_lambda=0.7)
    init = sm.init(torch.Generator().manual_seed(1))

    def update_fn(p, update, lr):
        return {k: v - lr * torch.as_tensor(update[k], device=v.device)
                for k, v in p.items()}

    def rounds(**kw):
        sess = CollaborativeSession.from_silos(silos, priv, device=cuda)
        params = {k: v.to(cuda) for k, v in init.items()}
        dispatch.reset_launches()
        params, losses = sess.run(params, value_and_grad(sm.loss), update_fn,
                                  0.5, 3, **kw)
        packed = wire.pack_np(flatbuf.layout_of(params), params)
        return sess, packed, losses, dispatch.launch_counts()

    ss, sp, sl, sc = rounds(pipelined=False)
    assert sc["clip_mask"] == 12 and sc["noise_stream"] == 0
    gs, gp, gl, gc = rounds(speculative=True)
    assert gc["clip_mask_ext"] == 12 and gc["clip_mask"] == 0
    # round 0's xi and xi_{t-1} drawn, then each round's xi prefetched
    assert gc["noise_stream"] == 4 * 2 + 4 * 2
    assert [h._spec_hits for h in gs.handlers] == [4] * 4
    np.testing.assert_array_equal(gp.view(np.uint32), sp.view(np.uint32))
    assert gl == sl and gs.wire_stats == ss.wire_stats
    ts, tp, tl, tc = rounds(round_timeout_s=60.0, quorum=4)
    assert tc["clip_mask"] == 12
    np.testing.assert_array_equal(tp.view(np.uint32), sp.view(np.uint32))
    assert tl == sl and ts.wire_stats == ss.wire_stats


# ---------------------------------------------------------------------------
# the scans' backward (training the ssm and hybrid families)

# the backward kernels against their plain versions: each gradient within
# this share of its largest |value| (at least 1), fp32 sums in other orders
BWD_REL, BWD_STRONG_REL = 2e-5, 1e-4


def _bwd_close(got, want, rel):
    for a, b in zip(got, want):
        tol = rel * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol


# the backward walks 16-token passes between global checkpoints and
# 4-token sub-chunks between shared-memory ones (csrc/wkv_bwd.cu, WKVB_T,
# WKVB_Q): 37 and 61 end in a ragged pass and sub-chunk
@pytest.mark.parametrize("B,S,H,N,w,rel", [
    (4, 64, 64, 64, None, BWD_REL),   # rwkv6-7b's training shape
    (2, 61, 4, 64, None, BWD_REL),
    (2, 1, 4, 64, None, BWD_REL),
    (2, 37, 3, 32, None, BWD_REL),
    (3, 70, 3, 16, None, BWD_REL),    # the smoke width
    (2, 64, 2, 64, 0.02, BWD_STRONG_REL),
])
def test_wkv_bwd_kernel_matches_plain(cuda, B, S, H, N, w, rel):
    xs = _wkv_inputs(cuda, B, S, H, N, w)
    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(B, S, H, N, device=cuda, generator=g)
    ds = torch.randn(B, H, N, N, device=cuda, generator=g) * 0.1
    n = dispatch.KERNELS["wkv_bwd"].launches
    got = wkv_bwd_cuda(*xs, do, ds)
    again = wkv_bwd_cuda(*xs, do, ds)
    assert dispatch.KERNELS["wkv_bwd"].launches == n + 2
    _bwd_close(got, wkv_ref.wkv_backward_ref(*xs, do, ds), rel)
    for a, b in zip(got, again):  # no float atomics: bit-identical
        assert torch.equal(a, b)
    zero = wkv_bwd_cuda(*xs, do, None)
    for a, b in zip(zero, wkv_bwd_cuda(*xs, do, torch.zeros_like(ds))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,nh,P,N,strong", [
    (4, 64, 112, 64, 64, False),  # zamba2-7b's training shape
    (2, 61, 8, 64, 64, False),
    (2, 1, 8, 64, 64, False),
    (2, 70, 8, 16, 16, False),    # the smoke width
    (2, 64, 8, 64, 64, True),     # la near -16: a_t about 1e-7
])
def test_ssd_bwd_kernel_matches_plain(cuda, B, S, nh, P, N, strong):
    xs = list(_ssd_inputs(cuda, B, S, nh, P, N))
    if strong:
        xs[2] = xs[2] - 16.0
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(B, S, nh, P, device=cuda, generator=g)
    dh = torch.randn(B, nh, P, N, device=cuda, generator=g) * 0.1
    n = dispatch.KERNELS["ssd_bwd"].launches
    got = ssd_bwd_cuda(*xs, dy, dh)
    again = ssd_bwd_cuda(*xs, dy, dh)
    assert dispatch.KERNELS["ssd_bwd"].launches == n + 2
    _bwd_close(got, ssd_ref.ssd_backward_ref(*xs, dy, dh),
               BWD_STRONG_REL if strong else BWD_REL)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


# lengths across the backward's pass structure (T = 16 tokens a pass, Q = 4
# a sub-chunk): one token, a pass less one, a pass and one, two passes and
# three (the first global checkpoint), three passes and five (two), 512
BWD_LENGTHS = (1, 15, 17, 35, 53, 512)


@pytest.mark.parametrize("S", BWD_LENGTHS)
@pytest.mark.parametrize("N", WKV_HEAD_SIZES)
def test_wkv_bwd_across_its_passes(cuda, N, S):
    """Against the plain reverse scan, two launches bit-identical, no
    dstate bit-equal to a zero one, at every head size."""
    xs = _wkv_inputs(cuda, 2, S, 3, N, seed=S)
    g = torch.Generator(device=cuda).manual_seed(2)
    do = torch.randn(2, S, 3, N, device=cuda, generator=g)
    ds = torch.randn(2, 3, N, N, device=cuda, generator=g) * 0.1
    got = wkv_bwd_cuda(*xs, do, ds)
    _bwd_close(got, wkv_ref.wkv_backward_ref(*xs, do, ds), BWD_REL)
    for a, b in zip(got, wkv_bwd_cuda(*xs, do, ds)):
        assert torch.equal(a, b)
    for a, b in zip(wkv_bwd_cuda(*xs, do, None),
                    wkv_bwd_cuda(*xs, do, torch.zeros_like(ds))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", BWD_LENGTHS)
@pytest.mark.parametrize("P,N", SSD_SHAPES)
def test_ssd_bwd_across_its_passes(cuda, P, N, S):
    xs = _ssd_inputs(cuda, 2, S, 3, P, N, seed=S)
    g = torch.Generator(device=cuda).manual_seed(2)
    dy = torch.randn(2, S, 3, P, device=cuda, generator=g)
    dh = torch.randn(2, 3, P, N, device=cuda, generator=g) * 0.1
    got = ssd_bwd_cuda(*xs, dy, dh)
    _bwd_close(got, ssd_ref.ssd_backward_ref(*xs, dy, dh), BWD_REL)
    for a, b in zip(got, ssd_bwd_cuda(*xs, dy, dh)):
        assert torch.equal(a, b)
    for a, b in zip(ssd_bwd_cuda(*xs, dy, None),
                    ssd_bwd_cuda(*xs, dy, torch.zeros_like(dh))):
        assert torch.equal(a, b)


def test_bwd_launch_configs_and_scratch(cuda):
    """The backward kernels' configurations as the built library reports
    them: 16-token passes of 4-token sub-chunks, at least one block an SM,
    and at the training shapes every (b, head) resident at once for
    rwkv6-7b's 256 blocks; the checkpoint scratch is the state before each
    pass but the first and the last, none up to two passes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for N in WKV_HEAD_SIZES:
        cfg = wkv_bwd_config(N)
        assert (cfg["tokens"], cfg["sub_tokens"]) == (16, 4)
        assert cfg["blocks_per_sm"] >= 1
    assert wkv_bwd_config(64)["blocks_per_sm"] * sms >= 4 * 64
    for P, N in SSD_SHAPES:
        cfg = ssd_bwd_config(P, N)
        assert (cfg["tokens"], cfg["sub_tokens"]) == (16, 4)
        assert cfg["blocks_per_sm"] >= 1
    assert wkv_bwd_scratch(4, 64, 64, 64) == 4 * 64 * 2 * 64 * 64
    assert wkv_bwd_scratch(2, 32, 3, 16) == 0
    assert ssd_bwd_scratch(4, 64, 112, 64, 64) == 4 * 112 * 2 * 64 * 64
    assert ssd_bwd_scratch(2, 33, 3, 16, 16) == 2 * 3 * 16 * 16


def test_scan_functions_take_the_kernels_on_the_card(cuda):
    """A CUDA tensor that requires grad goes through WKV / SSD: the forward
    kernel once and the backward kernel once, never autograd of the plain
    version; under no_grad the direct call, the forward kernel alone."""
    xs = [t.requires_grad_() for t in _wkv_inputs(cuda, 2, 20, 3, 16)]
    dispatch.reset_launches()
    o, st = wkv_ops.wkv_chunked(*xs)
    (o.square().sum() + st.sum()).backward()
    assert dispatch.launch_counts()["wkv"] == 1
    assert dispatch.launch_counts()["wkv_bwd"] == 1
    assert all(t.grad is not None for t in xs)
    xs = [t.requires_grad_() for t in _ssd_inputs(cuda, 2, 20, 3, 16, 16)]
    y, h = ssd_ops.ssd_chunked(*xs)
    (y.square().sum() + h.sum()).backward()
    with torch.no_grad():
        ssd_ops.ssd_chunked(*xs)
    counts = dispatch.launch_counts()
    assert counts["ssd"] == 2 and counts["ssd_bwd"] == 1
    assert sum(counts.values()) == 5


def test_scan_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xs = _wkv_inputs(cuda, 1, 4, 2, 16)
    do = torch.zeros_like(xs[0])
    with pytest.raises(ValueError, match="do"):
        wkv_bwd_cuda(*xs, do[:, :3])
    with pytest.raises(ValueError, match="dstate"):
        wkv_bwd_cuda(*xs, do, xs[5][..., :8])
    with pytest.raises(ValueError, match="head size 8"):
        wkv_bwd_cuda(*_wkv_inputs(cuda, 1, 4, 2, 8), do[..., :8])
    ys = _ssd_inputs(cuda, 1, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="dy"):
        ssd_bwd_cuda(*ys, torch.zeros(1, 4, 2, 8, device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        ssd_bwd_cuda(*ys, torch.zeros(1 * 4 * 2 * 16 + 1,
                                      device=cuda)[1:].view(1, 4, 2, 16))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_smoke_ssm_training_on_card_matches_cpu(cuda, arch):
    """Two fused steps and one barrier step (silo 2 out) of the family's
    smoke config on the card (the scans' kernels forward and backward) and
    on the CPU (plain versions) from the same weights."""
    priv = PrivacyConfig(sigma=0.3, clip_bound=1.0, dynamic_clip=True,
                         noise_lambda=0.7, n_silos=4)
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    scan = "wkv" if arch == "rwkv6-7b" else "ssd"
    layers = 2  # the smoke configs' depth: one scan a layer a silo
    for tier, kw, steps, sched in (
            ("fused", dict(privacy=priv), 2, None),
            ("barrier", dict(privacy=dataclasses.replace(
                priv, sync_path="barrier", n_silos=0),
                mesh=MeshConfig((4,), ("data",))), 1,
             lambda t: [True, True, False, True])):
        gpu = Session.from_config(arch, optimizer=opt, **kw)
        cpu = Session.from_config(arch, optimizer=opt, device="cpu", **kw)
        p_gpu = gpu.init_params()
        p_cpu = copy.deepcopy(p_gpu).to("cpu")
        dispatch.reset_launches()
        a = gpu.train(steps=steps, batch_size=8, seq_len=16, log_every=0,
                      silo_schedule=sched, state=gpu.init_state(params=p_gpu))
        counts = dispatch.launch_counts()
        assert counts[scan] == counts[scan + "_bwd"] == steps * 4 * layers
        b = cpu.train(steps=steps, batch_size=8, seq_len=16, log_every=0,
                      silo_schedule=sched, state=cpu.init_state(params=p_cpu))
        for ma, mb in zip(a.metrics, b.metrics):
            assert ma["epsilon"] == mb["epsilon"]
            np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-5)
            np.testing.assert_allclose(ma["clip_bound"], mb["clip_bound"],
                                       rtol=1e-5)
        assert a.state.noise_state.prev_key == b.state.noise_state.prev_key
        diff = (a.state.opt_state["master"].cpu()
                - b.state.opt_state["master"]).abs()
        assert diff.max() <= 2 * steps * 1e-3  # at most sign flips


# ---------------------------------------------------------------------------
# the per-leaf normal draw (kernels/prng)

NORMAL_KEYS = ((2705940334, 2639757084), (4086990474, 1067026239))


@pytest.mark.parametrize("n,offset", [(1, 0), (7, 3), ((1 << 22) + 3, 0),
                                      (5000, (1 << 32) - 1000)])
def test_normal_kernels_bit_equal_plain(cuda, n, offset):
    from repro_torch.kernels.prng import ops as prng_ops
    from repro_torch.kernels.prng import ref as prng_ref
    key, prev = NORMAL_KEYS
    z = prng_ops.normal(key, offset, torch.empty(n, device=cuda))
    assert torch.equal(z, prng_ref.normal_ref(key, n, offset, cuda))
    f = lambda x: torch.full((), x, device=cuda)
    for key_b, g in ((prev, 0.7), (prev, 0.0), (None, 0.0)):
        for acc in (False, True):
            base = torch.linspace(-1, 1, n, device=cuda)
            got = prng_ops.normal_combine(base.clone(), key, key_b, offset,
                                          f(1.3), f(1.1), f(g), acc)
            want = prng_ref.normal_combine_ref(base.clone(), key, key_b,
                                               offset, f(1.3), f(1.1), f(g),
                                               acc)
            assert torch.equal(got, want), (key_b, g, acc)


def test_corrected_noise_launches_once_a_leaf_tensor(cuda):
    from repro_torch.core import flatbuf
    from repro_torch.core.noise_correction import NoiseState, corrected_noise
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal(1000), "b": rng.standard_normal((3, 77)),
            "e": [rng.standard_normal((5, 60)) for _ in range(3)]}
    cpu = {k: [torch.from_numpy(x.astype(np.float32)) for x in v]
           if isinstance(v, list) else torch.from_numpy(v.astype(np.float32))
           for k, v in tree.items()}
    gpu = {k: [x.to(cuda) for x in v] if isinstance(v, list) else v.to(cuda)
           for k, v in cpu.items()}
    key, prev = NORMAL_KEYS
    dispatch.reset_launches()
    corrected_noise(gpu, key, NoiseState(prev, True),
                    torch.full((), 1.2, device=cuda), 0.7)
    assert dispatch.launch_counts()["normal_combine"] == 5
    corrected_noise(cpu, key, NoiseState(prev, True), torch.tensor(1.2), 0.7)
    layout = flatbuf.layout_of(cpu)
    # card vs CPU: log1p of CUDA's math library and of libm (a few ulp of
    # normals of std 1.2)
    diff = flatbuf.pack(layout, gpu).cpu() - flatbuf.pack(layout, cpu)
    assert diff.abs().max() <= 4e-6


def test_normal_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.prng import ops as prng_ops
    key = NORMAL_KEYS[0]
    with pytest.raises(ValueError, match="key words must be uint32"):
        prng_ops.normal((1 << 32, 0), 0, torch.empty(4, device=cuda))
    with pytest.raises(ValueError, match="expected cuda"):
        prng_ops.normal_combine(torch.empty(4, device=cuda), key, None, 0,
                                torch.tensor(1.0))
    with pytest.raises(ValueError, match="contiguous fp32"):
        prng_ops.normal(key, 0, torch.empty(4, 6, device=cuda).t())


# ---------------------------------------------------------------------------
# bf16: the attention kernels and the page pools' zeroing in the compute
# type of bf16 serving


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (4, 32, 16, 2, 128, True),     # qwen2.5-3b's direct-mode prefill
    (4, 1, 16, 2, 128, True),      # fewer rows than a block
    (4, 5, 16, 2, 128, True),
    (4, 32, 32, 32, 112, True),    # zamba2-7b's shared block
    (2, 5, 32, 32, 112, True),
    (4, 32, 32, 32, 80, True),     # stablelm-3b
    (4, 32, 32, 32, 96, True),     # phi3-mini-3.8b
    (2, 100, 8, 4, 112, False),    # ragged tiles, several key tiles
    (2, 33, 16, 2, 128, True),
    (2, 13, 4, 2, 16, True),       # smoke head dims
    (1, 77, 4, 2, 32, True),
    (1, 70, 8, 8, 64, False),
])
def test_flash_bf16_kernel_within_one_ulp_of_plain(cuda, B, S, Hq, Hkv, D,
                                                   causal):
    """bf16 in and out on the tensor cores (the lse forward's kernel, no
    lse): within one bf16 ulp of the plain version past the fp32 gate (the
    kernel's fp32 result and the plain one agree within ATOL / RTOL, and
    each rounds once), within the gate of ``flash_forward_split_model
    (terms=2)`` (its arithmetic: P as three bf16 terms; ATOL + RTOL of the
    largest |value| plus one ulp), and bit-equal across two launches."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(B, S, H, D, device=cuda, generator=g)
               .to(torch.bfloat16) for H in (Hq, Hkv, Hkv))
    kern = dispatch.KERNELS["flash_attention"]
    dispatch.reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    assert kern.variants == {"f32": 0, "bf16": 1, "lse_f32": 0,
                             "lse_bf16": 0}
    again = flash_ops.flash_attention(q, k, v, causal=causal)
    assert kern.variants == {"f32": 0, "bf16": 2, "lse_f32": 0,
                             "lse_bf16": 0}
    want = flash_ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    ulp = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    err = (got.float() - want.float()).abs()
    gate = ATOL + RTOL * want.float().abs() + ulp
    assert bool((err <= gate).all()), float((err - gate).max())
    model, _ = flash_ref.flash_forward_split_model(q.cpu(), k.cpu(), v.cpu(),
                                                   causal)
    diff = (got.cpu().float() - model.float()).abs()
    gate = ATOL + RTOL * model.float().abs().max() + bf16_ulp(torch.maximum(
        got.cpu().float().abs(), model.float().abs()))
    assert bool((diff <= gate).all()), float((diff - gate).max())
    dispatch.reset_launches()


@pytest.mark.parametrize("B,C,Hq,Hkv,D,N,P,nP,q_start", [
    (4, 1, 16, 2, 128, 160, 16, 32, [0, 170, 511, -1]),   # qwen2.5-3b
    (4, 4, 16, 2, 128, 160, 16, 32, [0, 170, 508, -1]),
    (4, 16, 16, 2, 128, 160, 16, 32, [0, 170, 496, -1]),
    (4, 1, 32, 32, 80, 160, 16, 32, [0, 170, 511, -1]),   # Hkv 32
    (4, 4, 32, 32, 80, 160, 16, 32, [0, 170, 508, -1]),
    (4, 16, 32, 32, 96, 160, 16, 32, [0, 170, 496, -1]),
    (4, 1, 64, 4, 128, 160, 16, 32, [0, 170, 511, -1]),   # G 16 (qwen3-moe)
    (4, 16, 64, 4, 128, 160, 16, 32, [0, 170, 496, -1]),  # 256 rows
    (3, 4, 4, 2, 16, 12, 8, 3, [-1, 3, 8]),               # smoke head dim
    (3, 4, 8, 4, 64, 40, 4, 13, [0, 17, 48]),
])
def test_paged_attention_bf16_kernel_matches_plain(cuda, B, C, Hq, Hkv, D, N,
                                                   P, nP, q_start):
    """bf16 q and pools, fp32 out, on the tensor cores: within the fp32
    tolerance of the plain version and of ``paged_attention_split_model``
    (the kernel's chunks, warp merges and three-term P), two launches bit for
    bit, one launch a call on the bf16 variant. (The design on the CUDA
    cores this replaces was bit-equal to the fp32 kernel on the widened
    inputs; the tensor cores sum in another order.)"""
    args = _paged(cuda, B, C, Hq, Hkv, D, N, P, nP, q_start)
    args = [a.to(torch.bfloat16) for a in args[:3]] + list(args[3:])
    kern = dispatch.KERNELS["paged_attention"]
    dispatch.reset_launches()
    got = paged_ops.paged_attention(*args)
    assert kern.variants == {"f32": 0, "bf16": 1}
    again = paged_ops.paged_attention(*args)
    assert kern.variants == {"f32": 0, "bf16": 2}
    want = paged_ref.paged_attention_ref(*args)
    model = paged_ref.paged_attention_split_model(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, model, atol=ATOL, rtol=RTOL)
    dispatch.reset_launches()


def test_paged_attention_bf16_entry_refuses_another_plan(cuda):
    """The bf16 entry takes only the plan ``plan_tc`` makes (the row tile
    its G*C calls for, ceil(nP * P / 128) chunks) and a head dim it was
    built for; anything else returns an error and launches nothing."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        _ATTENTION, plan_tc)
    q, kp, vp, tables, qs = (a.to(torch.bfloat16) if a.is_floating_point()
                             else a for a in _paged(cuda, 2, 1, 32, 32, 80,
                                                    64, 16, 32, [0, 300]))
    dev = q.device  # with its index, as the wrapper passes it
    out = torch.full(q.shape, float("nan"), device=dev)
    rows, chunks = plan_tc(1, 32, 16)
    part = torch.empty(2 * 32 * chunks * (80 + 2), device=dev)
    base = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            qs.data_ptr(), out.data_ptr(), part.data_ptr(), 2, 1, 32, 32, 64,
            16)
    for D, r, c in ((80, 16, chunks), (80, rows, chunks + 1),
                    (80, rows, chunks - 1), (112, rows, chunks)):
        assert _ATTENTION["bf16"].launch(dev, *base, D, 32, r, c,
                                         80 ** -0.5) != 0
    torch.cuda.synchronize()
    assert torch.isnan(out).all()
    assert _ATTENTION["bf16"].launch(dev, *base, 80, 32, rows, chunks,
                                     80 ** -0.5) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("slab", ["page", "token"])
@pytest.mark.parametrize("layers,H,D", [
    ((36, 4), 2, 128),    # qwen2.5-3b's target and a 4-layer draft
    ((2,), 32, 80),       # stablelm-3b's slab
    ((3, 1), 3, 4),       # H*D = 12: 16-byte stores in fp32, not in bf16
    ((3, 1), 3, 5),       # H*D = 15: scalar stores
])
def test_pool_zero_bf16_kernel_bit_equal_and_isolated(cuda, slab, layers, H,
                                                      D):
    """bf16 pools: bit-equal to the plain version (+0.0 over NaN and
    negative lanes), every slab outside the list untouched, one launch on
    the bf16 variant."""
    g = torch.Generator(device=cuda).manual_seed(6)
    N, P = 40, 16
    pools = [tuple(t.to(torch.bfloat16) for t in
                   _pool_pair(cuda, g, L, N, P, H, D)) for L in layers]
    limit = N if slab == "page" else N * P
    idx = [1, 7, 3, 7, 19, 1, -1, limit, limit + 5]
    want = [(k.clone(), v.clone()) for k, v in pools]
    orig = [(k.clone(), v.clone()) for k, v in pools]
    name = "paged_" + ("reset" if slab == "page" else "rollback")
    dispatch.reset_launches()
    paged_ops.pool_zero(pools, idx, slab)
    paged_ref.pool_zero_ref(want, idx, slab)
    torch.cuda.synchronize()
    assert dispatch.KERNELS[name].variants == {"f32": 0, "bf16": 1}
    named = torch.zeros(limit, dtype=torch.bool, device=cuda)
    named[[i for i in idx if 0 <= i < limit]] = True
    for (k, v), (kw, vw), (k0, v0) in zip(pools, want, orig):
        for got, w, o in ((k, kw, k0), (v, vw, v0)):
            bits = got.view(torch.int16)
            assert torch.equal(bits, w.view(torch.int16))
            flat = bits.view(got.shape[0], limit, -1)
            assert (flat[:, named] == 0).all()
            assert torch.equal(flat[:, ~named],
                               o.view(torch.int16).view(o.shape[0], limit,
                                                        -1)[:, ~named])
    dispatch.reset_launches()


def test_bf16_wrappers_refuse_other_types_and_mixes(cuda):
    """A bf16 CUDA tensor reaches its bf16 kernel or raises: fp16, and q
    against pools (or K against V, or a target pool against its draft's) of
    another type, raise; nothing runs the plain version."""
    q, kp, vp, tables, qs = _paged(cuda, 2, 1, 4, 2, 128, 8, 16, 2, [0, 1])
    bq, bk, bv = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    dispatch.reset_launches()
    for args in ((bq, kp, vp), (q, bk, bv), (bq, bk, vp), (q.half(),
                                                          kp.half(),
                                                          vp.half())):
        with pytest.raises(ValueError, match="dtype"):
            paged_ops.paged_attention(*args, tables, qs)
    fq = torch.zeros(1, 4, 2, 128, device=cuda)
    for args in ((fq.bfloat16(), fq, fq), (fq, fq.bfloat16(), fq),
                 (fq.half(),) * 3):
        with pytest.raises(ValueError, match="dtype"):
            flash_ops.flash_attention(*args)
    pools = torch.zeros(2, 8, 16, 2, 128, device=cuda)
    bp = pools.bfloat16()
    for pair in ([(bp, pools)], [(bp, bp.clone()), (pools, pools.clone())],
                 [(pools.half(), pools.half())]):
        with pytest.raises(ValueError, match="dtype"):
            pool_zero_cuda(pair, [1], "page")
    assert sum(dispatch.launch_counts().values()) == 0


class _WaveTrace:
    """A wave server's logits row by row, keyed by the row's prompt, from
    its model's prefill and decode calls."""

    def __init__(self):
        self.rows: dict = {}
        self._wave: list = []

    def model(self, model):
        def prefill(p, tokens, cache):
            logits = model.prefill(p, tokens, cache)
            self._wave = [self.rows.setdefault(t.tobytes(), []) for t in
                          tokens.cpu().numpy().astype(np.int32)]
            self._add(logits)
            return logits

        def decode(p, tokens, cache):
            logits = model.decode_step(p, tokens, cache)
            self._add(logits)
            return logits

        return dataclasses.replace(model, prefill=prefill, decode_step=decode)

    def _add(self, logits) -> None:
        for row, x in zip(self._wave, logits.float().cpu().numpy()):
            row.append(x)

    def of(self, req) -> list:
        return self.rows[np.asarray(req.prompt, np.int32).tobytes()]


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top[1] - top[0])


def _held_up_to_near_ties(ref_reqs, reqs, ref_trace, trace, atol) -> int:
    """Logits within ``atol`` token by token; a request's tokens may part
    only where the reference's top-2 margin is within 2 * atol, and are not
    compared past it. Returns the tokens compared."""
    compared = 0
    for ra, rb in zip(ref_reqs, reqs):
        ta, tb = ref_trace(ra), trace(rb)
        for j, (a, b) in enumerate(zip(ta[:len(ra.generated)], tb)):
            np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                       err_msg=f"rid {rb.rid} token {j}")
            compared += 1
            if rb.generated[j] != ra.generated[j]:
                assert _margin(a) <= 2 * atol, (rb.rid, j, _margin(a))
                break
        else:
            assert rb.generated == ra.generated
    return compared


def test_smoke_bf16_serving_on_card_launches_the_bf16_kernels(cuda):
    """The smoke config in bf16 on the card, every mode: flash, paged
    attention, reset and rollback on their bf16 variants only; continuous
    held to wave and speculative to continuous (logits within
    BF16_SLICE_ATOL, tokens equal but at near-ties); direct logits within
    BF16_SLICE_ATOL of the CPU's (the plain versions, the same weights)."""
    from repro_torch.runtime.serving import ContinuousServer

    gpu = Session.from_config("qwen2.5-3b", compute_dtype=torch.bfloat16)
    cpu = Session.from_config("qwen2.5-3b", compute_dtype=torch.bfloat16,
                              device="cpu")
    p_gpu = gpu.init_params()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    prompt = np.random.default_rng(0).integers(0, gpu.cfg.vocab_size, (3, 12))
    dispatch.reset_launches()
    a = gpu.serve(prompt=prompt, params=p_gpu, max_new_tokens=5)
    var = dispatch.variant_counts()
    assert var["flash_attention"] == {"f32": 0, "bf16": gpu.cfg.n_layers,
                                      "lse_f32": 0, "lse_bf16": 0}
    b = cpu.serve(prompt=prompt, params=p_cpu, max_new_tokens=5)
    assert a.logits.dtype == torch.bfloat16
    torch.testing.assert_close(a.logits.float().cpu(), b.logits.float(),
                               atol=BF16_SLICE_ATOL, rtol=0)
    reqs = zipf_requests(5, gpu.cfg.vocab_size, min_len=3, max_len=16,
                         max_new_low=2, max_new_high=6, seed=0)
    kw = dict(max_batch=2, max_len=32, page_size=4, prefill_chunk=4)
    runs = {}
    for kind, extra in (("wave", None), ("continuous", {}),
                        ("speculative", dict(speculative=True, spec_k=4,
                                             draft_layers=1))):
        rs = copy.deepcopy(reqs)
        dispatch.reset_launches()
        if extra is None:
            wt = _WaveTrace()
            srv = WaveServer(wt.model(gpu.model), p_gpu, max_batch=2,
                             max_len=32)
            trace = wt.of
        else:
            srv = ContinuousServer(gpu.model, p_gpu, trace_logits=True,
                                   **kw, **extra)
            trace = (lambda s: lambda r: s.logit_trace[r.rid])(srv)
        for r in rs:
            srv.submit(r)
        assert srv.run_until_drained().drained
        var = dispatch.variant_counts()
        assert all(v.get("f32", 0) == 0 for v in var.values()), var
        if extra is not None:
            assert var["paged_attention"]["bf16"] > 0
            assert var["paged_reset"]["bf16"] == len(reqs)
        if kind == "speculative":
            assert var["paged_rollback"]["bf16"] > 0
        runs[kind] = (rs, trace)
    (rw, tw), (rc, tc), (rsp, tsp) = (runs[k] for k in (
        "wave", "continuous", "speculative"))
    assert _held_up_to_near_ties(rw, rc, tw, tc, BF16_SLICE_ATOL) > 10
    assert _held_up_to_near_ties(rc, rsp, tc, tsp, BF16_SLICE_ATOL) > 10
    dispatch.reset_launches()
