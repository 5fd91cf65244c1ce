"""The page pools' batched zeroing (``ops.pool_zero``: one launch an event
on the card) against the JAX package's ``paged_reset`` and
``paged_rollback``, the Pallas kernels in interpret mode applied range by
range and pool by pool, bit for bit; the host's index resolution
(``ops.token_indices``); the page pool's one call an event; and a
speculative ``ContinuousServer`` whose tick erases every rejected tail at
once against the same run erasing slot by slot inside its accept loop, the
pools bit-equal after every tick. On CPU tensors the port runs the plain
version; the CUDA kernel is held to it on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention.paged_attention import paged_reset_pallas
from repro_torch import api
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.paged_attention import (
    PAGED_RESET, PAGED_ROLLBACK, SLABS, pool_zero_cuda)
from repro_torch.runtime.serving import (ContinuousServer, PagePool,
                                         shared_prefix_requests)
from repro_torch.runtime.serving.scheduler import _draft_of


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, P, H, D = 10, 4, 2, 8
LAYERS = (3, 1)  # the target pool and an early-exit draft's
# three slots' table rows, each padded with its first page (PagePool's
# layout); the owned pages are distinct across slots
TABLE = np.array([[5, 2, 9, 5],
                  [1, 7, 1, 1],
                  [3, 0, 8, 4]], np.int32)


def _pools(seed):
    """Both pools as numpy (k, v) pairs: negative values and NaNs, so a
    zeroed lane must be +0.0 to compare equal bit for bit."""
    rng = np.random.default_rng(seed)
    out = []
    for L in LAYERS:
        k = -np.abs(rng.standard_normal((L, N, P, H, D))).astype(np.float32)
        v = rng.standard_normal((L, N, P, H, D)).astype(np.float32)
        k[:, 2, 1:, 0] = np.nan
        v[:, 9, 0] = np.nan
        out.append((k, v))
    return out


def _port(pools, idx, slab):
    tp = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in pools]
    ops.pool_zero(tp, idx, slab)
    return [(k.numpy(), v.numpy()) for k, v in tp]


def _bits(a):
    return a.view(np.uint32)


def _assert_pools_bit_equal(got, want):
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_array_equal(_bits(gk), _bits(wk))
        np.testing.assert_array_equal(_bits(gv), _bits(wv))


@pytest.mark.parametrize("ranges", [
    # one tail per slot, across page boundaries (spec_k 4 rejects <= 3)
    [(0, 3, 6), (1, 6, 8), (2, 9, 12)],
    # overlapping ranges of one slot: repeated tokens, dropped on the host
    [(0, 2, 7), (0, 5, 11), (2, 13, 16), (1, 0, 2)],
    # empty and reversed ranges among live ones
    [(0, 4, 4), (2, 7, 3), (1, 1, 7), (2, 0, 1)],
])
def test_batched_rollback_bit_equal_to_pallas_range_by_range(ranges):
    pools = _pools(0)
    tokens = sum((ops.token_indices(TABLE[s], P, a, b) for s, a, b in ranges),
                 [])
    got = _port(pools, tokens, "token")
    want = []
    for k, v in pools:
        for s, a, b in ranges:
            if b > a:  # the JAX op returns its (donated) inputs when empty
                k, v = (np.asarray(x) for x in jax_ops.paged_rollback(
                    jnp.array(k), jnp.array(v), jnp.asarray(TABLE[s]), a, b,
                    impl="pallas"))
        want.append((k, v))
    _assert_pools_bit_equal(got, want)
    # the dead lanes are +0.0 in both pools, every other lane as it was
    for (gk, gv), (k, v) in zip(got, pools):
        dead = np.zeros((N, P), bool)
        for s, a, b in ranges:
            for pos in range(a, b):
                dead[TABLE[s][pos // P], pos % P] = True
        for g, orig in ((gk, k), (gv, v)):
            assert (_bits(g[:, dead]) == 0).all()
            np.testing.assert_array_equal(_bits(g[:, ~dead]),
                                          _bits(orig[:, ~dead]))


@pytest.mark.parametrize("pages", [
    [6, 2],
    [6, 2, 6, 6],        # a padded row: its first page repeated
    [4, 4, 4, 0, 9, 4],  # repeats inside and a page NaN-poisoned (9)
])
def test_batched_reset_bit_equal_to_pallas_pool_by_pool(pages):
    pools = _pools(1)
    got = _port(pools, pages, "page")
    want = [tuple(np.asarray(x) for x in paged_reset_pallas(
        jnp.array(k), jnp.array(v), jnp.asarray(np.array(pages, np.int32)),
        interpret=True)) for k, v in pools]
    _assert_pools_bit_equal(got, want)
    keep = [p for p in range(N) if p not in pages]
    for (gk, gv), (k, v) in zip(got, pools):
        assert (_bits(gk[:, pages]) == 0).all()
        assert (_bits(gv[:, pages]) == 0).all()
        np.testing.assert_array_equal(_bits(gk[:, keep]), _bits(k[:, keep]))


def test_token_indices_resolve_a_row():
    row = [5, 2, 9, 5]
    np.testing.assert_array_equal(ops.token_indices(row, P, 3, 6),
                                  [5 * P + 3, 2 * P, 2 * P + 1])
    # positions outside [0, len(row) * P) name no page
    np.testing.assert_array_equal(ops.token_indices(row, P, 14, 20),
                                  [5 * P + 2, 5 * P + 3])
    np.testing.assert_array_equal(ops.token_indices(row, P, -2, 1), [5 * P])
    for a, b in ((6, 6), (7, 3), (16, 19)):
        assert ops.token_indices(row, P, a, b) == []


def test_plain_version_skips_indices_outside_the_pool():
    pools = _pools(2)
    for slab, limit in (("page", N), ("token", N * P)):
        got = _port(pools, [-1, limit, limit + 7, -(2 ** 40)], slab)
        _assert_pools_bit_equal(got, pools)


def test_pools_that_differ_raise():
    k = torch.zeros(2, N, P, H, D)
    for other in (torch.zeros(1, N + 1, P, H, D), torch.zeros(1, N, P, H, 4)):
        with pytest.raises(ValueError, match="differ"):
            ops.pool_zero([(k, k.clone()), (other, other.clone())], [1],
                          "page")
    with pytest.raises(ValueError, match="one or two"):
        ops.pool_zero([(k, k.clone())] * 3, [1], "page")
    with pytest.raises(ValueError, match="slab"):
        ops.pool_zero([(k, k.clone())], [1], "row")


def test_cpu_tensors_count_no_launch():
    before = dispatch.launch_counts()
    _port(_pools(3), [1, 2], "page")
    _port(_pools(3), [5, 6, 7], "token")
    assert dispatch.launch_counts() == before
    assert SLABS == {"page": PAGED_RESET, "token": PAGED_ROLLBACK}
    assert PAGED_RESET.source == PAGED_ROLLBACK.source == \
        "src/repro_torch/kernels/paged_attention/csrc/pool_zero.cu"


def test_cuda_wrapper_refuses_cpu_tensors():
    k = torch.zeros(1, N, P, H, D)
    with pytest.raises(ValueError, match="CUDA"):
        pool_zero_cuda([(k, k.clone())], [1], "page")


# ---------------------------------------------------------------------------
# the page pool and the speculative scheduler


ARCH = "qwen2.5-3b"
SERVER = dict(max_batch=3, max_len=64, page_size=4, prefill_chunk=8,
              speculative=True, spec_k=4, draft_layers=1)
REQS = dict(n_groups=2, prefix_len=8, tail_min=1, tail_max=12,
            max_new_low=4, max_new_high=10, seed=7)


@pytest.fixture(scope="module")
def weights():
    sess = api.Session.from_config(ARCH, device="cpu")
    return sess.model, sess.init_params()


def _spy(monkeypatch):
    calls = []
    real = ops.pool_zero

    def spy(pools, idx, slab):
        calls.append(([tuple(k.shape) for k, _ in pools], list(idx), slab))
        real(pools, idx, slab)

    monkeypatch.setattr(ops, "pool_zero", spy)
    return calls


def test_admission_zeroes_distinct_fresh_pages_of_both_pools_at_once(
        weights, monkeypatch):
    model, params = weights
    draft_model, _ = _draft_of(model, params, 1)
    pool = PagePool(model, n_slots=2, n_pages=8, page_size=4,
                    pages_per_slot=4, draft_model=draft_model,
                    prefix_index=True)
    calls = _spy(monkeypatch)
    for p in (pool.pages, pool.draft_pages):
        for t in p.values():
            t.fill_(1.5)  # a previous tenant's K/V
    assert pool.alloc(0, 2)
    shared = pool.slot_pages(0)[:1]
    for p in (pool.pages, pool.draft_pages):
        for t in p.values():
            t[:, shared] = 2.5  # the prefix the sharer is here for
    assert pool.alloc(1, 3, shared=shared)
    fresh = [pool.slot_pages(0), pool.slot_pages(1)[1:]]
    shapes = [tuple(pool.pages["k_pages"].shape),
              tuple(pool.draft_pages["k_pages"].shape)]
    # one call an admission, both pools, the fresh pages only: no padding,
    # no shared page
    assert calls == [(shapes, fresh[0], "page"), (shapes, fresh[1], "page")]
    assert pool.tables[0].tolist()[2:] == [fresh[0][0]] * 2  # padded row
    for p in (pool.pages, pool.draft_pages):
        for t in p.values():
            # slot 0's first page is the shared one, written after its reset
            assert (t[:, fresh[0][1:] + fresh[1]] == 0).all()
            assert (t[:, shared] == 2.5).all()
    # one call for several ranges; a bad range erases nothing
    calls.clear()
    pool.rollback_many([(0, 1, 3), (1, 5, 5), (1, 6, 9)])
    want = (ops.token_indices(pool.tables[0], 4, 1, 3)
            + ops.token_indices(pool.tables[1], 4, 6, 9))
    assert calls == [(shapes, want, "token")]
    with pytest.raises(ValueError, match="shared"):
        pool.rollback_many([(0, 5, 7), (1, 3, 5)])
    with pytest.raises(ValueError, match="past"):
        pool.rollback_many([(1, 9, 10), (0, 6, 9)])
    assert len(calls) == 1
    pool.rollback_many([(0, 3, 3)])  # nothing to erase: no call
    assert len(calls) == 1
    pool.check_invariants()


class InLoopServer(ContinuousServer):
    """The per-slot erase: each rejected tail is rolled back inside the
    accept loop as soon as it is known, one ``PagePool.rollback`` a slot,
    as the JAX package does; nothing is left for the tick's batched
    call."""

    def _accept(self, *args):
        tail = super()._accept(*args)
        if tail is not None:
            self.pool.rollback(*tail)
        return None


def _pool_bits(srv):
    return [t.view(torch.int32).clone() for p in (srv.pool.pages,
                                                  srv.pool.draft_pages)
            for t in p.values()]


def test_tick_erase_equals_slot_by_slot_erase_every_tick(weights):
    model, params = weights
    reqs = shared_prefix_requests(6, model.cfg.vocab_size, **REQS)
    batched = ContinuousServer(model, params, **SERVER)
    in_loop = InLoopServer(model, params, **SERVER)
    calls = []
    orig = batched.pool.rollback_many

    def spy(ranges):
        calls.append([r for r in ranges if r[2] > r[1]])
        orig(ranges)

    batched.pool.rollback_many = spy
    for srv in (batched, in_loop):
        for r in copy.deepcopy(reqs):
            srv.submit(r)
    ticks = 0
    while batched.queued or any(s is not None for s in batched.slots):
        before = len(calls)
        batched.step()
        in_loop.step()
        ticks += 1
        assert len(calls) <= before + 1  # at most one call a tick
        for a, b in zip(_pool_bits(batched), _pool_bits(in_loop)):
            assert torch.equal(a, b), f"pools differ after tick {ticks}"
    assert not in_loop.queued and all(s is None for s in in_loop.slots)
    assert batched.stats.latencies == in_loop.stats.latencies
    assert batched.stats.spec_accepted == in_loop.stats.spec_accepted
    assert batched.stats.spec_accepted < batched.stats.spec_proposed
    # some tick erased the tails of several slots in its one call
    assert max(len({s for s, _, _ in c}) for c in calls) >= 2
