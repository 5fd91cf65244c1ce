"""Speculative serving in the port against the JAX package's, tick for tick:
the same requests through both ``ContinuousServer(speculative=True)``
(qwen2.5-3b smoke config, fp32, the JAX weights carried across by
``params_from_jax``) must give the same tokens and the same record
(proposals, acceptances, latencies, clock, decode steps, slot tokens) for a
self-draft, a 1-layer early-exit draft and a self-draft over prefix sharing,
as ``tests/test_serving.py`` picks them; and the port's speculative tokens
must equal its plain scheduler's. Plus the draft pool's isolation, the
draft's shared weights, and the entry points."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serving import ContinuousServer as JaxContinuousServer
from repro.runtime.serving import \
    shared_prefix_requests as jax_shared_prefix_requests
from repro_torch import api
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import (ContinuousServer, PagePool,
                                         shared_prefix_requests)
from repro_torch.runtime.serving.scheduler import _draft_of

ARCH = "qwen2.5-3b"
REQS = dict(n_groups=2, prefix_len=8, tail_min=1, tail_max=12,
            max_new_low=2, max_new_high=8, seed=5)
SERVER = dict(max_batch=3, max_len=64, page_size=4, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX model, JAX params, port model, port params) from one init."""
    jmodel = jax_build_model(jax_smoke_config(ARCH), compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, "cpu"), tparams


@pytest.fixture(scope="module")
def plain_tokens(weights):
    """The port's plain continuous scheduler on the same requests."""
    _, _, model, params = weights
    reqs = shared_prefix_requests(8, model.cfg.vocab_size, **REQS)
    srv = ContinuousServer(model, params, **SERVER)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return {r.rid: r.generated for r in reqs}


def _record(srv, reqs):
    s = srv.stats
    return ({r.rid: list(r.generated) for r in reqs},
            {"spec_proposed": s.spec_proposed,
             "spec_accepted": s.spec_accepted, "latencies": s.latencies,
             "clock": srv.clock, "decode_steps": s.decode_steps,
             "useful_tokens": s.useful_tokens, "slot_tokens": s.slot_tokens,
             "shared_prompt_tokens": s.shared_prompt_tokens})


@pytest.mark.parametrize("draft_layers,share", [
    (None, False),   # self-draft
    (1, False),      # early-exit draft: rejections, so rollbacks
    (None, True),    # over prefix sharing
])
def test_speculative_matches_jax_tick_for_tick(weights, plain_tokens,
                                               draft_layers, share):
    jmodel, jparams, model, params = weights
    kw = dict(SERVER, speculative=True, spec_k=4, draft_layers=draft_layers,
              prefix_sharing=share)
    j_reqs = jax_shared_prefix_requests(8, model.cfg.vocab_size, **REQS)
    jsrv = JaxContinuousServer(jmodel, jparams, **kw)
    for r in j_reqs:
        jsrv.submit(r)
    jsrv.run_until_drained()

    reqs = shared_prefix_requests(8, model.cfg.vocab_size, **REQS)
    srv = ContinuousServer(model, params, **kw)
    rollbacks = []
    orig = srv.pool.rollback_many

    def spy(ranges):
        """One call a tick; no rolled-back position lies on a page its slot
        shares."""
        for slot, start, end in ranges:
            pages = set(srv.pool.tables[slot][start // 4:-(-end // 4)]
                        .tolist())
            assert not pages & set(srv.pool.slot_shared_pages(slot))
            rollbacks.append(end - start)
        orig(ranges)

    srv.pool.rollback_many = spy
    for r in reqs:
        srv.submit(r)
    while srv.queued or any(s is not None for s in srv.slots):
        srv.step()
        srv.pool.check_invariants()

    tokens, record = _record(srv, reqs)
    assert (tokens, record) == _record(jsrv, j_reqs)
    assert tokens == plain_tokens
    assert record["spec_proposed"] > 0 and rollbacks
    if draft_layers == 1:
        assert record["spec_accepted"] < record["spec_proposed"]
    if share:
        assert record["shared_prompt_tokens"] > 0


def test_admission_zeroes_both_pools_and_rollback_erases_both(weights):
    _, _, model, params = weights
    draft_model, _ = _draft_of(model, params, 1)
    pool = PagePool(model, n_slots=1, n_pages=4, page_size=4,
                    pages_per_slot=4, draft_model=draft_model)
    assert pool.draft_pages["k_pages"].shape[0] == 1
    assert pool.alloc(0, 4)
    owned = pool.slot_pages(0)
    pools = (pool.pages, pool.draft_pages)
    for p in pools:
        for t in p.values():
            t.fill_(1.5)  # a previous tenant's K/V
    pool.rollback(0, 5, 7)
    row = pool.tables[0]
    for p in pools:
        for t in p.values():
            assert (t[:, row[1], 1:3] == 0).all()
            assert int((t == 0).sum()) == 2 * t.shape[0] * t[0, 0, 0].numel()
    with pytest.raises(ValueError, match="past"):
        pool.rollback(0, 14, 17)
    pool.release(0)
    assert pool.alloc(0, 4)
    assert set(pool.slot_pages(0)) == set(owned)
    for p in pools:
        for t in p.values():
            assert (t[:, owned] == 0).all()
    pool.check_invariants()


def test_rollback_refuses_a_shared_page(weights):
    _, _, model, params = weights
    pool = PagePool(model, n_slots=2, n_pages=8, page_size=4,
                    pages_per_slot=4, prefix_index=True)
    assert pool.alloc(0, 2)
    assert pool.alloc(1, 3, shared=pool.slot_pages(0)[:1])
    with pytest.raises(ValueError, match="shared"):
        pool.rollback(1, 3, 6)
    pool.rollback(1, 4, 6)


def test_draft_shares_the_targets_tensors(weights):
    _, _, model, params = weights
    n = model.cfg.n_layers
    draft_model, draft = _draft_of(model, params, 1)
    assert draft_model.cfg.n_layers == 1 and len(draft.layers) == 1
    assert draft.layers[0] is params.layers[0]
    assert draft.layers[0].attn.wq.data_ptr() == \
        params.layers[0].attn.wq.data_ptr()
    assert draft.embed.data_ptr() == params.embed.data_ptr()
    assert draft.ln_f.scale.data_ptr() == params.ln_f.scale.data_ptr()
    assert draft.head().data_ptr() == params.head().data_ptr()
    assert len(params.layers) == n  # the target keeps every layer
    self_model, self_draft = _draft_of(model, params, None)
    assert self_draft is params and self_model.cfg.n_layers == n


def test_bad_speculative_settings_raise(weights):
    _, _, model, params = weights
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousServer(model, params, speculative=True, spec_k=1)
    for bad in (0, model.cfg.n_layers + 1):
        with pytest.raises(ValueError, match="out of range"):
            ContinuousServer(model, params, speculative=True,
                             draft_layers=bad)
    sess = api.Session.from_config(ARCH, device="cpu")
    for kw in ({"speculative": True}, {"speculative": True,
                                       "scheduler": "wave", "requests": []}):
        with pytest.raises(ValueError, match="continuous"):
            sess.serve(params=params, **kw)


def test_cli_serves_speculatively_on_cpu(capsys):
    before = dispatch.launch_counts()
    res = serve_cli.main(["--device", "cpu", "--scheduler", "continuous",
                          "--speculative", "--draft-layers", "1",
                          "--batch", "3", "--prompt-len", "6", "--tokens",
                          "4", "--max-batch", "2"])
    assert res.tokens.shape == (3, 4) and res.stats.spec_proposed > 0
    assert "acceptance" in capsys.readouterr().out
    assert dispatch.launch_counts() == before  # CPU: plain versions only
