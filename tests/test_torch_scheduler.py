"""The port's continuous-batching scheduler against the JAX package's, tick
for tick: the same requests through both servers (qwen2.5-3b smoke config,
fp32, JAX weights carried across) must produce the same tokens and the same
scheduling record — admission order under DRR weights and tenant caps,
preemption under page-pool pressure, prefix sharing — plus the port's own
isolation probes (cross-tenant prefix, refcount balance at every tick)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.server import Request as JaxRequest
from repro.runtime.serving import ContinuousServer as JaxContinuousServer
from repro.runtime.serving import \
    shared_prefix_requests as jax_shared_prefix_requests
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import (ContinuousServer, Request,
                                         shared_prefix_requests)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def servers():
    """kind -> (server class, model, params, Request, shared_prefix_requests)
    for the JAX package and the port, from one set of weights."""
    jmodel = jax_build_model(jax_smoke_config(ARCH), compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return {"jax": (JaxContinuousServer, jmodel, jparams, JaxRequest,
                    jax_shared_prefix_requests),
            "torch": (ContinuousServer, build_model(cfg, "cpu"), tparams,
                      Request, shared_prefix_requests)}


def _bursty(Req, vocab):
    rng = np.random.RandomState(21)
    reqs = [Req(rid=i, prompt=rng.randint(0, vocab, 5 + i).tolist(),
                max_new_tokens=4, tenant="burst") for i in range(3)]
    reqs.append(Req(rid=3, prompt=rng.randint(0, vocab, 6).tolist(),
                    max_new_tokens=4, tenant="other"))
    return reqs


def _weighted(Req, vocab):
    rng = np.random.RandomState(41)
    return [Req(rid=2 * i + j, prompt=rng.randint(0, vocab, 6).tolist(),
                max_new_tokens=3 + (i % 3), tenant=t)
            for i in range(6) for j, t in enumerate(("a", "b"))]


def _priorities(Req, vocab):
    rng = np.random.RandomState(61)
    lows = [Req(rid=i, prompt=rng.randint(0, vocab, 10).tolist(),
                max_new_tokens=6, priority=0) for i in range(2)]
    hi = Req(rid=9, prompt=rng.randint(0, vocab, 10).tolist(),
             max_new_tokens=6, priority=5)
    return lows, [hi]  # the high-priority request arrives one tick late


SCENARIOS = {
    # tenant cap of 1 on a 3-request burst beside another tenant
    "tenant_cap": (dict(max_batch=3, max_len=32, page_size=4,
                        prefill_chunk=8, max_slots_per_tenant=1),
                   lambda Req, V, spr: (_bursty(Req, V), [])),
    # DRR admission at weights 2:1
    "drr_weights": (dict(max_batch=3, max_len=32, page_size=4,
                         prefill_chunk=8, tenant_weights={"a": 2.0, "b": 1.0}),
                    lambda Req, V, spr: (_weighted(Req, V), [])),
    # 8 pages: the two lows fill the pool, the late high preempts one
    "preemption": (dict(max_batch=3, max_len=32, page_size=4,
                        prefill_chunk=4, n_pages=8),
                   lambda Req, V, spr: _priorities(Req, V)),
    # two tenants' templates through a prefix-sharing pool
    "prefix_sharing": (dict(max_batch=2, max_len=48, page_size=4,
                            prefill_chunk=4, prefix_sharing=True),
                       lambda Req, V, spr: (spr(8, V, n_groups=2, prefix_len=8,
                                                tail_min=1, tail_max=8,
                                                max_new_low=2, max_new_high=5,
                                                seed=3), [])),
}


def _run(kind, servers, scenario):
    Server, model, params, Req, spr = servers[kind]
    kw, make = SCENARIOS[scenario]
    first, late = make(Req, model.cfg.vocab_size, spr)
    srv = Server(model, params, **kw)
    for r in first:
        srv.submit(r)
    srv.step()
    for r in late:
        srv.submit(r)
    srv.run_until_drained()
    s = srv.stats
    return srv, {r.rid: list(r.generated) for r in first + late}, {
        "latencies": s.latencies, "preemptions": s.preemptions,
        "shared_prompt_tokens": s.shared_prompt_tokens,
        "decode_steps": s.decode_steps, "useful_tokens": s.useful_tokens,
        "slot_tokens": s.slot_tokens, "clock": srv.clock}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_matches_jax_tick_for_tick(servers, scenario):
    _, j_tokens, j_stats = _run("jax", servers, scenario)
    srv, t_tokens, t_stats = _run("torch", servers, scenario)
    assert t_tokens == j_tokens
    assert t_stats == j_stats
    srv.pool.check_invariants()
    if scenario == "preemption":
        assert t_stats["preemptions"] == 1
    if scenario == "prefix_sharing":
        assert t_stats["shared_prompt_tokens"] > 0


def test_tenant_cap_holds_every_tick(servers):
    Server, model, params, Req, _ = servers["torch"]
    srv = Server(model, params, max_batch=3, max_len=32, page_size=4,
                 prefill_chunk=8, max_slots_per_tenant=1)
    reqs = _bursty(Req, model.cfg.vocab_size)
    for r in reqs:
        srv.submit(r)
    while srv.queued or any(s is not None for s in srv.slots):
        srv.step()
        assert srv._tenant_slots("burst") <= 1
        srv.pool.check_invariants()
    assert all(r.done for r in reqs)


def test_cross_tenant_identical_prompt_never_shares(servers):
    """An identical prompt from a DIFFERENT tenant gets no shared page,
    none of the index's pages, and logits BIT-equal to a fresh server;
    the owning tenant's repeat does share (the probe is sharp)."""
    Server, model, params, Req, _ = servers["torch"]
    prompt = np.random.RandomState(33).randint(0, model.cfg.vocab_size,
                                               17).tolist()
    mk = lambda rid, tenant: Req(rid=rid, prompt=list(prompt),
                                 max_new_tokens=4, tenant=tenant)
    kw = dict(max_batch=1, max_len=32, page_size=4, prefill_chunk=8,
              trace_logits=True)
    srv = Server(model, params, n_pages=16, prefix_sharing=True, **kw)
    srv.submit(mk(0, "alice"))
    srv.run_until_drained()
    index_pages = set(srv.pool._prefix_index.values())
    assert index_pages
    srv.submit(mk(1, "mallory"))
    srv.step()
    assert srv.pool.slot_shared_pages(0) == []
    assert not set(srv.pool.slot_pages(0)) & index_pages
    srv.run_until_drained()
    fresh = Server(model, params, **kw)
    fresh.submit(mk(1, "mallory"))
    fresh.run_until_drained()
    assert len(srv.logit_trace[1]) == len(fresh.logit_trace[1]) == 4
    for got, want in zip(srv.logit_trace[1], fresh.logit_trace[1]):
        np.testing.assert_array_equal(got, want)  # BIT equality
    srv.submit(mk(2, "alice"))
    srv.step()
    assert srv.pool.slot_shared_pages(0)
    assert set(srv.pool.slot_shared_pages(0)) <= index_pages
    srv.run_until_drained()
    srv.pool.check_invariants()


def test_drain_budget_marks_a_truncated_trace(servers):
    Server, model, params, Req, _ = servers["torch"]
    rng = np.random.RandomState(51)
    srv = Server(model, params, max_batch=2, max_len=32, page_size=4,
                 prefill_chunk=4)
    for i in range(4):
        srv.submit(Req(rid=i, prompt=rng.randint(0, model.cfg.vocab_size,
                                                 8).tolist(),
                       max_new_tokens=6))
    with pytest.warns(RuntimeWarning, match="truncated"):
        assert srv.run_until_drained(max_steps=2).drained is False
    stats = srv.run_until_drained()
    assert stats.drained and len(stats.latencies) == 4
