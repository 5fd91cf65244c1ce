"""Speculative serving of the MoE and VLM families in the port against the
JAX package's, tick for tick: the same requests through both
``ContinuousServer(speculative=True)`` (phi3.5-moe, qwen3-moe and qwen2-vl
at their smoke configs, fp32, the JAX weights carried across by
``params_from_jax``) give the same tokens and the same record (proposals,
acceptances, latencies, clock, decode steps, slot tokens), for a 1-layer
early-exit draft and the self-draft, one case over prefix sharing, and the
two MoE archs at the smoke capacity factor 4.0 (dropless) and at the
published 1.25.

At 1.25 the MoE layer drops picks: the verify chunk routes spec_k rows a
slot, where plain decoding routes one, so capacity drops other picks and
the speculative tokens are held to JAX's scheduler, not to plain
decoding. At 4.0 nothing drops and they equal the port's plain continuous
tokens too. One bf16 case (phi3.5-moe computing in bf16) is held by
``tests/test_torch_bf16_serving.py``'s gates: logits within 0.1 token by
token, tokens parting only at a near-tie of JAX's margin."""
import dataclasses

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
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import dispatch
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import (ContinuousServer,
                                         shared_prefix_requests)

PHI, QWEN3, VL = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                  "qwen2-vl-72b")
REQS = dict(n_groups=2, prefix_len=8, tail_min=1, tail_max=12,
            max_new_low=2, max_new_high=8, seed=5)
N_REQS = 6
SERVER = dict(max_batch=3, max_len=64, page_size=4, prefill_chunk=8)
SPEC_K = 4
# the published capacity factor of both MoE archs; the smoke configs' 4.0
# is dropless (capacity T * K / E * 4 >= T)
PUBLISHED_CF = 1.25
BF16 = torch.bfloat16
# tests/test_torch_bf16_serving.py's gates: bf16 logits within 0.1 of
# JAX's, tokens parting only where JAX's own top-2 margin is within 0.2
LOGIT_ATOL = 0.1
TIE = 2 * LOGIT_ATOL


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch: str, cf):
    """(JAX config, port config) of ``arch``'s smoke size, at capacity
    factor ``cf`` (None: the smoke config's)."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    return jcfg, cfg


_WEIGHTS: dict = {}


def _weights(arch: str):
    """JAX's init (key 0) of the smoke config as a numpy tree, built once
    an arch: the capacity factor changes no weight."""
    if arch not in _WEIGHTS:
        jm = jax_build_model(jax_smoke_config(arch),
                             compute_dtype=jnp.float32)
        _WEIGHTS[arch] = jax.tree.map(np.asarray,
                                      jm.init(jax.random.PRNGKey(0)))
    return _WEIGHTS[arch]


def _models(arch: str, cf, compute=(jnp.float32, torch.float32)):
    """(JAX model, JAX params, port model, port params) at ``cf``, both
    computing in ``compute`` over fp32 weights."""
    jcfg, cfg = _configs(arch, cf)
    tree = _weights(arch)
    jm = jax_build_model(jcfg, compute_dtype=compute[0])
    jp = jax.tree.map(jnp.asarray, tree)
    return (jm, jp, build_model(cfg, "cpu", compute_dtype=compute[1]),
            params_from_jax(tree, cfg, "cpu"))


def _record(srv, reqs):
    s = srv.stats
    return ({r.rid: list(r.generated) for r in reqs},
            {"spec_proposed": s.spec_proposed,
             "spec_accepted": s.spec_accepted, "latencies": s.latencies,
             "clock": srv.clock, "decode_steps": s.decode_steps,
             "useful_tokens": s.useful_tokens, "slot_tokens": s.slot_tokens,
             "shared_prompt_tokens": s.shared_prompt_tokens})


def _drain(srv, reqs, check=False):
    for r in reqs:
        srv.submit(r)
    while srv.queued or any(s is not None for s in srv.slots):
        srv.step()
        if check:
            srv.pool.check_invariants()
    return srv


CASES = [
    # arch, draft_layers, prefix sharing, capacity factor
    (PHI, 1, False, None),
    (PHI, None, False, None),
    (PHI, 1, False, PUBLISHED_CF),
    (PHI, None, False, PUBLISHED_CF),
    (QWEN3, 1, False, None),
    (QWEN3, None, False, None),
    (QWEN3, 1, False, PUBLISHED_CF),
    (QWEN3, None, False, PUBLISHED_CF),
    (QWEN3, 1, True, PUBLISHED_CF),
    (VL, 1, False, None),
    (VL, None, False, None),
]


@pytest.mark.parametrize(
    "arch,draft_layers,share,cf", CASES,
    ids=[f"{a.split('-')[0]}-d{d}-{'share' if s else 'noshare'}-cf{c}"
         for a, d, s, c in CASES])
def test_speculative_matches_jax_tick_for_tick(arch, draft_layers, share, cf,
                                               monkeypatch):
    jm, jp, model, params = _models(arch, cf)
    kw = dict(SERVER, speculative=True, spec_k=SPEC_K,
              draft_layers=draft_layers, prefix_sharing=share)
    j_reqs = jax_shared_prefix_requests(N_REQS, model.cfg.vocab_size, **REQS)
    jsrv = _drain(JaxContinuousServer(jm, jp, **kw), j_reqs)

    dropped = []
    if model.cfg.is_moe():
        route = moe.route

        def spy(*a, **k):
            out = route(*a, **k)
            dropped.append(int((~out[-1]).sum()))
            return out

        monkeypatch.setattr(moe, "route", spy)
    reqs = shared_prefix_requests(N_REQS, model.cfg.vocab_size, **REQS)
    srv = ContinuousServer(model, params, **kw)
    rollbacks = []
    orig = srv.pool.rollback_many

    def one_erase_a_tick(ranges):
        rollbacks.append(sum(end > start for _, start, end in ranges))
        orig(ranges)

    srv.pool.rollback_many = one_erase_a_tick
    before = dispatch.launch_counts()
    _drain(srv, reqs, check=True)
    assert dispatch.launch_counts() == before  # CPU: plain versions only

    tokens, record = _record(srv, reqs)
    assert (tokens, record) == _record(jsrv, j_reqs)
    assert record["spec_proposed"] > 0
    assert record["latencies"] and record["clock"] > 0
    if draft_layers == 1:
        # an early-exit draft is rejected somewhere: ticks with a tail to
        # erase from both pools, in one call a tick
        assert record["spec_accepted"] < record["spec_proposed"]
        assert max(rollbacks) > 0
    if share:
        assert record["shared_prompt_tokens"] > 0
    if model.cfg.is_moe() and cf == PUBLISHED_CF:
        assert sum(dropped) > 0, "1.25 must drop picks"
    elif model.cfg.is_moe():
        assert sum(dropped) == 0, "the smoke capacity is dropless"
        plain = shared_prefix_requests(N_REQS, model.cfg.vocab_size, **REQS)
        _drain(ContinuousServer(model, params, **SERVER), plain)
        assert {r.rid: list(r.generated) for r in plain} == tokens


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top[1] - top[0])


def test_speculative_bf16_matches_jax_up_to_near_ties():
    """phi3.5-moe computing in bf16 over fp32 weights at the published
    capacity, a 1-layer draft: the logit traces held token by token within
    LOGIT_ATOL, a request's tokens parting only at a near-tie of JAX's
    margin (not compared past it), as the bf16 serving tests hold the
    dense family's."""
    jm, jp, model, params = _models(PHI, PUBLISHED_CF,
                                    (jnp.bfloat16, BF16))
    kw = dict(SERVER, speculative=True, spec_k=SPEC_K, draft_layers=1,
              trace_logits=True)
    j_reqs = jax_shared_prefix_requests(N_REQS, model.cfg.vocab_size, **REQS)
    t_reqs = shared_prefix_requests(N_REQS, model.cfg.vocab_size, **REQS)
    jsrv = _drain(JaxContinuousServer(jm, jp, **kw), j_reqs)
    tsrv = _drain(ContinuousServer(model, params, **kw), t_reqs)
    assert tsrv.stats.spec_proposed > 0
    compared = 0
    for rj, rt in zip(j_reqs, t_reqs):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        jt, tt = jsrv.logit_trace[rj.rid], tsrv.logit_trace[rt.rid]
        for j, (a, b) in enumerate(zip(jt[:len(rj.generated)], tt)):
            np.testing.assert_allclose(
                np.asarray(b, np.float32), np.asarray(a, np.float32),
                atol=LOGIT_ATOL, rtol=0, err_msg=f"rid {rt.rid} token {j}")
            compared += 1
            if rt.generated[j] != rj.generated[j]:
                assert _margin(a) <= TIE, (rt.rid, j, _margin(a))
                break
        else:
            assert rt.generated == rj.generated
    assert compared > 20
