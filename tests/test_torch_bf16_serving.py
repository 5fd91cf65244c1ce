"""bf16 serving: the port against the JAX package at the qwen2.5-3b smoke
config with both packages computing in bf16, JAX's weights carried across
by ``params_from_jax``, as fp32 weights (cast in the forward pass, as in
both packages) and as bf16 weights (``build_model(param_dtype=bf16)`` in
both). Direct, wave, continuous and speculative serving emit JAX's tokens
wherever JAX's top-2 logit margin clears twice the logit tolerance, with
logits within that tolerance up to a request's first near-tie. And each
attention or page-pool kernel's plain version at bf16, against JAX's Pallas
kernel in interpret mode and against its own fp32 run on the widened
inputs. The CUDA kernels' bf16 instantiations are held to these plain
versions on the card by ``chip_smoke.py --bf16`` and
``tests/test_torch_cuda_kernels.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.paged_attention.paged_attention import (
    paged_attention_pallas, paged_reset_pallas, paged_rollback_pallas)
from repro.models.registry import build_model as jax_build_model
from repro.runtime.server import WaveServer as JaxWaveServer
from repro.runtime.serving import ContinuousServer as JaxContinuousServer
from repro.runtime.serving import zipf_requests as jax_zipf_requests
from repro_torch.api import Session
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.runtime.server import WaveServer
from repro_torch.runtime.serving import ContinuousServer, zipf_requests


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2.5-3b"
BF16 = torch.bfloat16
# bf16 logits, port against JAX: bf16 rounds at other places in the two
# frameworks (products, norms, the attention's casts). Measured max |diff|
# up to each request's first near-tie, |logit| up to 3.6, four weight
# seeds: direct 0.042, continuous and speculative 0.035-0.040 (each
# package's bf16 logits lie 0.041 / 0.053 from its own fp32 logits); the
# bound is 2.4x the largest
LOGIT_ATOL = 0.1
# a request's tokens may part where JAX's top-2 margin is within twice the
# tolerance (measured there: 0.016-0.031); past that point the two
# continue from different prefixes and are not compared
TIE = 2 * LOGIT_ATOL
# the flash kernel's plain version against JAX's Pallas kernel, both in
# bf16 out: tests/test_kernels.py's bf16 bound for the Pallas kernel
FLASH_BF16_TOL = 2e-2
# paged attention returns fp32 in both: the fp32 bound of
# tests/test_torch_paged_attention.py
PAGED_ATOL = PAGED_RTOL = 1e-5


@pytest.fixture(scope="module", params=["f32", "bf16"])
def weights(request):
    """(JAX model, JAX params, port model, port params) computing in bf16,
    with fp32 or bf16 weights; numpy has no bf16, so JAX's bf16 leaves
    cross as fp32 arrays (bf16 to fp32 is exact) and the port rounds them
    back."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, BF16)}[request.param]
    jmodel = jax_build_model(jax_smoke_config(ARCH), param_dtype=jdt,
                             compute_dtype=jnp.bfloat16)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = params_from_jax(tree, cfg, "cpu", dtype=tdt)
    assert all(p.dtype == tdt for p in tparams.parameters())
    model = build_model(cfg, "cpu", param_dtype=tdt, compute_dtype=BF16)
    return jmodel, jparams, model, tparams


def _session(model):
    """A port Session over a ready model, as JAX wraps
    ``build_model(param_dtype=...)``."""
    return Session(cfg=model.cfg, run_cfg=RunConfig(model=model.cfg),
                   model=model, device=model.device)


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top[1] - top[0])


def test_bf16_session_builds_bf16_caches_and_pools():
    sess = Session.from_config(ARCH, compute_dtype=BF16, device="cpu")
    assert sess.model.compute_dtype == BF16
    cache = sess.model.init_cache(2, 8)
    pool = sess.model.init_paged_cache(4, 4)
    assert cache["k"].dtype == cache["v"].dtype == BF16
    assert pool["k_pages"].dtype == pool["v_pages"].dtype == BF16
    assert all(p.dtype == torch.float32
               for p in sess.init_params().parameters())


def test_direct_bf16_matches_jax(weights):
    jmodel, jparams, model, tparams = weights
    prompt = np.random.default_rng(3).integers(0, model.cfg.vocab_size,
                                               (3, 11))
    want = JaxSession.from_config(ARCH, compute_dtype=jnp.bfloat16).serve(
        prompt=jnp.asarray(prompt, jnp.int32), params=jparams,
        max_new_tokens=6)
    got = _session(model).serve(prompt=prompt, params=tparams,
                                max_new_tokens=6)
    assert got.logits.dtype == BF16
    want_logits = np.asarray(want.logits, np.float32)
    # no near-tie on this prompt: every token equal
    assert min(map(_margin, want_logits)) > TIE
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits.float().numpy(), want_logits,
                               atol=LOGIT_ATOL, rtol=0)


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    assert server.stats.drained
    return server


REQ_KW = dict(min_len=3, max_len=16, max_new_low=2, max_new_high=6, seed=4)
SRV_KW = dict(max_batch=2, max_len=32, page_size=4, prefill_chunk=4)


class _WaveTrace:
    """A wave server's logits row by row, keyed by the row's prompt, from
    its prefill and decode calls (neither package's WaveServer traces
    them)."""

    def __init__(self):
        self.rows: dict = {}
        self._wave: list = []

    def prefill(self, prompts, logits) -> None:
        self._wave = [self.rows.setdefault(p.tobytes(), []) for p in
                      np.asarray(prompts).astype(np.int32)]
        self.decode(logits)

    def decode(self, logits) -> None:
        for row, x in zip(self._wave, np.asarray(logits, np.float32)):
            row.append(x)

    def of(self, req) -> list:
        return self.rows[np.asarray(req.prompt, np.int32).tobytes()]


def _traced_jax_wave(jmodel, jparams, trace: _WaveTrace, **kw):
    srv = JaxWaveServer(jmodel, jparams, **kw)
    prefill, decode = srv._prefill, srv._decode

    def traced_prefill(p, batch, cache):
        logits, cache = prefill(p, batch, cache)
        trace.prefill(batch["tokens"], logits)
        return logits, cache

    def traced_decode(p, batch, cache):
        logits, cache = decode(p, batch, cache)
        trace.decode(logits)
        return logits, cache

    srv._prefill, srv._decode = traced_prefill, traced_decode
    return srv


def _traced_wave(model, params, trace: _WaveTrace, **kw):
    def prefill(p, tokens, cache):
        logits = model.prefill(p, tokens, cache)
        trace.prefill(tokens.cpu().numpy(), logits.float().cpu().numpy())
        return logits

    def decode(p, tokens, cache):
        logits = model.decode_step(p, tokens, cache)
        trace.decode(logits.float().cpu().numpy())
        return logits

    return WaveServer(dataclasses.replace(model, prefill=prefill,
                                          decode_step=decode), params, **kw)


def _compare(j_reqs, t_reqs, j_trace, t_trace) -> tuple:
    """Logits within LOGIT_ATOL token by token; a request's tokens may part
    only where JAX's own top-2 margin is within TIE (a near-tie that bf16's
    different roundings split), and are not compared past it. Returns
    (requests parted at a tie, tokens compared)."""
    ties = compared = 0
    for rj, rt in zip(j_reqs, t_reqs):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        jt, tt = j_trace(rj), t_trace(rt)
        assert len(jt) >= len(rj.generated) and len(tt) >= len(rt.generated)
        for j, (a, b) in enumerate(zip(jt[:len(rj.generated)], tt)):
            np.testing.assert_allclose(b, np.asarray(a, np.float32),
                                       atol=LOGIT_ATOL, rtol=0,
                                       err_msg=f"rid {rt.rid} token {j}")
            compared += 1
            if rt.generated[j] != rj.generated[j]:
                assert _margin(a) <= TIE, (rt.rid, j, _margin(a))
                ties += 1
                break
        else:
            assert rt.generated == rj.generated
    return ties, compared


def test_wave_bf16_matches_jax_up_to_near_ties(weights):
    """The wave servers' logits, recorded at their prefill and decode
    calls, held as the continuous traces are."""
    jmodel, jparams, model, tparams = weights
    # three prompt lengths: JAX compiles a wave's prefill for each
    kw = dict(REQ_KW, min_len=6, max_len=8)
    j_reqs = jax_zipf_requests(7, model.cfg.vocab_size, **kw)
    t_reqs = zipf_requests(7, model.cfg.vocab_size, **kw)
    assert len({r.prompt.tobytes() for r in t_reqs}) == len(t_reqs)
    jt, tt = _WaveTrace(), _WaveTrace()
    _drain(_traced_jax_wave(jmodel, jparams, jt, max_batch=2, max_len=32),
           j_reqs)
    _drain(_traced_wave(model, tparams, tt, max_batch=2, max_len=32), t_reqs)
    _, compared = _compare(j_reqs, t_reqs, jt.of, tt.of)
    assert compared > 20


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["continuous", "speculative"])
def test_continuous_bf16_matches_jax_up_to_near_ties(weights, speculative):
    """The logit traces of ``trace_logits``, held by ``_compare``; this
    trace parts once, at a near-tie."""
    jmodel, jparams, model, tparams = weights
    kw = dict(trace_logits=True, **SRV_KW)
    if speculative:
        kw.update(speculative=True, spec_k=4)
    j_reqs = jax_zipf_requests(7, model.cfg.vocab_size, **REQ_KW)
    t_reqs = zipf_requests(7, model.cfg.vocab_size, **REQ_KW)
    jsrv = _drain(JaxContinuousServer(jmodel, jparams, **kw), j_reqs)
    tsrv = _drain(ContinuousServer(model, tparams, **kw), t_reqs)
    ties, compared = _compare(j_reqs, t_reqs,
                              lambda r: jsrv.logit_trace[r.rid],
                              lambda r: tsrv.logit_trace[r.rid])
    assert ties == 1 and compared > 20


# ---------------------------------------------------------------------------
# each kernel's plain version at bf16


def _bf16(rng, shape) -> np.ndarray:
    """Normal draws rounded to bf16, held as fp32 (exact both ways)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(BF16).float().numpy()


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (2, 32, 4, 2, 16, True),      # the smoke config's prefill
    (1, 48, 4, 4, 112, True),     # zamba2's head dim
    (2, 32, 4, 4, 80, False),     # stablelm-3b's
])
def test_flash_plain_bf16_matches_pallas_and_its_fp32_run(B, S, Hq, Hkv, D,
                                                          causal):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, (B, S, H, D)) for H in (Hq, Hkv, Hkv))
    want = flash_attention_pallas(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        block_q=16, block_k=16, interpret=True)
    assert want.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(BF16) for x in (q, k, v))
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=FLASH_BF16_TOL, rtol=FLASH_BF16_TOL)
    # the plain version widens once and rounds once: its fp32 run on the
    # widened inputs, rounded, bit for bit
    wide = flash_ref.attention_ref(tq.float(), tk.float(), tv.float(),
                                   causal=causal)
    assert torch.equal(got.view(torch.int16),
                       wide.to(BF16).view(torch.int16))


@pytest.mark.parametrize("B,C,Hq,Hkv,D,N,P,nP,q_start", [
    (3, 4, 4, 2, 16, 12, 8, 3, [5, 0, 17]),   # the smoke config: GQA
    (3, 4, 4, 2, 16, 12, 8, 3, [-1, 3, 8]),   # an inactive slot
    (2, 1, 4, 4, 32, 8, 16, 2, [9, 30]),      # decode, MHA
])
def test_paged_attention_plain_bf16_matches_pallas_and_its_fp32_run(
        B, C, Hq, Hkv, D, N, P, nP, q_start):
    rng = np.random.default_rng(2)
    q = _bf16(rng, (B, C, Hq, D))
    kp, vp = (_bf16(rng, (N, P, Hkv, D)) for _ in range(2))
    tables = np.stack([rng.permutation(N)[:nP] for _ in range(B)]
                      ).astype(np.int32)
    qs = np.asarray(q_start, np.int32)
    want = paged_attention_pallas(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(qs), interpret=True)
    assert want.dtype == jnp.float32
    args = [torch.from_numpy(x).to(BF16) for x in (q, kp, vp)]
    idx = [torch.from_numpy(tables), torch.from_numpy(qs)]
    got = paged_ops.paged_attention(*args, *idx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PAGED_ATOL, rtol=PAGED_RTOL)
    wide = paged_ref.paged_attention_ref(*(a.float() for a in args), *idx)
    assert torch.equal(got, wide)


def _pools(L=2, N=6, P=4, H=2, D=8):
    """bf16 pools with negative and NaN lanes: a zeroed lane is +0.0."""
    rng = np.random.default_rng(5)
    k = -torch.from_numpy(_bf16(rng, (L, N, P, H, D))).abs().to(BF16)
    v = torch.from_numpy(_bf16(rng, (L, N, P, H, D))).to(BF16)
    k[:, 2, :, 0] = float("nan")
    return k, v


def _bits(t) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jax_bits(a) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))


def _same_as_wide(got, wide) -> None:
    """``got`` (bf16) bit-equal to the fp32 run ``wide`` rounded, NaN lanes
    aside: a round trip through fp32 keeps a NaN a NaN, not its payload."""
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(wide))
    np.testing.assert_array_equal(_bits(got)[~nan.numpy()],
                                  _bits(wide.to(BF16))[~nan.numpy()])


def _to_jax(t):
    """A bf16 tensor as a JAX bf16 array of the same bits (NaN payloads
    included: the two frameworks' fp32-to-bf16 casts of NaN differ)."""
    return jax.lax.bitcast_convert_type(jnp.asarray(_bits(t)), jnp.bfloat16)


def test_paged_reset_plain_bf16_bit_equal_to_pallas_and_fp32():
    k, v = _pools()
    row = np.array([3, 1, 3, 2], np.int32)
    kj, vj = paged_reset_pallas(_to_jax(k), _to_jax(v), jnp.asarray(row),
                                interpret=True)
    assert kj.dtype == jnp.bfloat16
    kt, vt = k.clone(), v.clone()
    kf, vf = kt.float(), vt.float()
    paged_ops.paged_reset(kt, vt, torch.from_numpy(row))
    paged_ops.paged_reset(kf, vf, torch.from_numpy(row))
    for got, want, wide in ((kt, kj, kf), (vt, vj, vf)):
        assert got.dtype == BF16
        np.testing.assert_array_equal(_bits(got), _jax_bits(want))
        _same_as_wide(got, wide)
    assert (_bits(kt)[:, [1, 2, 3]] == 0).all()


@pytest.mark.parametrize("start,end", [(2, 7), (5, 16), (0, 3), (9, 30)])
def test_paged_rollback_plain_bf16_bit_equal_to_pallas_and_fp32(start, end):
    k, v = _pools()
    P = k.shape[2]
    row = np.array([4, 2, 5, 1], np.int32)
    sp, ep = start // P, -(-min(end, row.size * P) // P)
    bounds = jnp.asarray([start - sp * P, end - sp * P], jnp.int32)
    kj, vj = paged_rollback_pallas(_to_jax(k), _to_jax(v),
                                   jnp.asarray(row[sp:ep]), bounds,
                                   interpret=True)
    kt, vt = k.clone(), v.clone()
    kf, vf = kt.float(), vt.float()
    paged_ops.paged_rollback(kt, vt, torch.from_numpy(row), start, end)
    paged_ops.paged_rollback(kf, vf, torch.from_numpy(row), start, end)
    for got, want, wide in ((kt, kj, kf), (vt, vj, vf)):
        np.testing.assert_array_equal(_bits(got), _jax_bits(want))
        _same_as_wide(got, wide)


def test_page_pool_zeroes_bf16_target_and_draft_pools():
    """``PagePool`` over a bf16 model: both pools in bf16, an admission
    zeroes its fresh pages in both (+0.0), a tick's tails likewise, and the
    pages no event names keep every bit."""
    from repro_torch.runtime.serving import PagePool
    from repro_torch.runtime.serving.scheduler import _draft_of

    sess = Session.from_config(ARCH, compute_dtype=BF16, device="cpu")
    draft_model, _ = _draft_of(sess.model, sess.init_params(), 1)
    pool = PagePool(sess.model, n_slots=2, n_pages=8, page_size=4,
                    pages_per_slot=4, draft_model=draft_model)
    kv = [(p["k_pages"], p["v_pages"]) for p in (pool.pages,
                                                  pool.draft_pages)]
    assert all(t.dtype == BF16 for pair in kv for t in pair)
    for t in (t for pair in kv for t in pair):
        t.fill_(-1.5)
    assert pool.free_pages == 8
    assert pool.alloc(0, 3)
    assert pool.free_pages == 5
    fresh = pool.tables[0, :3].tolist()
    for k, v in kv:
        for t in (k, v):
            assert (_bits(t[:, fresh]) == 0).all()
            rest = [p for p in range(8) if p not in fresh]
            assert (t[:, rest] == -1.5).all()
    for t in (t for pair in kv for t in pair):
        t.fill_(-1.5)
    pool.rollback_many([(0, 5, 9)])
    page, off = fresh[1], 1
    for k, v in kv:
        for t in (k, v):
            assert (_bits(t[:, page, off:]) == 0).all()
            assert (t[:, page, :off] == -1.5).all()
            assert (_bits(t[:, fresh[2], :1]) == 0).all()
            assert (t[:, fresh[2], 1:] == -1.5).all()
