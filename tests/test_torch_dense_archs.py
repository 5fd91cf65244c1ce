"""The other dense archs: stablelm-3b (d_head 80, partial rotary, QKV bias)
and phi3-mini-3.8b (d_head 96), and mistral-large-123b's config, against the
JAX package. The configs equal JAX's field by field; the smoke configs'
forward (the loss), direct serving (prefill, then decode) and continuous
serving (chunked prefill and paged decode, the logits traced) give JAX's
numbers from the JAX weights carried across by ``params_from_jax``; the
port's continuous output equals its wave output; and the attention kernels'
plain versions at the new widths, d_head 80 and 96, give the Pallas
kernels' output in interpret mode (the CUDA kernels are held to those plain
versions on the card, in ``chip_smoke.py``). With the MHA widths (Hkv 32),
the paged wrapper's split plan at the serving shapes is pinned.

Tolerances: fp32 in both packages, sums in another order; logits (up to
about 4 at smoke width) and attention outputs held to 1e-5 absolute and
relative, as ``tests/test_torch_serving.py`` and the attention tests hold
the qwen2.5-3b slice and the kernels (measured below 5e-6 here).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.paged_attention.paged_attention import \
    paged_attention_pallas
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serving import ContinuousServer as JaxContinuousServer
from repro.runtime.serving import zipf_requests as jax_zipf_requests
from repro_torch import api
from repro_torch.configs import (PORTED, get_config, get_smoke_config,
                                 resolve_arch)
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.kernels.paged_attention.paged_attention import plan
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import ContinuousServer, zipf_requests


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = RTOL = 1e-5
ARCHS = ("stablelm-3b", "phi3-mini-3.8b")
NEW = ARCHS + ("mistral-large-123b",)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """(arch, JAX model, JAX params, port config, port params): one JAX
    init in fp32, the port's copy carried across through numpy."""
    arch = request.param
    jmodel = jax_build_model(jax_smoke_config(arch), compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return arch, jmodel, jparams, cfg, tparams


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_jax_field_by_field(arch):
    assert arch in PORTED and resolve_arch(arch.replace("-", "_")) == arch
    for port, jax_cfg in ((get_config(arch), jax_config(arch)),
                          (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    full = get_config(arch)
    want = {"stablelm-3b": (32, 2560, 32, 32, 80, 6912, 50304),
            "phi3-mini-3.8b": (32, 3072, 32, 32, 96, 8192, 32064),
            "mistral-large-123b": (88, 12288, 96, 8, 128, 28672, 32768)}
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.d_ff, full.vocab_size) == want[arch]


def test_every_ported_arch_builds_its_smoke_model():
    assert set(PORTED) == {"mistral-large-123b", "stablelm-3b",
                           "phi3-mini-3.8b", "qwen2.5-3b", "rwkv6-7b",
                           "zamba2-7b", "phi3.5-moe-42b-a6.6b",
                           "qwen3-moe-235b-a22b", "qwen2-vl-72b",
                           "hubert-xlarge"}
    for arch in PORTED:
        assert api.Session.from_config(arch, device="cpu").cfg == \
            get_smoke_config(arch)


def test_weights_carry_across_and_back(weights):
    """Every JAX leaf, the QKV biases of stablelm-3b among them, lands in
    the port's module and comes back unchanged."""
    arch, _, jparams, cfg, tparams = weights
    want = jax.tree.map(np.asarray, jparams)
    got = params_to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert ("bq" in want["layers"]["attn"]) == cfg.qkv_bias == \
        (arch == "stablelm-3b")


def test_loss_matches_jax(weights):
    arch, jmodel, jparams, cfg, tparams = weights
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tbatch = {k: torch.as_tensor(np.array(v), dtype=torch.long)
              for k, v in jbatch.items()}
    model = build_model(cfg, "cpu")
    np.testing.assert_allclose(float(model.loss(tparams, tbatch)),
                               float(jmodel.loss(jparams, jbatch)),
                               rtol=RTOL)


def test_direct_serve_matches_jax(weights):
    arch, _, jparams, cfg, tparams = weights
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 11))
    want = JaxSession.from_config(arch).serve(
        prompt=jnp.asarray(prompt, jnp.int32), params=jparams,
        max_new_tokens=6)
    got = api.Session.from_config(arch, device="cpu").serve(
        prompt=prompt, params=tparams, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=ATOL, rtol=RTOL)


def test_paged_decode_matches_jax(weights):
    """Continuous serving, more requests than slots: the chunked prefills
    and paged decode steps' logits, request by request, and the tokens."""
    arch, jmodel, jparams, cfg, tparams = weights
    kw = dict(min_len=3, max_len=16, max_new_low=2, max_new_high=6, seed=4)
    j_reqs = jax_zipf_requests(5, cfg.vocab_size, **kw)
    t_reqs = zipf_requests(5, cfg.vocab_size, **kw)
    srv = dict(max_batch=2, max_len=32, page_size=4, prefill_chunk=4,
               trace_logits=True)

    def trace(server, reqs):
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
        return server.logit_trace

    j_trace = trace(JaxContinuousServer(jmodel, jparams, **srv), j_reqs)
    t_trace = trace(ContinuousServer(build_model(cfg, "cpu"), tparams, **srv),
                    t_reqs)
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.generated == rj.generated, f"{arch} rid {rt.rid} diverged"
        assert len(t_trace[rt.rid]) == len(j_trace[rj.rid])
        for got, want in zip(t_trace[rt.rid], j_trace[rj.rid]):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_continuous_equals_wave(weights):
    arch, _, _, cfg, tparams = weights
    sess = api.Session.from_config(arch, device="cpu")
    reqs = zipf_requests(6, cfg.vocab_size, min_len=3, max_len=16,
                         max_new_low=2, max_new_high=6, seed=2)
    before = dispatch.launch_counts()
    out = {}
    for kind in ("wave", "continuous"):
        res = sess.serve(scheduler=kind, requests=copy.deepcopy(reqs),
                         params=tparams, max_batch=3, max_len=32,
                         page_size=4, prefill_chunk=4)
        assert res.stats.drained and len(res.stats.latencies) == len(reqs)
        out[kind] = res.tokens
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    np.testing.assert_array_equal(out["wave"], out["continuous"])


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_flash_plain_matches_pallas_at_new_widths(D, Hq, Hkv):
    rng = np.random.default_rng(D)
    q, k, v = _normal(rng, 2, 16, Hq, D), _normal(rng, 2, 16, Hkv, D), \
        _normal(rng, 2, 16, Hkv, D)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    got = flash_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("C,q_start", [(1, [9, 30, -1]), (4, [0, 17, 28]),
                                       (8, [5, 24, 8])])
def test_paged_plain_and_split_match_pallas_at_new_widths(D, C, q_start):
    """MHA (Hq = Hkv = 4) pages of 8 tokens, 4 a slot: the plain version
    and the kernel's split algorithm (``paged_attention_split_ref``, the
    CUDA kernel's order of sums) against the Pallas kernel."""
    rng = np.random.default_rng(C)
    B, H, N, P, nP = 3, 4, 12, 8, 4
    q, kp, vp = _normal(rng, B, C, H, D), _normal(rng, N, P, H, D), \
        _normal(rng, N, P, H, D)
    tables = np.stack([rng.permutation(N)[:nP] for _ in range(B)]
                      ).astype(np.int32)
    qs = np.asarray(q_start, np.int32)
    want = np.asarray(paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(qs), interpret=True))
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, qs)]
    got = paged_ops.paged_attention(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    for splits in (1, 2, 4):
        split = paged_ref.paged_attention_split_ref(*args, splits=splits)
        np.testing.assert_allclose(split.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("C,rows,splits", [(1, 8, 3), (4, 8, 3),
                                           (16, 16, 3)])
def test_paged_plan_at_the_mha_serving_shapes(C, rows, splits):
    """4 slots, 32 kv heads (stablelm-3b, phi3-mini-3.8b), pages of 16
    tokens, 32 a slot, 132 SMs: a decode step's one folded row takes a row
    tile of 8 (7 rows padding), 128 tiles, 3 page runs each."""
    assert plan(4, 32, C, 32, 16, 132) == (rows, splits)
