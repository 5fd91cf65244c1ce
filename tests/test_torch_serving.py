"""The serving slice as a whole: the port against the JAX package at the
qwen2.5-3b smoke config in fp32, with the JAX weights carried across by
``params_from_jax``. Direct and continuous serving emit the JAX package's
tokens; the port's continuous output equals its wave output; and the port's
leak-freedom probe (a request admitted into a recycled slot) is bit-equal
to a fresh server."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serving import ContinuousServer as JaxContinuousServer
from repro.runtime.serving import zipf_requests as jax_zipf_requests
from repro_torch import api
from repro_torch.configs import get_config, get_smoke_config, resolve_arch
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.packing import pack_params
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import (ContinuousServer, PagePool, Request,
                                         zipf_requests)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 in both packages at smoke width; logits (magnitude up to about 4)
# differ only by summation order (measured max |diff|: direct 2.5e-6,
# continuous trace 4.1e-6)
LOGIT_ATOL = LOGIT_RTOL = 1e-5

ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def weights():
    """(JAX model, JAX params, port config, port params): one init, the
    port's copy carried across through numpy."""
    jcfg = jax_smoke_config(ARCH)
    jmodel = jax_build_model(jcfg, compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, tparams


@pytest.fixture(scope="module")
def port():
    return api.Session.from_config(ARCH, device="cpu")


def test_smoke_config_matches_jax():
    assert get_smoke_config(ARCH) == get_smoke_config("qwen25_3b")
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab_size", "qkv_bias", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.d_ff, full.vocab_size) == \
        (36, 2048, 16, 2, 128, 11008, 151936)


def test_unported_arch_raises_clearly():
    """Every arch loads now, and bf16 weights pack for training (once
    ROADMAP item 15, which raised here): each weight a view of one packed
    bf16 buffer. An unknown arch raises, naming itself."""
    assert resolve_arch("Qwen2.5_3B") == ARCH
    params = build_model(get_smoke_config(ARCH), "cpu",
                         param_dtype=torch.bfloat16).init(
        torch.Generator().manual_seed(0))
    layout, buf = pack_params(params)
    assert buf.dtype == torch.bfloat16 and buf.shape == (layout.total,)
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               and p.untyped_storage().data_ptr()
               == buf.untyped_storage().data_ptr()
               for p in params.parameters())
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("no-such-model")


def test_direct_serve_matches_jax(weights, port):
    jmodel, jparams, cfg, tparams = weights
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 11))
    want = JaxSession.from_config(ARCH).serve(
        prompt=jnp.asarray(prompt, jnp.int32), params=jparams,
        max_new_tokens=6)
    got = port.serve(prompt=prompt, params=tparams, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def _trace(server, reqs):
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    return server.logit_trace


def test_continuous_serve_matches_jax(weights):
    """More requests than slots, so slots and pages recycle mid-trace."""
    jmodel, jparams, cfg, tparams = weights
    kw = dict(min_len=3, max_len=16, max_new_low=2, max_new_high=6, seed=4)
    j_reqs = jax_zipf_requests(7, cfg.vocab_size, **kw)
    t_reqs = zipf_requests(7, cfg.vocab_size, **kw)
    srv_kw = dict(max_batch=2, max_len=32, page_size=4, prefill_chunk=4,
                  trace_logits=True)
    j_trace = _trace(JaxContinuousServer(jmodel, jparams, **srv_kw), j_reqs)
    model = build_model(cfg, "cpu")
    t_trace = _trace(ContinuousServer(model, tparams, **srv_kw), t_reqs)
    for rj, rt in zip(j_reqs, t_reqs):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        assert rt.generated == rj.generated, f"rid {rt.rid} diverged"
        assert len(t_trace[rt.rid]) == len(j_trace[rj.rid])
        for got, want in zip(t_trace[rt.rid], j_trace[rj.rid]):
            np.testing.assert_allclose(got, want, atol=LOGIT_ATOL,
                                       rtol=LOGIT_RTOL)


@pytest.mark.parametrize("seed,max_batch,chunk", [(0, 2, 4), (2, 3, 7)])
def test_continuous_matches_wave_token_for_token(weights, port, seed,
                                                 max_batch, chunk):
    _, _, cfg, tparams = weights
    reqs = zipf_requests(6, cfg.vocab_size, min_len=3, max_len=16,
                         max_new_low=2, max_new_high=6, seed=seed)
    out = {}
    for kind in ("wave", "continuous"):
        res = port.serve(scheduler=kind, requests=copy.deepcopy(reqs),
                         params=tparams, max_batch=max_batch, max_len=32,
                         page_size=4, prefill_chunk=chunk)
        assert res.stats.drained and len(res.stats.latencies) == len(reqs)
        out[kind] = res.tokens
    np.testing.assert_array_equal(out["wave"], out["continuous"])


def test_recycled_slot_bit_equal_to_fresh_cache(weights):
    """Serve A to completion, admit B into A's recycled slot, and require
    B's logits BIT-equal to a fresh server running B alone: any residue of
    A's K/V reachable through B's block table would perturb the softmax."""
    _, _, cfg, tparams = weights
    model = build_model(cfg, "cpu")
    rng = np.random.RandomState(11)
    prompt_a = rng.randint(0, cfg.vocab_size, 13)
    prompt_b = np.random.RandomState(12).randint(0, cfg.vocab_size, 9)
    mk_a = lambda: Request(rid=0, prompt=prompt_a.copy(), max_new_tokens=6)
    mk_b = lambda: Request(rid=1, prompt=prompt_b.copy(), max_new_tokens=5)
    kw = dict(max_batch=1, max_len=32, page_size=4, prefill_chunk=8,
              trace_logits=True)

    srv = ContinuousServer(model, tparams, **kw)
    srv.submit(mk_a())
    srv.step()
    pages_a = srv.pool.slot_pages(0)
    assert pages_a, "A was not admitted"
    srv.run_until_drained()
    srv.submit(mk_b())
    srv.step()
    assert set(srv.pool.slot_pages(0)) & set(pages_a), "B did not recycle"
    srv.run_until_drained()

    fresh = ContinuousServer(model, tparams, **kw)
    fresh.submit(mk_b())
    fresh.run_until_drained()
    assert len(srv.logit_trace[1]) == len(fresh.logit_trace[1]) == 5
    for got, want in zip(srv.logit_trace[1], fresh.logit_trace[1]):
        np.testing.assert_array_equal(got, want)  # BIT equality


def test_recycling_zeroes_pages_through_the_reset_path(weights):
    """Page contents survive release (the would-be leak) and are zeroed at
    the next admission, before the table row is published."""
    _, _, cfg, tparams = weights
    model = build_model(cfg, "cpu")
    pool = PagePool(model, n_slots=1, n_pages=4, page_size=4,
                    pages_per_slot=4)
    assert pool.alloc(0, 4)
    owned = pool.slot_pages(0)
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 8)))
    with torch.inference_mode():
        model.paged_step(tparams, toks, pool.pages,
                         torch.as_tensor(pool.tables),
                         torch.as_tensor(pool.lengths),
                         torch.full((1,), 8, dtype=torch.int32))
    assert pool.pages["k_pages"][:, owned].abs().sum() > 0
    pool.release(0)
    assert pool.pages["k_pages"][:, owned].abs().sum() > 0  # residue
    assert pool.alloc(0, 4)
    assert set(pool.slot_pages(0)) == set(owned)
    assert (pool.pages["k_pages"][:, owned] == 0).all()
    assert (pool.pages["v_pages"][:, owned] == 0).all()
    pool.check_invariants()


def test_paged_step_matches_dense_forward(weights):
    """Chunked prefill + paged decode over the block-table pool reproduces
    the dense-cache prefill + decode of the same model."""
    _, _, cfg, tparams = weights
    model = build_model(cfg, "cpu")
    T, Tpre, B, P = 12, 8, 2, 4
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, T)))
    with torch.inference_mode():
        cache = model.init_cache(B, T)
        want = [model.prefill(tparams, toks[:, :Tpre], cache)]
        want += [model.decode_step(tparams, toks[:, t:t + 1], cache)
                 for t in range(Tpre, T)]
        pages = model.init_paged_cache(8, P)
        tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
        got, _ = model.paged_step(tparams, toks[:, :Tpre], pages, tables,
                                  torch.zeros(B, dtype=torch.int32),
                                  torch.full((B,), Tpre, dtype=torch.int32))
        got = [got]
        for t in range(Tpre, T):
            lg, _ = model.paged_step(tparams, toks[:, t:t + 1], pages, tables,
                                     torch.full((B,), t, dtype=torch.int32),
                                     torch.ones(B, dtype=torch.int32))
            got.append(lg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_from_config_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Session.from_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--tokens", "2"])


def test_unported_paths_raise(port, tmp_path):
    # training and checkpointing are ported (test_torch_training.py,
    # test_torch_trainer.py), every family (test_torch_families.py), and
    # training through flash attention (test_torch_flash_training.py): a
    # call that needs its backward reaches q, k and v
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 2, 16, generator=g).requires_grad_()
               for _ in range(3))
    grads = torch.autograd.grad(flash_ops.flash_attention(q, k, v).sum(),
                                (q, k, v))
    assert all(t.shape == x.shape and bool(t.abs().max() > 0)
               for t, x in zip(grads, (q, k, v)))
    with torch.no_grad():
        assert flash_ops.flash_attention(q, q, q).shape == q.shape
    res = port.train(steps=1, batch_size=4, seq_len=8, log_every=0,
                     checkpoint_dir=str(tmp_path / "ckpt"))
    assert res.step == 1 and (tmp_path / "ckpt" / "step_00000001").is_dir()


def test_cli_runs_every_mode_on_cpu(capsys):
    counts = dispatch.launch_counts()
    for mode in ("direct", "wave", "continuous"):
        res = serve_cli.main(["--device", "cpu", "--scheduler", mode,
                              "--batch", "3", "--prompt-len", "6",
                              "--tokens", "3", "--max-batch", "2"])
        assert res.tokens.shape == (3, 3)
    assert "scheduler=continuous" in capsys.readouterr().out
    assert dispatch.launch_counts() == counts  # CPU: plain versions only


def test_params_from_jax_rejects_a_wrong_shape(weights):
    jmodel, jparams, cfg, _ = weights
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"] = tree["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(tree, cfg, "cpu")
