"""Serving the ssm (rwkv6-7b) and hybrid (zamba2-7b) families: the port
against the JAX package at the smoke configs in fp32, with the JAX weights
carried across by ``params_from_jax``.

- ``Session.serve`` in direct mode gives JAX's tokens, and its final logits
  agree within 1e-5 (|logit| up to about 4; fp32 products in other orders:
  measured max |diff| about 3e-6). The ssm family prefills recurrently in
  direct mode (decode over the prompt), in both packages.
- The wave scheduler (``Session.serve(scheduler="wave")``) gives JAX's
  tokens on the same Zipf requests: its prefill runs the whole prompt at
  once, through the WKV scan (ssm) or the SSD scan and flash attention
  (hybrid). JAX's CPU default for the WKV scan is its factored form, which
  clamps the log-decay at -3.5 where the TPU kernel and the port do not;
  at initialised weights (w_base -0.6, so w is about 0.58) the clamp is
  inert, so the two agree.
- Prefill and decode over a prompt against the parallel forward, as
  ``tests/test_models_smoke.py:65-95`` does for JAX (2e-3).
- Continuous batching raises JAX's ``ValueError`` (neither family pages).
  Training both families is ``tests/test_torch_ssm_training.py``'s.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serving import zipf_requests as jax_zipf_requests
from repro_torch import api
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as serve_cli
from repro_torch.models import hybrid, rwkv_stack
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.runtime.serving import zipf_requests

LOGIT_ATOL = LOGIT_RTOL = 1e-5
FORWARD_ATOL = FORWARD_RTOL = 2e-3
ARCHS = ("rwkv6-7b", "zamba2-7b")
MODULES = {"rwkv6-7b": rwkv_stack, "zamba2-7b": hybrid}


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
    """arch -> (JAX params, port config, port params): one JAX init each,
    carried across through numpy."""
    out = {}
    for arch in ARCHS:
        jmodel = jax_build_model(jax_smoke_config(arch),
                                 compute_dtype=jnp.float32)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch)
        out[arch] = (jparams, cfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return out


def test_configs_match_jax():
    for arch in ARCHS:
        cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_head", "d_ff", "vocab_size", "rope", "rope_theta",
                  "ssm_state", "rwkv_head_size", "mamba_expand",
                  "mamba_conv", "mamba_headdim", "attn_every"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
    r, z = get_config("rwkv6-7b"), get_config("zamba2-7b")
    assert (r.n_layers, r.d_model, r.n_heads, r.rwkv_head_size, r.d_ff,
            r.vocab_size) == (32, 4096, 64, 64, 14336, 65536)
    assert (z.n_layers, z.d_model, z.n_heads, z.d_head, z.ssm_state,
            z.mamba_headdim, z.attn_every) == (81, 3584, 32, 112, 64, 64, 6)
    assert hybrid.n_groups(z) == (13, 3)


def test_params_from_jax_fills_every_weight(weights):
    for arch in ARCHS:
        jparams, cfg, tparams = weights[arch]
        n_jax = sum(np.size(x) for x in jax.tree.leaves(jparams))
        assert sum(p.numel() for p in tparams.parameters()) == n_jax
    tree = jax.tree.map(np.asarray, weights["zamba2-7b"][0])
    tree["mamba_layers"]["mamba"]["conv_w"] = \
        tree["mamba_layers"]["mamba"]["conv_w"][:, 1:]
    with pytest.raises(ValueError, match="mamba_layers.0.mamba.conv_w"):
        params_from_jax(tree, get_smoke_config("zamba2-7b"), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_direct_serve_matches_jax(weights, arch):
    jparams, cfg, tparams = weights[arch]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 11))
    want = JaxSession.from_config(arch).serve(
        prompt=jnp.asarray(prompt, jnp.int32), params=jparams,
        max_new_tokens=6)
    before = dispatch.launch_counts()
    got = api.Session.from_config(arch, device="cpu").serve(
        prompt=prompt, params=tparams, max_new_tokens=6)
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_wave_serve_matches_jax(weights, arch):
    """Prompts of 3-12 tokens (ragged for any chunk) in waves of up to 3."""
    jparams, cfg, tparams = weights[arch]
    kw = dict(min_len=3, max_len=12, max_new_low=2, max_new_high=5, seed=4)
    j_reqs = jax_zipf_requests(6, cfg.vocab_size, **kw)
    t_reqs = zipf_requests(6, cfg.vocab_size, **kw)
    skw = dict(scheduler="wave", max_batch=3, max_len=24)
    want = JaxSession.from_config(arch).serve(requests=j_reqs,
                                              params=jparams, **skw)
    got = api.Session.from_config(arch, device="cpu").serve(
        requests=t_reqs, params=tparams, **skw)
    assert got.stats.drained and got.stats.waves == want.stats.waves
    for rj, rt in zip(j_reqs, t_reqs):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        assert rt.generated == rj.generated, f"{arch} rid {rt.rid} diverged"
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_parallel_forward(weights, arch):
    """A prompt prefilled at once, then decoded token by token, gives the
    parallel forward's logits at every position; so does decoding the
    whole sequence one token at a time."""
    _, cfg, tparams = weights[arch]
    model, mod = build_model(cfg, "cpu"), MODULES[arch]
    T, Tpre = 10, 6
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, T)))
    with torch.inference_mode():
        full = mod.forward(tparams, cfg, toks)
        cache = model.init_cache(2, T)
        got = [model.prefill(tparams, toks[:, :Tpre], cache)]
        got += [model.decode_step(tparams, toks[:, t:t + 1], cache)
                for t in range(Tpre, T)]
        cache = model.init_cache(2, T)
        seq = [model.decode_step(tparams, toks[:, t:t + 1], cache)
               for t in range(T)]
    for i, g in enumerate(got):
        torch.testing.assert_close(g, full[:, Tpre - 1 + i],
                                   atol=FORWARD_ATOL, rtol=FORWARD_RTOL)
    for t, g in enumerate(seq):
        torch.testing.assert_close(g, full[:, t], atol=FORWARD_ATOL,
                                   rtol=FORWARD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_raises_as_jax_does(weights, arch):
    jparams, cfg, tparams = weights[arch]
    with pytest.raises(ValueError) as jerr:
        JaxSession.from_config(arch).serve(scheduler="continuous",
                                           params=jparams, batch_size=2,
                                           prompt_len=4, max_new_tokens=2)
    with pytest.raises(ValueError) as terr:
        api.Session.from_config(arch, device="cpu").serve(
            scheduler="continuous", params=tparams, batch_size=2,
            prompt_len=4, max_new_tokens=2)
    assert str(terr.value) == str(jerr.value)
    assert "no paged serving path" in str(terr.value)


def test_serve_cli_runs_both_families_on_cpu(capsys):
    counts = dispatch.launch_counts()
    for arch in ARCHS:
        for mode in ("direct", "wave"):
            res = serve_cli.main(["--device", "cpu", "--arch", arch,
                                  "--scheduler", mode, "--batch", "3",
                                  "--prompt-len", "5", "--tokens", "3",
                                  "--max-batch", "2"])
            assert res.tokens.shape == (3, 3)
        with pytest.raises(ValueError, match="no paged serving path"):
            serve_cli.main(["--device", "cpu", "--arch", arch,
                            "--scheduler", "continuous", "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b-smoke" in out and "arch=zamba2-7b-smoke" in out
    assert dispatch.launch_counts() == counts


def test_multi_token_step_needs_an_empty_cache(weights):
    """zamba2's prefill attends over the prompt alone (flash self-attention),
    so a multi-token step on a non-empty cache raises, as in the port's
    dense family."""
    _, cfg, tparams = weights["zamba2-7b"]
    model = build_model(cfg, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with torch.inference_mode():
        cache = model.init_cache(1, 12)
        model.prefill(tparams, toks, cache)
        with pytest.raises(ValueError, match="empty cache"):
            model.prefill(tparams, toks, copy.copy(cache))
