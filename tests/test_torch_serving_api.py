"""The rest of serving in the port, against the JAX package: the soak
mode (``run_soak`` and ``_rolling_p99`` of ``launch/serve.py``),
``PagePool.free_pages``, ``Session.with_run_config``,
``Session.kernel_impls`` and the one-call ``api.train`` / ``api.serve``."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs.base import PrivacyConfig as JaxPrivacyConfig
from repro.launch import serve as jax_serve_cli
from repro.runtime.serving import PagePool as JaxPagePool
from repro_torch import api
from repro_torch.configs.base import PrivacyConfig
from repro_torch.kernels import _build, dispatch
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime.serving import PagePool

ARCH = "qwen2.5-3b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sessions():
    return (jax_api.Session.from_config(ARCH),
            api.Session.from_config(ARCH, device="cpu"))


@pytest.mark.parametrize("latencies,window", [
    ([], 64),
    ([3, 1, 4], 64),                                   # shorter than a window
    (list(np.random.default_rng(0).integers(1, 90, 200)), 64),
    (list(np.random.default_rng(1).integers(1, 9, 37)), 5),
    ([7.5] * 12, 1),
])
def test_rolling_p99_matches_jax(latencies, window):
    assert serve_cli._rolling_p99(latencies, window) == \
        jax_serve_cli._rolling_p99(latencies, window)


def test_run_soak_matches_jax_and_merges(sessions, tmp_path):
    """The same Zipf trace through both continuous schedulers: every key of
    the row equal (the steps are the schedulers', which the port holds to
    JAX's tick for tick); the row merges into what the file held."""
    jsess, tsess = sessions
    kw = dict(max_batch=3, page_size=16, prefill_chunk=16, window=4)
    rows = {}
    for name, fn, sess in (("jax", jax_serve_cli.run_soak, jsess),
                           ("port", serve_cli.run_soak, tsess)):
        out = tmp_path / f"{name}.json"
        out.write_text(json.dumps({"serve/wave": {"kept": 1}}))
        rows[name] = fn(sess, 7, out=str(out), **kw)
        on_disk = json.loads(out.read_text())
        assert on_disk["serve/wave"] == {"kept": 1}
        assert on_disk["serve/soak"] == rows[name]
    assert rows["port"] == rows["jax"]
    assert rows["port"]["requests"] == 7 and rows["port"]["useful_tokens"] > 0


def test_soak_never_writes_the_jax_benchmark_record(sessions):
    with pytest.raises(ValueError, match="benchmark record"):
        serve_cli.run_soak(sessions[1], 2, max_batch=2, page_size=16,
                           prefill_chunk=16, window=4,
                           out=_build.REPO_ROOT / "BENCH_serve.json")
    assert serve_cli.SOAK_OUT.parent == _build.BUILD_DIR
    assert serve_cli.SOAK_OUT.parent.name == "build"


def test_soak_cli(tmp_path, capsys):
    out = tmp_path / "soak.json"
    row = serve_cli.main(["--device", "cpu", "--soak", "5", "--max-batch",
                          "2", "--window", "3", "--out", str(out)])
    assert json.loads(out.read_text())["serve/soak"] == row
    printed = capsys.readouterr().out
    assert "soak=5" in printed and "rolling p99" in printed


def test_free_pages_matches_jax(sessions):
    """The free list through admissions, a release and a re-admission."""
    jsess, tsess = sessions
    kw = dict(n_slots=3, n_pages=10, page_size=4, pages_per_slot=4)
    pools = (JaxPagePool(jsess.model, **kw), PagePool(tsess.model, **kw))
    trail = []
    for pool in pools:
        seen = [pool.free_pages]
        for slot, n in ((0, 3), (1, 4), (2, 4)):  # the third does not fit
            seen.append((pool.alloc(slot, n), pool.free_pages))
        pool.release(1)
        seen.append(pool.free_pages)
        seen.append((pool.alloc(1, 2), pool.free_pages))
        trail.append(seen)
    assert trail[0] == trail[1] == [10, (True, 7), (True, 3), (False, 3), 7,
                                    (True, 5)]


def test_bf16_page_pools_follow_the_compute_dtype():
    sess = api.Session.from_config(ARCH, compute_dtype=torch.bfloat16,
                                   device="cpu")
    pool = PagePool(sess.model, n_slots=2, n_pages=4, page_size=4,
                    pages_per_slot=2, draft_model=sess.model)
    assert {t.dtype for p in (pool.pages, pool.draft_pages)
            for t in p.values()} == {torch.bfloat16}


def test_with_run_config_matches_jax(sessions):
    jsess, tsess = sessions
    for sess, priv in ((jsess, JaxPrivacyConfig(enabled=True, sigma=0.5)),
                       (tsess, PrivacyConfig(enabled=True, sigma=0.5))):
        other = sess.with_run_config(privacy=priv, seed=7)
        assert other is not sess and type(other) is type(sess)
        assert other.run_cfg.privacy.sigma == 0.5 and other.run_cfg.seed == 7
        assert not sess.run_cfg.privacy.enabled and sess.run_cfg.seed == 0
        assert other.model is sess.model and other.cfg == sess.cfg
    assert tsess.with_run_config(seed=1).device == tsess.device
    with pytest.raises(TypeError):
        tsess.with_run_config(no_such_field=1)


def test_kernel_impls_match_jax(sessions):
    """Every port kernel lists its CUDA kernel first and its plain version,
    as JAX lists its Pallas kernel first and its jnp oracle; the kernels
    both packages name alike carry those, and the tree-level policies the
    same names."""
    jsess, tsess = sessions
    want, got = jsess.kernel_impls(), tsess.kernel_impls()
    assert set(got) == set(dispatch.KERNELS) | set(dispatch.TREE_KERNELS)
    for name in dispatch.KERNELS:
        assert got[name] == ["cuda", "plain"]
    for name in ("flash_attention", "paged_attention", "paged_reset",
                 "paged_rollback", "zsmask"):
        assert want[name][0] == "pallas" and "jnp" in want[name]
    for name in dispatch.TREE_KERNELS:
        assert got[name] == want[name]
    for name in got["dp_noise_tree"]:
        dispatch.resolve_tree("dp_noise_tree", name)


def test_one_call_serve_matches_jax_and_splits_keywords():
    """``api.serve`` takes ``Session.from_config``'s keywords beside
    ``serve``'s, as JAX's does (``shape`` too, dropped); bf16 through
    ``compute_dtype``."""
    kw = dict(batch_size=2, prompt_len=5, max_new_tokens=3, seed=1)
    want = jax_api.serve(ARCH, shape="train_4k", **kw)
    got = api.serve(ARCH, shape="train_4k", device="cpu", **kw)
    assert got.tokens.shape == np.asarray(want.tokens).shape == (2, 3)
    assert got.logits.shape == want.logits.shape
    assert got.logits.dtype == torch.float32
    low = api.serve(ARCH, compute_dtype=torch.bfloat16, device="cpu", **kw)
    jlow = jax_api.serve(ARCH, compute_dtype=jnp.bfloat16, **kw)
    assert low.logits.dtype == torch.bfloat16 and jlow.logits.dtype == \
        jnp.bfloat16
    with pytest.raises(TypeError):
        api.serve(ARCH, device="cpu", no_such_keyword=1)


def test_one_call_train_matches_jax():
    kw = dict(steps=1, batch_size=2, seq_len=8, log_every=0, seed=0)
    want = jax_api.train(ARCH, shape="train_4k", **kw)
    got = api.train(ARCH, shape="train_4k", device="cpu", **kw)
    assert got.step == want.step == 1
    assert len(got.metrics) == len(want.metrics) == 1
    assert set(want.final) <= set(got.final)
    assert np.isfinite(got.final["loss"])
