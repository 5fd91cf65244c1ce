"""The port's checkpointer (``repro_torch/checkpoint/checkpointer.py``)
against ``tests/test_checkpoint.py``'s cases and against the JAX package:
JAX's entry names for the dense, ssm and hybrid smoke configs and each
optimizer, a port checkpoint restored by JAX into a JAX template and a
JAX checkpoint (the legacy one without ``prev_active`` too) restored by the
port, array for array. A restore fills the state's buffers in place: the
parameters stay views of ``master`` and the padding exactly zero."""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.checkpoint import checkpointer as jck
from repro.configs.base import OptimizerConfig as JaxOptimizer
from repro.configs.base import PrivacyConfig as JaxPrivacy
from repro.core import flatbuf as jflat
from repro_torch.api import Session
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs.base import OptimizerConfig, PrivacyConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.trainer import Trainer, TrainerConfig

PRIV = dict(enabled=True, sigma=0.3, clip_bound=1.0, dynamic_clip=True,
            noise_lambda=0.7, n_silos=4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5), "d": [torch.zeros(2, dtype=torch.int32),
                                            np.arange(3, dtype=np.int64)]}}


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    ck.save(tmp_path, 7, t, extra={"note": "hi"})
    restored, extra, step = ck.restore(tmp_path, t)
    assert step == 7 and extra["note"] == "hi"
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["b"]["d"][0], t["b"]["d"][0])
    assert restored["b"]["d"][0].dtype == torch.int32
    np.testing.assert_array_equal(restored["b"]["d"][1], t["b"]["d"][1])
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert [e["path"] for e in manifest["entries"]] == \
        ["a", "b/c", "b/d/[0]", "b/d/[1]"] == ck.tree_paths(t)


def test_latest_and_gc(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(tmp_path, s, t)
    assert ck.latest_step(tmp_path) == 5
    ck.garbage_collect(tmp_path, keep=2)
    assert ck.latest_step(tmp_path) == 5
    assert len(list(Path(tmp_path).iterdir())) == 2
    assert ck.latest_step(tmp_path / "absent") is None


def test_integrity_verification_detects_tamper(tmp_path):
    t = tree()
    d = ck.save(tmp_path, 1, t)
    files = sorted(d.glob("arr_*.npy"))
    raw = bytearray(files[0].read_bytes())
    raw[-1] ^= 0xFF
    files[0].write_bytes(bytes(raw))
    with pytest.raises(IOError, match="integrity"):
        ck.restore(tmp_path, t)
    restored, _, _ = ck.restore(tmp_path, t, verify=False)  # opt-out
    assert not torch.equal(restored["a"], t["a"])


def test_shape_mismatch_rejected(tmp_path):
    t = tree()
    ck.save(tmp_path, 1, t)
    bad = {**tree(), "a": torch.zeros(2, 4)}
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tmp_path, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(tmp_path, {**tree(), "e": torch.zeros(1)})


def test_interrupted_write_is_invisible(tmp_path):
    t = tree()
    ck.save(tmp_path, 1, t)
    tmp = Path(tmp_path) / "step_00000002.tmp"
    tmp.mkdir()
    (tmp / "arr_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "empty", t)


def _port_state(arch, opt, seed=0):
    sess = Session.from_config(arch, device="cpu", seed=seed,
                               privacy=PrivacyConfig(**PRIV),
                               optimizer=OptimizerConfig(name=opt))
    return sess, sess.init_state()


def _jax_state(arch, opt):
    js = JaxSession.from_config(arch, privacy=JaxPrivacy(**PRIV),
                                optimizer=JaxOptimizer(name=opt))
    return js, js.init_state()


@pytest.mark.parametrize("arch,opt", [
    ("qwen2.5-3b", "adamw"), ("qwen2.5-3b", "momentum"),
    ("qwen2.5-3b", "sgd"), ("rwkv6-7b", "adamw"), ("zamba2-7b", "adamw")])
def test_entry_names_equal_jax(arch, opt):
    """The port's entry names for its TrainState are JAX's ``_tree_paths``
    of JAX's TrainState, in JAX's order (qwen2.5-3b adamw: 66 entries)."""
    _, tstate = _port_state(arch, opt)
    _, jstate = _jax_state(arch, opt)
    assert ck.tree_paths(tstate) == jck._tree_paths(jstate)
    if (arch, opt) == ("qwen2.5-3b", "adamw"):
        assert len(ck.tree_paths(tstate)) == 66


def _trained(sess, state, steps=2):
    """A state after a couple of steps (moments, count, noise state, bound
    and step all moved off their initial values)."""
    from repro_torch.core import prng

    tr = sess.trainer(total_steps=steps, batch_size=8, seq_len=8,
                      log_every=0)
    return tr.fit(state, prng.PRNGKey(1))[0]


def _leaf_values(state) -> dict:
    """path -> numpy value of every entry the port writes for ``state``."""
    return {leaf.path: leaf.get() for leaf in ck._state_leaves(state, {})}


@pytest.mark.parametrize("opt", ["adamw", "momentum", "sgd"])
def test_port_checkpoint_restores_in_jax(tmp_path, opt):
    """A checkpoint the port wrote restores through JAX's ``restore`` into
    a JAX template: every array equal, in JAX's dtypes."""
    sess, state = _port_state("qwen2.5-3b", opt)
    state = _trained(sess, state)
    ck.save(tmp_path, state.step, state, extra={"from": "port"})
    _, jtemplate = _jax_state("qwen2.5-3b", opt)
    jrestored, extra, step = jck.restore(tmp_path, jtemplate)
    assert step == state.step == 2 and extra == {"from": "port"}
    want = _leaf_values(state)
    leaves = jax.tree_util.tree_flatten(jrestored)[0]
    for path, leaf in zip(jck._tree_paths(jrestored), leaves):
        got = np.asarray(leaf)
        np.testing.assert_array_equal(got, want[path].astype(got.dtype))
    assert jrestored.step.dtype == jnp.int32
    assert jrestored.noise_state.prev_key.dtype == jnp.uint32
    assert int(jrestored.step) == 2
    assert bool(jrestored.noise_state.has_prev)


def _random_like(jstate):
    """JAX's state with every leaf drawn from a seed (the step and count 2,
    the flags set) and the params equal to master, as after training."""
    rng = np.random.default_rng(3)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return rng.standard_normal(x.shape).astype(np.float32)
        if x.dtype == np.uint32:
            return rng.integers(0, 2 ** 32, x.shape, dtype=np.uint32)
        if x.dtype == np.bool_:
            return rng.random(x.shape) < 0.5 if x.ndim else np.True_
        return np.full(x.shape, 2, x.dtype)

    leaves, treedef = jax.tree_util.tree_flatten(jstate)
    jstate = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(draw(x)) for x in leaves])
    return jstate._replace(params=jstate.opt_state["master"])


def _poison_padding(state):
    """Nonzero values at every padding position of every buffer, which a
    restore must zero again."""
    lay = state.layout
    for buf in state.opt_state.values():
        if isinstance(buf, torch.Tensor):
            for size, pad, off in zip(lay.sizes, lay.padded, lay.offsets):
                buf[off + size:off + pad] = 7.0
            buf[lay.offsets[-1] + lay.padded[-1]:] = 7.0


def _padding_max(state) -> float:
    lay, worst = state.layout, 0.0
    for buf in state.opt_state.values():
        if isinstance(buf, torch.Tensor):
            mask = torch.ones(lay.total, dtype=torch.bool)
            for size, off in zip(lay.sizes, lay.offsets):
                mask[off:off + size] = False
            worst = max(worst, buf[mask].abs().max().item())
    return worst


@pytest.mark.parametrize("opt", ["adamw", "momentum"])
def test_jax_checkpoint_restores_in_port_in_place(tmp_path, opt):
    """A checkpoint JAX wrote restores into the port's state: every leaf
    equal to JAX's array, the buffers filled in place (the parameters still
    views of ``master``'s storage, no buffer rebound) and the padding
    exactly zero, though it held garbage before."""
    _, jstate = _jax_state("qwen2.5-3b", opt)
    jstate = _random_like(jstate)
    jck.save(tmp_path, 2, jstate, extra={"from": "jax"})
    sess, state = _port_state("qwen2.5-3b", opt, seed=5)
    ptrs = {k: v.data_ptr() for k, v in state.opt_state.items()
            if isinstance(v, torch.Tensor)}
    _poison_padding(state)
    restored, extra, step = ck.restore(tmp_path, state)
    assert step == 2 and restored.step == 2 and extra == {"from": "jax"}
    mst = restored.opt_state["master"]
    assert all(restored.opt_state[k].data_ptr() == p
               for k, p in ptrs.items())
    assert restored.params is state.params
    base = mst.untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base
               for p in restored.params.parameters())
    assert _padding_max(restored) == 0.0
    got = _leaf_values(restored)
    for path, leaf in zip(jck._tree_paths(jstate),
                          jax.tree_util.tree_flatten(jstate)[0]):
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
    assert restored.noise_state.prev_key == tuple(
        int(x) for x in np.asarray(jstate.noise_state.prev_key))
    # the model reads the restored weights: its parameters are the buffer
    restored_model = params_from_jax(
        jax.tree.map(np.asarray, jstate.params), sess.cfg, "cpu")
    for p, q in zip(restored.params.parameters(),
                    restored_model.parameters()):
        assert torch.equal(p, q)


def test_legacy_jax_checkpoint_restores_all_active(tmp_path):
    """A JAX checkpoint from before elastic membership (no
    ``.noise_state/.prev_active``) restores through the Trainer with every
    silo taken as active at t-1, as JAX's Trainer does."""
    js, jstate = _jax_state("qwen2.5-3b", "adamw")
    legacy = jstate._replace(noise_state=jstate.noise_state._replace(
        prev_active=None))
    jck.save(tmp_path, 4, legacy)
    entries = json.loads((tmp_path / "step_00000004" /
                          "manifest.json").read_text())["entries"]
    assert ".noise_state/.prev_active" not in [e["path"] for e in entries]
    sess, state = _port_state("qwen2.5-3b", "adamw")
    with pytest.raises(KeyError, match="prev_active"):
        ck.restore(tmp_path, state)
    tr = Trainer(sess.model, sess.run_cfg,
                 TrainerConfig(total_steps=4, checkpoint_dir=str(tmp_path),
                               log_every=0), lambda: {})
    restored, step = tr.try_restore(state)
    assert step == 4 == tr.restored_step
    np.testing.assert_array_equal(restored.noise_state.prev_active,
                                  np.ones(4, bool))
    np.testing.assert_array_equal(
        restored.opt_state["master"].numpy(),
        np.asarray(jflat.pack(jflat.layout_of(jstate.params),
                              jstate.opt_state["master"])))
    assert [e["op"] for e in tr.checkpoint_log] == ["restore"]


def test_save_splits_its_time(tmp_path):
    """``timings`` splits a save into device-to-host, write and hash and a
    restore into read, hash and host-to-device, with the bytes moved."""
    _, state = _port_state("qwen2.5-3b", "sgd")
    t_save, t_restore = {}, {}
    d = ck.save(tmp_path, 0, state, timings=t_save)
    ck.restore(tmp_path, state, timings=t_restore)
    size = sum(f.stat().st_size for f in d.glob("arr_*.npy"))
    assert t_save["bytes"] == t_restore["bytes"] == size
    assert set(t_save) == {"bytes", "d2h_s", "write_s", "hash_s"}
    assert set(t_restore) == {"bytes", "read_s", "hash_s", "h2d_s"}
    shutil.rmtree(d)
