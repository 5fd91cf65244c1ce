"""The port's optimizers and LR schedules against the JAX package's.

The port updates packed fp32 buffers in place (the master buffer the
parameters are views of); the JAX package maps over the tree. The same
gradients go through both for three steps. The arithmetic is the same op
for op (measured: equal bits for every optimizer here), but ``b ** count``
goes through XLA's pow on one side and the CPU's on the other, which need
not agree in the last bit; held to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-6


@pytest.mark.parametrize("cfg", [
    dict(name="sgd", lr=0.1), dict(name="momentum", lr=0.1, beta1=0.8),
    dict(name="adamw", lr=1e-2), dict(name="adamw", lr=1e-2,
                                      weight_decay=0.1)])
def test_optimizers_match_jax(cfg):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(300).astype(np.float32)
    grads = [rng.standard_normal(300).astype(np.float32) for _ in range(3)]
    j = jopt.make_optimizer(JaxOptimizerConfig(**cfg))
    t = topt.make_optimizer(OptimizerConfig(**cfg))
    jp = {"w": jnp.asarray(w)}
    js = j.init(jp)
    master = torch.from_numpy(w.copy())
    ts = t.init(master)
    lr = cfg["lr"]
    for g in grads:
        jp, js = j.update(jp, js, {"w": jnp.asarray(g)},
                          jnp.asarray(lr, jnp.float32))
        ts = t.update(ts, torch.from_numpy(g), torch.tensor(lr))
    assert ts["master"] is master  # in place
    np.testing.assert_allclose(master.numpy(), np.asarray(jp["w"]), atol=ATOL,
                               rtol=0)


def test_schedules_match_jax():
    j = jsched.warmup_cosine(1e-3, 5, 20, floor=1e-5)
    t = tsched.warmup_cosine(1e-3, 5, 20, floor=1e-5)
    for step in range(0, 25, 3):
        np.testing.assert_allclose(float(t(step)),
                                   float(j(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6)
    assert float(tsched.constant(3e-4)(7)) == \
        float(jsched.constant(3e-4)(jnp.int32(7)))


def test_optimizer_works_in_chunks(monkeypatch):
    """An update over several chunks equals one over a single chunk."""
    monkeypatch.setattr(topt, "CHUNK", 64)
    g = torch.randn(300)
    a = torch.randn(300)
    b = a.clone()
    opt = topt.adamw()
    sa = opt.update(opt.init(a), g, torch.tensor(1e-2))
    monkeypatch.setattr(topt, "CHUNK", 1 << 26)
    sb = opt.update(opt.init(b), g, torch.tensor(1e-2))
    assert torch.equal(sa["master"], sb["master"])
    assert torch.equal(sa["v"], sb["v"])
