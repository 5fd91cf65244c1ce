"""JAX's input-shape cells and parameter counts in the port
(``repro_torch.configs``): ``SHAPES``, ``shape_applicability`` with its
reasons, ``applicable_shapes``, ``runnable_cells`` (31 on this tree),
``param_count`` and ``active_param_count``, equal to the JAX package's for
every arch; and ``Session.from_config(shape=...)`` storing the cell in
``run_cfg.shape`` as JAX's does."""
import dataclasses

import pytest
import torch

from repro import api as jax_api
from repro import configs as jax_configs
from repro_torch import api, configs
from repro_torch.configs.base import SHAPES, ShapeConfig


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_equal_jax():
    assert list(SHAPES) == list(jax_configs.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_configs.SHAPES[name])


def test_arch_ids_and_cells_equal_jax():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    cells = configs.runnable_cells()
    assert cells == jax_configs.runnable_cells()
    assert len(cells) == 31


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_applicability_and_counts_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    for name in SHAPES:
        assert configs.shape_applicability(cfg, SHAPES[name]) == \
            jax_configs.shape_applicability(jcfg, jax_configs.SHAPES[name])
    assert [s.name for s in configs.applicable_shapes(cfg)] == \
        [s.name for s in jax_configs.applicable_shapes(jcfg)]
    assert cfg.subquadratic() == jcfg.subquadratic()
    assert cfg.has_attention() == jcfg.has_attention()
    for full, jfull in ((cfg, jcfg), (configs.get_smoke_config(arch),
                                      jax_configs.get_smoke_config(arch))):
        assert configs.param_count(full) == jax_configs.param_count(jfull)
        assert configs.active_param_count(full) == \
            jax_configs.active_param_count(jfull)


def test_applicability_reasons():
    """The two refusals, with JAX's wording: an encoder has no decode step,
    and long_500k needs a sub-quadratic arch."""
    hub, qwen = configs.get_config("hubert-xlarge"), \
        configs.get_config("qwen2.5-3b")
    assert configs.shape_applicability(hub, SHAPES["decode_32k"]) == (
        False, "encoder-only arch has no decode step")
    ok, why = configs.shape_applicability(qwen, SHAPES["long_500k"])
    assert not ok and why.startswith("long_500k needs sub-quadratic")
    assert {a for a, s in configs.runnable_cells() if s == "long_500k"} == \
        {"rwkv6-7b", "zamba2-7b"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k",
                                   ShapeConfig("s64", "prefill", 64, 2)])
def test_session_stores_shape_like_jax(shape):
    sess = api.Session.from_config("qwen2.5-3b", shape=shape, device="cpu")
    jsess = jax_api.Session.from_config("qwen2.5-3b", shape=shape
                                        if isinstance(shape, str) else
                                        jax_configs.ShapeConfig(
                                            **dataclasses.asdict(shape)))
    want = SHAPES[shape] if isinstance(shape, str) else shape
    assert sess.run_cfg.shape == want
    assert dataclasses.asdict(sess.run_cfg.shape) == \
        dataclasses.asdict(jsess.run_cfg.shape)


def test_default_shape_and_one_call_split():
    """``train_4k`` by default, as JAX's; the one-call helpers hand
    ``shape`` to ``from_config`` instead of dropping it."""
    assert api.Session.from_config("qwen2.5-3b", device="cpu") \
        .run_cfg.shape == SHAPES["train_4k"]
    kw = {"shape": "decode_32k", "device": "cpu", "steps": 2}
    assert api._split_ctor(kw) == {"shape": "decode_32k", "device": "cpu"}
    assert kw == {"steps": 2}
