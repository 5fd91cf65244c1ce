"""The port's packed layout against the JAX package's, on the qwen2.5-3b
smoke tree (P = 107,520, 15 leaves): the same leaf order, offsets and total
(the threefry counters of the noise streams are these indices), a bit-equal
packed buffer, views on unpack, and the parameters re-homed into the buffer
by ``pack_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import flatbuf as jflat
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.core import flatbuf
from repro_torch.models import packing, transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2.5-3b"


def _trees():
    """(JAX tree, port Transformer) with equal weights: the port's random
    smoke weights, restacked the JAX way by ``params_to_numpy``."""
    tparams = transformer.init(torch.Generator().manual_seed(0),
                               get_smoke_config(ARCH), "cpu")
    return jax.tree.map(jnp.asarray, params_to_numpy(tparams)), tparams


def test_layout_equals_jax():
    jparams, tparams = _trees()
    # the tree of the JAX model itself (shapes only: no weights drawn)
    shapes = jax.eval_shape(jax_build_model(jax_smoke_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, jparams)
    jl = jflat.layout_of(jparams)
    tl = flatbuf.layout_of(packing.param_tree(tparams))
    assert (tl.total, tl.n_leaves) == (jl.total, jl.n_leaves) == (107520, 15)
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.shapes == jl.shapes
    back = params_from_jax(params_to_numpy(tparams), get_smoke_config(ARCH),
                           "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                  tparams.parameters()))
    paths = ["/".join(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert [p.replace(".", "/") for p in tl.paths] == paths


def test_pack_bit_equal_and_unpack_views():
    jparams, tparams = _trees()
    layout = flatbuf.layout_of(packing.param_tree(tparams))
    buf = flatbuf.pack(layout, packing.param_tree(tparams))
    want = np.asarray(jflat.pack(jflat.layout_of(jparams), jparams))
    np.testing.assert_array_equal(buf.numpy(), want)
    tree = flatbuf.unpack(layout, buf)
    for path, leaf in packing.param_tree(tparams).items():
        got = tree[path]
        for a, b in zip(got if isinstance(got, list) else [got],
                        leaf if isinstance(leaf, list) else [leaf]):
            assert torch.equal(a, b)
            assert a.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
    again = flatbuf.pack(layout, tree)
    assert torch.equal(again, buf)
    noisy = torch.randn(layout.total)
    flatbuf.zero_padding(layout, noisy)
    assert torch.equal(noisy, flatbuf.pack(layout, flatbuf.unpack(layout, noisy)))


def test_pack_params_makes_the_weights_views_of_one_buffer():
    jparams, tparams = _trees()
    want = np.asarray(jflat.pack(jflat.layout_of(jparams), jparams))
    layout, buf = packing.pack_params(tparams)
    np.testing.assert_array_equal(buf.numpy(), want)
    wq1 = tparams.layers[1].attn.wq
    assert wq1.requires_grad
    off = layout.offsets[layout.paths.index("layers.attn.wq")] + wq1.numel()
    with torch.no_grad():
        buf[off] = 123.0
    assert wq1.reshape(-1)[0].item() == 123.0
