"""The paper's CIFAR models in the port (``repro_torch/models/small.py``:
CIFAR10-CNN6 and CIFAR10-WRN28) against the JAX package's on the CPU, on
the same weights (a JAX tree drawn with numpy, carried over by
``small_params_from_jax``):

* ``synthetic_cifar10`` bit-equal to JAX's;
* XLA's "SAME" padding (asymmetric at stride 2) on odd and even sizes;
* logits and loss within ``LOSS_RTOL``, every gradient leaf within
  ``GRAD_RTOL`` of that leaf's largest value, at CNN6's published width,
  WRN28's published width on a batch of 2 and ``WRNConfig(depth=10,
  widen=1)`` on a larger batch, each at an input where the gradient is
  well defined to fp32's rounding (``COND_RTOL``); a CNN6 whose max-pool windows are all zero
  after the ReLU (tied maxima: torch and XLA may route the gradient to
  different elements, the ReLU's zero derivative cancels it);
* per-example, per-microbatch and per-silo clipping of CNN6
  (``core/clipping.py``, ``core/barrier.silo_grad``) against JAX's;
* ``build_small_model`` gives JAX's leaf paths, shapes and parameter counts
  (``tests/test_torch_tee.py``).

The training path of these models (steps, Trainer, wire tier) is held to
JAX by ``tests/test_torch_small_training.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CIFAR10_CNN6 as JCNN6
from repro.configs.paper_models import CIFAR10_WRN28 as JWRN28
from repro.configs.paper_models import WRNConfig as JWRNConfig
from repro.configs.base import PrivacyConfig as JPrivacy
from repro.core import barrier as jbarrier
from repro.core import flatbuf as jflat
from repro.data.synthetic import synthetic_cifar10 as jcifar10
from repro.models import small as jsmall
from repro_torch.configs.base import PrivacyConfig
from repro_torch.configs.paper_models import (CIFAR10_CNN6, CIFAR10_WRN28,
                                              WRNConfig)
from repro_torch.core import barrier, clipping, flatbuf
from repro_torch.data.synthetic import synthetic_cifar10
from repro_torch.models import small
from repro_torch.models.convert import small_params_from_jax

# fp32 forwards, XLA's convolutions against torch's (other summation
# orders): the loss moves in the 7th digit (measured 1e-7 to 3e-7)
LOSS_RTOL = 1e-5
# each gradient leaf against the largest |value| of JAX's leaf: fp32
# backward passes in other orders (measured up to 2.8e-6 over CNN6 and
# WRN28; torch's CPU group_norm backward on channels-last activations
# loses 3e-4 at large group means, which is why the port computes in
# contiguous NCHW)
GRAD_RTOL = 1e-4
# the precondition of that comparison: a ReLU input within rounding of 0
# makes the gradient jump, and WRN28's 28 layers carry such a jump to
# every earlier leaf (its fp64 gradient moved by 1e-3 to 2e-2 of a leaf's
# largest value under a 1e-6 relative change of the input, on 8 of 12
# weight draws; wherever port and JAX differed past GRAD_RTOL, it did:
# tools/cifar_conditioning.py --wrn): the input must be no such point,
# its fp64 gradient moving by less than COND_RTOL under two such changes
COND_EPS, COND_RTOL = 1e-6, 1e-5
# the clipped sums: each example's clipped gradient has norm <= C, the
# clip factor C / norm carries the norm's rounding
CLIP_RTOL = 1e-4

# JAX config, port config, batch, weight seed (see COND_RTOL)
CASES = {
    "cnn6": (JCNN6, CIFAR10_CNN6, 8, 0),
    "wrn28": (JWRN28, CIFAR10_WRN28, 2, 3),
    "wrn10x1": (JWRNConfig(depth=10, widen=1), WRNConfig(depth=10, widen=1),
                8, 0),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small work gains nothing from many intra-op threads, and the suite
    runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v if hasattr(v, "shape") else np.asarray(v)
    return out


def _data(n):
    train, _ = synthetic_cifar10(n_train=max(n, 16), n_test=16, seed=3)
    return train.x[:n], train.y[:n]


@pytest.mark.parametrize("seed", [7, 11])
def test_synthetic_cifar10_bit_equal_to_jax(seed):
    for mine, theirs in zip(synthetic_cifar10(96, 40, seed),
                            jcifar10(96, 40, seed)):
        assert mine.x.shape[1:] == (32, 32, 3) and mine.x.dtype == np.float32
        assert mine.y.dtype == np.int32
        np.testing.assert_array_equal(mine.x, theirs.x)
        np.testing.assert_array_equal(mine.y, theirs.y)


@pytest.mark.parametrize("size,k,stride,pads", [
    (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (32, 1, 2, (0, 0)),
    (31, 1, 2, (0, 0)), (32, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
    (8, 3, 2, (0, 1))])
def test_same_padding_matches_xla(size, k, stride, pads):
    """``_conv`` against JAX's ``_conv`` (``lax.conv_general_dilated``,
    "SAME"), the odd pixel after: (0, 1) for a 3x3 kernel at stride 2 on
    32 pixels."""
    assert small._same_pad(size, k, stride) == pads
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jsmall._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = small._conv(small._nchw(torch.tensor(x)), torch.tensor(w),
                      stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-size // stride),
                                       -(-size // stride), 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def jax_weights(jm, seed=0) -> dict:
    """A nested JAX tree of ``jm``'s leaf shapes (``jax.eval_shape`` of its
    init; JAX's own init costs seconds on the CPU), drawn with numpy:
    kernels at JAX's init scale (fan-in ** -0.5), biases and group-norm
    shifts at 0.1 and scales around 1, so no term starts at zero."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['s']"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("['b']"):
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def _both(case, kill=None):
    """The JAX and port models of ``case`` on the same JAX-tree weights
    (``kill``: an edit of that tree, applied to both)."""
    jcfg, tcfg, B, seed = CASES[case]
    jm, tm = jsmall.build_small_model(jcfg), small.build_small_model(tcfg)
    w = jax_weights(jm, seed)
    if kill is not None:
        kill(w)
    x, y = _data(B)
    return (jm, jax.tree.map(jnp.asarray, w),
            {"x": jnp.asarray(x), "y": jnp.asarray(y)},
            tm, small_params_from_jax(w, "cpu"),
            {"x": torch.tensor(x), "y": torch.tensor(y)})


def _fp64_grads(tm, tw, x, y) -> list:
    leaves = [v.double().requires_grad_() for v in tw.values()]
    loss = tm.loss(dict(zip(tw, leaves)), {"x": torch.tensor(x), "y": y})
    return torch.autograd.grad(loss, leaves)


def _assert_well_conditioned(tm, tw, tb):
    """The gradient is no jump away: fp64 gradients at the input and at
    two copies changed by COND_EPS relative agree within COND_RTOL."""
    x = tb["x"].double().numpy()
    base = _fp64_grads(tm, tw, x, tb["y"])
    for seed in (1, 2):
        e = np.random.default_rng(seed).standard_normal(x.shape)
        moved = _fp64_grads(tm, tw, x * (1 + COND_EPS * e), tb["y"])
        for a, b in zip(moved, base):
            assert (a - b).abs().max() <= COND_RTOL * b.abs().max()


def _hold_grads_to_jax(jm, jw, jb, tm, tw, tb):
    """Logits, loss and every gradient leaf against JAX's (one jit), at an
    input where the gradient is well defined to fp32's rounding."""
    _assert_well_conditioned(tm, tw, tb)
    def fwd_bwd(p, b):
        return jm.apply(p, b["x"]), jax.value_and_grad(jm.loss)(p, b)

    jlogits, (jloss, jgrads) = jax.jit(fwd_bwd)(jw, jb)
    jlogits = np.asarray(jlogits)
    leaves = {k: v.clone().requires_grad_() for k, v in tw.items()}
    logits = tm.apply(leaves, tb["x"])
    tloss = small.cross_entropy(logits, tb["y"])
    tgrads = dict(zip(leaves, torch.autograd.grad(tloss,
                                                  list(leaves.values()))))
    assert logits.shape == jlogits.shape == (tb["x"].shape[0], 10)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=0,
                               atol=LOSS_RTOL * np.abs(jlogits).max())
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    jflat_grads = _jax_flat(jgrads)
    assert set(jflat_grads) == set(tgrads)
    for k, g in tgrads.items():
        want = jflat_grads[k]
        assert g.shape == want.shape, k
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (k, err)
    return jlogits, tgrads


@pytest.mark.parametrize("case", list(CASES))
def test_logits_loss_and_grads_match_jax(case):
    jm, jw, jb, tm, tw, tb = _both(case)
    jlogits, _ = _hold_grads_to_jax(jm, jw, jb, tm, tw, tb)
    # JAX's accuracy, in numpy off its logits
    assert float(tm.accuracy(tw, tb)) == float(np.mean(
        jlogits.argmax(-1) == np.asarray(jb["y"])))


def test_maxpool_zero_windows_after_relu():
    """Whole 2x2 windows of zeros after the ReLU: the max ties, torch and
    XLA may send the gradient to different elements of the window, and
    the ReLU's zero derivative there cancels it. Bit-equal on a lone pool,
    and CNN6's gradients match JAX's with half of c1's and c3's channels
    dead (every window they pool is zero)."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    z[:, :4, :4, :] = -np.abs(z[:, :4, :4, :])  # whole windows <= 0
    z[:, 4:6, 4:6, 1] = 0.0                      # and exact zeros
    c = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)

    def jfn(z):
        return jnp.sum(jnp.asarray(c) * jsmall._maxpool(jax.nn.relu(z)))

    want = np.asarray(jax.grad(jfn)(jnp.asarray(z)))
    tz = small._nchw(torch.tensor(z)).requires_grad_()
    out = torch.sum(small._nchw(torch.tensor(c))
                    * small._maxpool(torch.relu(tz)))
    got, = torch.autograd.grad(out, tz)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert (want[:, :4, :4, :] == 0).all()

    def kill(w):
        for i in (1, 3):
            w[f"c{i}"]["b"][::2] = -1e3
    jm, jw, jb, tm, tw, tb = _both("cnn6", kill)
    _, grads = _hold_grads_to_jax(jm, jw, jb, tm, tw, tb)
    assert (grads["c1.b"][::2] == 0).all() and (grads["c3.b"][::2] == 0).all()


def test_build_small_model_leaf_paths_match_jax():
    for jcfg, tcfg, _, _ in CASES.values():
        jtree = _jax_flat(jax.eval_shape(jsmall.build_small_model(jcfg).init,
                                         jax.random.PRNGKey(0)))
        tree = small.build_small_model(tcfg).init(
            torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in tree.items()} == \
            {k: tuple(v.shape) for k, v in jtree.items()}
        assert flatbuf.layout_of(tree).paths == tuple(sorted(
            jtree, key=lambda p: tuple(p.split("."))))


# ---------------------------------------------------------------------------
# per-example, per-microbatch and per-silo clipping of CNN6

CLIP_C = 0.5


@pytest.fixture(scope="module")
def cnn6():
    """CNN6 on JAX's weights, 4 examples, and JAX's ``silo_grad`` at each
    clip mode (per-microbatch splits into 4 groups, as both packages do)."""
    jm, jw, _, tm, tw, _ = _both("cnn6")
    x, y = _data(4)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.tensor(x), "y": torch.tensor(y)}
    want = {}
    for mode in ("per_example", "per_microbatch", "per_silo"):
        jpriv = JPrivacy(enabled=True, clip_mode=mode)
        g, n, loss = jax.jit(lambda p, b: jbarrier.silo_grad(
            jm.loss, p, b, jpriv, CLIP_C))(jw, jb)
        want[mode] = (np.asarray(jflat.pack(jflat.layout_of(jw), g)),
                      np.asarray(n), float(loss))
    return tm, tw, tb, want


def _hold_clip_to_jax(tree, norms, loss, want):
    wsum, wnorms, wloss = want
    got = flatbuf.pack(flatbuf.layout_of(tree), tree).numpy()
    assert norms.shape == wnorms.shape
    np.testing.assert_allclose(norms.numpy(), wnorms, rtol=CLIP_RTOL)
    np.testing.assert_allclose(float(loss), wloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, wsum, rtol=0,
                               atol=CLIP_RTOL * np.abs(wsum).max())
    assert float(norms.min()) > CLIP_C  # every row clipped


@pytest.mark.parametrize("impl", ["packed", "perleaf"])
def test_per_example_clipping_matches_jax(cnn6, impl):
    """A batch of one a forward: the convolutions at B = 1, each example's
    gradient in its row of the (4, P) buffer, then ``clip_sum`` (packed)
    or ``per_example_sumsq`` + ``clip_accumulate`` per leaf (perleaf)."""
    tm, tw, tb, want = cnn6
    s, n, loss = clipping.per_example_clipped_grad(tm.loss, tw, tb, CLIP_C,
                                                   impl=impl)
    _hold_clip_to_jax(s, n, loss, want["per_example"])
    assert not any(v.requires_grad for v in tw.values())


@pytest.mark.parametrize("mode", ["per_example", "per_microbatch",
                                  "per_silo"])
def test_silo_grad_matches_jax(cnn6, mode):
    tm, tw, tb, want = cnn6
    g, n, loss = barrier.silo_grad(tm.loss, tw, tb,
                                   PrivacyConfig(enabled=True,
                                                 clip_mode=mode), CLIP_C)
    _hold_clip_to_jax(g, n, loss, want[mode])
