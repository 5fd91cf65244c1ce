"""The per-leaf zero-sum mask: the plain version of the ``zsmask`` kernel
against the JAX package's ``zsmask_ref`` and ``zsmask_pallas`` in interpret
mode (as the JAX package's own CPU tests run it), and the tree-level
``pairwise_mask_tree`` (perleaf and packed) against JAX's, leaf-index key
folding included, on the same numpy inputs.

The threefry bits are equal; libm's ``log`` is not bit-portable, and XLA
may fuse the multiply-adds, so each normal may differ by an ulp or two of
its value. The mask term ``b * (r_i - r_nxt)`` carries that difference
times ``b``: with ``|r| <= 5`` at these sizes, a few fp32 ulps of ``b * 10``
bound it, held to ``ATOL_PER_B * b`` (``4 * 2**-23 * 10``, about 4.8e-6 per
unit of ``b``, as ``test_torch_clip_mask.py``); measured max 8.6e-6 at
``b`` = 9.6 (4.6e-5 allowed). Telescoping: the sum of every silo's mask
minus the sum of their noise terms leaves only the r-terms' fp32 residue,
held to the same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro.core import masking as jmask
from repro.kernels.zsmask import ref as jref
from repro.kernels.zsmask.zsmask import zsmask_pallas
from repro_torch.configs import get_smoke_config
from repro_torch.core import flatbuf, masking
from repro_torch.kernels import dispatch
from repro_torch.kernels.zsmask import ops, ref
from repro_torch.models import packing, transformer
from repro_torch.models.convert import params_to_numpy

ATOL_PER_B = 4 * 2.0 ** -23 * 10
KR, KX = (3704974950, 1863054868), (2705940334, 2639757084)
B_SCALE = np.float32(9.6)   # mask_scale 8 * sigma 0.3 * C 4
SIGMA_C = np.float32(1.2)   # sigma 0.3 * C 4
ATOL = ATOL_PER_B * float(B_SCALE)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g(D, seed):
    return np.random.default_rng(seed).standard_normal(D).astype(np.float32)


def _jkeys():
    return jnp.asarray(KR, jnp.uint32), jnp.asarray(KX, jnp.uint32)


@pytest.mark.parametrize("silo,n,offset", [
    (0, 4, 0), (3, 4, 0), (1, 5, 0),
    (2, 4, 12288),            # layer 3 of a stacked leaf of 4096 per layer
    (1, 4, 2 ** 32 - 1000),   # the uint32 counter wraps inside the flat
])
def test_zsmask_plain_matches_jax(silo, n, offset):
    g = _g(4096, seed=silo + 10 * n)
    before = dispatch.launch_counts()
    got = ops.apply_zsmask(torch.from_numpy(g), KR, KX, silo, n, SIGMA_C,
                           B_SCALE, offset=offset).numpy()
    assert dispatch.launch_counts() == before  # CPU: the plain version
    kr, kx = _jkeys()
    want = np.asarray(jref.zsmask_ref(jnp.asarray(g), kr, kx, silo, n,
                                      jnp.float32(SIGMA_C),
                                      jnp.float32(B_SCALE), offset))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if offset == 0:  # the TPU kernel takes whole flats only
        pallas = np.asarray(zsmask_pallas(
            jnp.asarray(g), kr, kx, silo, n, jnp.float32(SIGMA_C),
            jnp.float32(B_SCALE), interpret=True))
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert np.abs(got - g).max() > 1.0  # the mask is there


def test_slices_at_their_offsets_equal_the_whole_leaf():
    """A stacked leaf held as L tensors: each masked at offset l * numel is
    that slice of the whole leaf's mask, bit for bit; in place too."""
    g = torch.from_numpy(_g(3 * 1000, seed=3))
    whole = ref.zsmask_ref(g, KR, KX, 1, 4, SIGMA_C, B_SCALE)
    for l in range(3):
        part = g[l * 1000:(l + 1) * 1000].clone()
        out = ops.apply_zsmask(part, KR, KX, 1, 4, SIGMA_C, B_SCALE,
                               offset=l * 1000, out=part)
        assert out is part
        assert torch.equal(part, whole[l * 1000:(l + 1) * 1000])


def _smoke_trees():
    model = transformer.init(torch.Generator().manual_seed(0),
                             get_smoke_config("qwen2.5-3b"), "cpu")
    jtree = jax.tree.map(jnp.asarray, params_to_numpy(model))
    ttree = {k: [t.detach() for t in v] if isinstance(v, list) else v.detach()
             for k, v in packing.param_tree(model).items()}
    return jtree, ttree


@pytest.mark.parametrize("impl", ["perleaf", "packed"])
def test_pairwise_mask_tree_matches_jax(impl):
    """The smoke qwen tree (15 leaves, 12 of them stacked over 2 layers)
    masked for silo 2 of 4: per leaf with the leaf index folded into both
    keys, or packed in one buffer, as JAX does."""
    jtree, ttree = _smoke_trees()
    kr, kx = _jkeys()
    want = jax.jit(lambda t: jmask.pairwise_mask_tree(
        t, kr, kx, 2, 4, jnp.float32(SIGMA_C), jnp.float32(B_SCALE),
        impl=impl))(jtree)
    got = masking.pairwise_mask_tree(ttree, KR, KX, 2, 4, SIGMA_C, B_SCALE,
                                     impl=impl)
    tl = flatbuf.layout_of(got)
    np.testing.assert_allclose(flatbuf.pack(tl, got).numpy(),
                               np.asarray(jflat.pack(jflat.layout_of(jtree),
                                                     want)),
                               atol=ATOL, rtol=0)
    assert isinstance(got["layers.attn.wq"], list)  # the tree's structure


def test_leaf_keys_fold_the_index_into_both_words():
    assert masking.fold_leaf(KR, masking.R_FOLD, 0) == (
        (KR[0] + 0x9E3779B9) & 0xFFFFFFFF, (KR[1] + 0x9E3779B9) & 0xFFFFFFFF)
    got = masking.fold_leaf(KX, masking.XI_FOLD, 6)
    want = jnp.asarray(KX, jnp.uint32) + jnp.uint32(0x85EBCA6B) * jnp.uint32(7)
    assert got == tuple(int(x) for x in np.asarray(want))


def test_masks_telescope_over_the_ring():
    """The sum over all n silos of the masks is the sum of their noise
    terms: the pairwise r-terms cancel (mask-only trees, perleaf)."""
    _, ttree = _smoke_trees()
    n = 4
    masks = [masking.pairwise_mask_only(ttree, KR, KX, i, n, SIGMA_C, B_SCALE)
             for i in range(n)]
    noise = [masking.pairwise_mask_only(ttree, KR, KX, i, n, SIGMA_C, 0.0)
             for i in range(n)]
    layout = flatbuf.layout_of(ttree)
    total = sum(flatbuf.pack(layout, m) for m in masks)
    xi = sum(flatbuf.pack(layout, m) for m in noise)
    torch.testing.assert_close(total, xi, atol=ATOL, rtol=0)
    one = flatbuf.pack(layout, masks[0]) - flatbuf.pack(layout, noise[0])
    assert float(one.abs().max()) > 2 * float(B_SCALE)  # each mask is wide
