"""Zero-sum DP masking (paper section 4.2) over gradient trees: the
key-derived pairwise construction. Port of the pairwise part of
``repro/core/masking.py``.

``m_i = B (r_i - r_{(i+1) mod n}) + xi_i`` with ``xi_i`` of std
``sigma_c / sqrt(n)``, every stream drawn from 8-byte per-step keys:
telescoping gives ``sum_i m_i = xi`` exactly. The tree-level kernel
``zsmask_tree`` has two variants that draw different, equally valid, stream
families, so every silo of a session must resolve to the same one:

* ``packed``: the whole tree as one flat buffer, one ``clip_mask`` launch,
  the global packed index as the counter (``dp_fused/ops.packed_mask_tree``);
* ``perleaf``: one ``zsmask`` launch per leaf (per tensor of a stacked
  leaf, at its counter offset), the leaf index i folded into both words of
  each key: ``k + 0x9E3779B9 * (i + 1)`` for ``key_r`` and
  ``k + 0x85EBCA6B * (i + 1)`` for ``key_xi``, uint32, in JAX's leaf order.
  Over a packed buffer (the barrier tier's contribution) the same family
  is one ``zsmask_buffer`` launch for every tensor (:func:`mask_buffer`),
  the lambda-correction's pass fused in; a tree with bf16 leaves takes one
  launch a dtype, the bf16 leaves in the JAX package's rounding order.

The admin construction (the paper-faithful wire protocol): the admin draws
``u_1 .. u_{n-1}`` of spread ``b`` and closes the set with
``m_close = xi - lam * xi_{t-1} - sum_i u_i``, ``xi`` of std ``sigma_c``.
JAX's key schedule: ``ku, kxi = split(key)``, one ``split`` of each per leaf,
``split(ku_leaf, n)`` for the rows, every draw a ``jax.random.normal``
(``core/prng.py``), a stacked leaf's tensors at their counter offsets. The
closing row subtracts the other rows in index order, so one silo's row
(:func:`admin_mask_row`, O(P), the closing one O(k P)) equals its row of
the stacked set (:func:`admin_masks`, O(n P)) element for element. Every
stream is drawn ``WINDOW`` elements at a time, so no leaf-sized temporary
lives beside the rows; the lambda-correction can ride along as an
:class:`XiCorrection`, drawn window by window, instead of a tree. On the
card each draw is one launch (``kernels/prng``): a row's ``u`` a
``normal`` times ``b``, the xi with its correction (or with none) one
``normal_combine`` written, or added, straight into its destination; a
correction given as a tree, the closing row's subtractions and the
stacked set's gating stay plain torch over the kernel-drawn normals.

The integer-ring masks (:func:`ring_mask_tree`, :func:`to_ring`,
:func:`from_ring`): int32 pairwise masks drawn with ``jax.random.bits``,
which wrap to exactly zero over the ring; bit-equal to JAX's.
"""
from __future__ import annotations

import itertools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import flatbuf, prng
from repro_torch.kernels.dispatch import on_cuda, resolve_tree
from repro_torch.kernels.dp_fused import ops as fused_ops
from repro_torch.kernels.prng import ops as prng_ops
from repro_torch.kernels.zsmask import ops as zs_ops
from repro_torch.kernels.zsmask.ref import R_FOLD, XI_FOLD, _on, fold_key
from repro_torch.kernels.zsmask.threefry import M32

TREE = "zsmask_tree"


def _raw(key) -> tuple:
    """``(k0, k1)`` ints of a raw key: a pair, a numpy array or a tensor."""
    k0, k1 = (int(k) for k in key)
    return k0 & M32, k1 & M32


def fold_leaf(key, mult: int, i: int) -> tuple:
    """Leaf i's key: ``key + mult * (i + 1)`` on both uint32 words."""
    return fold_key(_raw(key), mult, i)


def mask_leaf(g, key_r, key_xi, i: int, offset: int, silo: int, n_silos: int,
              sigma_c, b_scale, out=None):
    """Leaf i's mask applied to one flat tensor of it, ``offset`` its first
    element inside the leaf: one ``zsmask`` dispatch."""
    return zs_ops.apply_zsmask(g, fold_leaf(key_r, R_FOLD, i),
                               fold_leaf(key_xi, XI_FOLD, i), silo, n_silos,
                               sigma_c, b_scale, offset=offset, out=out)


def mask_buffer(buf, layout, key_r, key_xi, silo: int, n_silos: int, sigma_c,
                b_scale, prev_key=None, lam=None, half=None):
    """The per-leaf family over every tensor of ``buf``, the packed (P,)
    fp32 buffer of ``layout``, in place: :func:`mask_leaf` of each tensor,
    and with ``prev_key`` the correction's pass (:func:`mask_leaf` over
    zeros on ``prev_key`` with ``b = 0``) times ``lam`` subtracted, in one
    ``zsmask_buffer`` dispatch. A layout with bf16 leaves takes ``half``,
    the packed bf16 buffer of its clipped leaves: its fp32 leaves are
    masked so in place (one dispatch, none when there is none), and its
    bf16 leaves' contributions are written into ``buf`` from ``half`` in
    the JAX package's order over a bf16 leaf (one
    ``zs_ops.zsmask_buffer_bf16`` dispatch). Returns ``buf``."""
    kr, kx = _raw(key_r), _raw(key_xi)
    kp = None if prev_key is None else _raw(prev_key)
    if "bfloat16" not in layout.dtypes:
        return zs_ops.zsmask_buffer(buf, layout, kr, kx, silo, n_silos,
                                    sigma_c, b_scale, kp, lam)
    if half is None:
        raise ValueError("a layout with bf16 leaves masks from their packed "
                         "bf16 buffer: pass half")
    zs_ops.zsmask_buffer(buf, layout, kr, kx, silo, n_silos, sigma_c,
                         b_scale, kp, lam, dtype="float32")
    return zs_ops.zsmask_buffer_bf16(half, buf, layout, kr, kx, silo,
                                     n_silos, sigma_c, b_scale, kp, lam)


def _mask_tree_perleaf(grads, key_r, key_xi, silo, n_silos, sigma_c, b_scale):
    layout = flatbuf.layout_of(grads)

    def one(i, offset, g):
        flat = g.reshape(-1)
        out = mask_leaf(flat, key_r, key_xi, i, offset, silo, n_silos,
                        sigma_c, b_scale)
        return out.reshape(g.shape).to(g.dtype)

    return flatbuf.map_leaf_slices(layout, grads, one)


def pairwise_mask_tree(grads, key_r, key_xi, silo: int, n_silos: int,
                       sigma_c, b_scale, impl: str = "auto"):
    """``m_silo`` applied to every leaf of ``grads`` (a flat tree; keys are
    per step). ``auto``: packed on the card, perleaf on the CPU."""
    first = flatbuf.flat_tensors(flatbuf.layout_of(grads), grads)[0]
    if resolve_tree(TREE, impl, on_cuda(first)) == "packed":
        return fused_ops.packed_mask_tree(grads, _raw(key_r), _raw(key_xi),
                                          silo, n_silos, sigma_c, b_scale)
    return _mask_tree_perleaf(grads, key_r, key_xi, silo, n_silos, sigma_c,
                              b_scale)


def pairwise_mask_only(shapes_tree, key_r, key_xi, silo: int, n_silos: int,
                       sigma_c, b_scale, impl: str = "jnp"):
    """The mask alone: :func:`pairwise_mask_tree` over zeros shaped as
    ``shapes_tree``. ``impl`` defaults to the legacy ``jnp`` (perleaf), as
    in JAX."""
    zeros = {k: [torch.zeros_like(t, dtype=torch.float32) for t in v]
             if isinstance(v, list) else torch.zeros_like(v, dtype=torch.float32)
             for k, v in shapes_tree.items()}
    return pairwise_mask_tree(zeros, key_r, key_xi, silo, n_silos, sigma_c,
                              b_scale, impl=impl)


# ---------------------------------------------------------------------------
# Admin-generated masks (the paper-faithful wire protocol)

# elements of one stream drawn at a time: the rows' temporaries (a window
# each of the n rows' u and of the closing row) stay tens of MB, and the
# plain draws' int64 temporaries on the CPU a few hundred
WINDOW = 1 << 22


class XiCorrection(NamedTuple):
    """The admin-owned correction ``lam * admin_xi(key, template,
    sigma_c)``, given by its key and drawn window by window where a row or
    the central noise subtracts it (JAX passes the tree)."""

    key: tuple
    sigma_c: Any
    lam: Any


def _windows(n: int):
    for a in range(0, n, WINDOW):
        yield a, min(a + WINDOW, n)


def _leaf_keys(key, n_leaves: int) -> tuple:
    """``(kus, kxis)``: the per-leaf row and xi keys of ``key``."""
    ku, kxi = prng.split(_raw(key), 2)
    return prng.split(ku, n_leaves), prng.split(kxi, n_leaves)


class _Streams:
    """The draws of one tree under one admin key, on one device: leaf i's
    row keys (split once a leaf), the fp32 scalars, and the correction's
    per-leaf keys or tensors."""

    def __init__(self, key, layout, n_silos: int, sigma_c, b_scale, device,
                 correction=None):
        self.n = n_silos
        self.kus, self.kxis = _leaf_keys(key, layout.n_leaves)
        self._rows: dict = {}
        self.dev = device
        self.sc = _on(sigma_c, device)
        self.b = None if b_scale is None else _on(b_scale, device)
        self.corr = correction
        if isinstance(correction, XiCorrection):
            self.ckeys = _leaf_keys(correction.key, layout.n_leaves)[1]
            self.csc = _on(correction.sigma_c, device)
            self.clam = _on(correction.lam, device)
        elif correction is not None:
            self.ctensors = flatbuf.flat_tensors(layout, correction)

    def row_key(self, i: int, j: int) -> tuple:
        if i not in self._rows:
            self._rows = {i: prng.split(self.kus[i], self.n)}
        return self._rows[i][j]

    def normal(self, key, offset: int, a: int, b: int) -> torch.Tensor:
        return prng.normal(key, (b - a,), offset + a, self.dev)

    def u(self, i, j, offset, a, b) -> torch.Tensor:
        """Row j's draw times ``b_scale``."""
        return self.normal(self.row_key(i, j), offset, a, b).mul_(self.b)

    def xi(self, out, i, k, offset, a, b, accumulate=False) -> torch.Tensor:
        """``xi * sigma_c`` minus the correction (tensor k's window),
        written into ``out`` (added to it when ``accumulate``): one
        ``normal_combine``, ``xi * sc - (xi_c * csc) * clam`` in JAX's
        order, unless the correction is a tree, subtracted after."""
        if isinstance(self.corr, XiCorrection):
            return prng_ops.normal_combine(
                out, self.kxis[i], self.ckeys[i], offset + a, self.sc,
                self.csc, self.clam, accumulate)
        if self.corr is None:
            return prng_ops.normal_combine(out, self.kxis[i], None,
                                           offset + a, self.sc,
                                           accumulate=accumulate)
        x = self.normal(self.kxis[i], offset, a, b).mul_(self.sc)
        x.sub_(self.ctensors[k].reshape(-1)[a:b].float())
        return out.add_(x) if accumulate else out.copy_(x)


def _closing(n_silos: int, active) -> tuple:
    """``(act, closing)``: the participation set as bools and the last
    active silo, which closes the sum (``n - 1`` when none is active, as
    JAX's argmax finds it)."""
    act = np.ones(n_silos, bool) if active is None \
        else np.asarray(active).astype(bool)
    return act, int(n_silos - 1 - np.argmax(act[::-1]))


def admin_masks(key, template: dict, n_silos: int, sigma_c, b_scale,
                active=None, correction=None) -> dict:
    """The full set of n masks, each leaf stacked on a leading silo axis
    (a stacked leaf's tensors each ``(n, ...)``), with
    ``sum_i m_i = xi - correction``: the O(n P) object the paper's admin
    distributes. ``active``: dropped silos get zero rows and the last
    active silo closes the sum; ``correction``: a tree (or an
    :class:`XiCorrection`) folded into the closing row."""
    layout = flatbuf.layout_of(template)
    act, closing = _closing(n_silos, active)
    first = flatbuf.flat_tensors(layout, template)[0]
    st = _Streams(key, layout, n_silos, sigma_c, b_scale, first.device,
                  correction)
    gates = [float(x) for x in act]
    onehot = [1.0 if j == closing else 0.0 for j in range(n_silos)]

    def one(i, offset, t, k):
        rows = torch.empty((n_silos, t.numel()), dtype=torch.float32,
                           device=t.device)
        for a, b in _windows(t.numel()):
            u = [st.u(i, j, offset, a, b).mul_(gates[j])
                 for j in range(n_silos)]
            close = st.xi(torch.empty(b - a, dtype=torch.float32,
                                      device=t.device), i, k, offset, a, b)
            for j in range(n_silos):  # in index order, as admin_mask_row
                close = close - u[j] * (1.0 - onehot[j])
            for j in range(n_silos):
                rows[j, a:b] = u[j] * (1.0 - onehot[j]) + onehot[j] * close
        return rows.reshape((n_silos,) + tuple(t.shape))

    return _map_slices(layout, template, one)


def _map_slices(layout, tree: dict, fn) -> dict:
    """:func:`flatbuf.map_leaf_slices` with each tensor's index k in
    buffer order passed on: ``fn(i, offset, tensor, k)``."""
    count = itertools.count()
    return flatbuf.map_leaf_slices(
        layout, tree, lambda i, off, t: fn(i, off, t, next(count)))


def admin_mask_row(key, template: dict, n_silos: int, silo: int, sigma_c,
                   b_scale, active=None, correction=None, out=None) -> dict:
    """Silo ``silo``'s row of :func:`admin_masks` (the same streams),
    without the stack: O(P) for a non-closing silo, O(k P) for the closing
    one, so n handlers each drawing their own row cost the paper's O(n P).
    Returns an fp32 tree, views of ``out`` (a packed (P,) buffer of the
    template's layout) when it is given."""
    silo = int(silo)
    layout = flatbuf.layout_of(template)
    act, closing = _closing(n_silos, active)
    first = flatbuf.flat_tensors(layout, template)[0]
    if out is None:
        out = torch.empty(layout.total, dtype=torch.float32,
                          device=first.device)
    rows = flatbuf.unpack(layout, flatbuf.zero_padding(layout, out),
                          dtype=torch.float32)
    st = _Streams(key, layout, n_silos, sigma_c, b_scale, first.device,
                  correction)
    dst = flatbuf.flat_tensors(layout, rows)
    for k, (i, offset, t) in enumerate(flatbuf.leaf_slices(layout, template)):
        flat = dst[k].view(-1)
        for a, b in _windows(t.numel()):
            if silo != closing:
                flat[a:b] = st.u(i, silo, offset, a, b).mul_(
                    float(act[silo]))
                continue
            x = st.xi(flat[a:b], i, k, offset, a, b)
            for j in range(n_silos):
                if act[j] and j != closing:
                    x.sub_(st.u(i, j, offset, a, b))
    return rows


def admin_xi(key, template: dict, sigma_c) -> dict:
    """The xi streams of the admin construction alone (the key schedule of
    :func:`admin_masks`), the aggregate noise the masks telescope to."""
    layout = flatbuf.layout_of(template)
    first = flatbuf.flat_tensors(layout, template)[0]
    st = _Streams(key, layout, 1, sigma_c, None, first.device)

    def one(i, offset, t, k):
        out = torch.empty(t.numel(), dtype=torch.float32, device=t.device)
        for a, b in _windows(t.numel()):
            st.xi(out[a:b], i, k, offset, a, b)
        return out.reshape(t.shape)

    return _map_slices(layout, template, one)


def add_admin_noise(tree: dict, key, sigma_c, correction=None) -> dict:
    """``tree + (admin_xi(key) - correction)``, added in place into the
    tree's fp32 tensors window by window (no noise tree is held): the
    central tiers' aggregate noise under admin masks."""
    layout = flatbuf.layout_of(tree)
    first = flatbuf.flat_tensors(layout, tree)[0]
    st = _Streams(key, layout, 1, sigma_c, None, first.device, correction)
    for k, (i, offset, t) in enumerate(flatbuf.leaf_slices(layout, tree)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("add_admin_noise adds into contiguous fp32 "
                             "tensors")
        flat = t.view(-1)
        for a, b in _windows(t.numel()):
            st.xi(flat[a:b], i, k, offset, a, b, accumulate=True)
    return tree


def apply_admin_mask(grads: dict, masks: dict, silo: int) -> dict:
    """Silo-side: ``g_i + m_i``, row ``silo`` of the stacked masks."""
    def one(g, m):
        return (g.float() + m[silo]).to(g.dtype)

    return {k: [one(g, m) for g, m in zip(v, masks[k])]
            if isinstance(v, list) else one(v, masks[k])
            for k, v in grads.items()}


# ---------------------------------------------------------------------------
# Integer-ring masks (exact cancellation)

RING_SCALE_BITS = 16


def _ring_scale(clip: float, device) -> torch.Tensor:
    return torch.full((), (1 << RING_SCALE_BITS) / clip, dtype=torch.float32,
                      device=device)


def to_ring(x: torch.Tensor, clip: float) -> torch.Tensor:
    """fp values in ``[-clip, clip]`` to int32 fixed point (round half to
    even, as ``jnp.round``)."""
    return torch.round(torch.clamp(x.float(), -clip, clip)
                       * _ring_scale(clip, x.device)).to(torch.int32)


def from_ring(x: torch.Tensor, clip: float) -> torch.Tensor:
    return x.to(torch.float32) / _ring_scale(clip, x.device)


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` as the int32 of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def ring_mask_tree(grads_int: dict, key, silo: int, n_silos: int) -> dict:
    """Pairwise telescoping masks drawn uniformly from the int32 ring, leaf
    i keyed by ``key + 0x9E3779B9 * (i + 1)``: ``g + (r_silo - r_nxt)``,
    wrapping mod 2**32, so the sum over the ring is exactly zero. DP noise
    is added separately after the aggregation on this path."""
    layout = flatbuf.layout_of(grads_int)
    silo = int(silo)
    nxt = (silo + 1) % n_silos

    def one(i, offset, g):
        ki = fold_leaf(key, R_FOLD, i)
        shape, dev = tuple(g.shape), g.device
        r_i = prng.bits(prng.fold_in(ki, silo), shape, offset, dev)
        r_n = prng.bits(prng.fold_in(ki, nxt), shape, offset, dev)
        return _to_int32((g.to(torch.int64) + r_i - r_n) & M32)

    return flatbuf.map_leaf_slices(layout, grads_int, one)
