"""Packed wire codec of the TEE protocol tier. Port of
``repro/core/tee/wire.py``: a fixed 40-byte header plus the raw packed
``(P,)`` fp32 buffer (``core/flatbuf.PackedLayout``), so a masked update is
one contiguous buffer end to end (``np.frombuffer`` on receipt).

Message kinds:

* ``KIND_PICKLE``: the legacy tree fallback (pickle + uncompressed npz),
  for trees that are not all fp32 and for ``codec='pickle'``;
* ``KIND_FULL``: full packed params, a structure descriptor (leaf paths,
  shapes and stack counts as JSON, no array data) and the raw buffer; sent
  at session start and for resyncs;
* ``KIND_DELTA``: the per-round broadcast, the XOR of the new and previous
  packed buffers' fp32 words (``cached ^ delta == new`` exactly), tagged
  with a monotone epoch: a receiver that missed epochs raises
  :class:`StaleParamsError` and is resynced with a full message;
* ``KIND_UPDATE``: a handler's masked contribution, the raw packed buffer
  plus (loss, norm) in the header.

The header carries the layout fingerprint (16 bytes over the layout's
paths, shapes, stacks, sizes, offsets and total; the port has no JAX
treedef): receivers reject buffers of another layout, and the fingerprint
can join the attestation measurement through the wire config
(``components.py``). The port's framing is the JAX package's; its
descriptor is JSON where JAX pickles its treedef, so the codec id and the
fingerprints differ from JAX's by design.

Everything here is numpy on the host: a device tensor is copied to the host
once (:func:`pack_np`), and the handler moves what it receives onto its
device.
"""
from __future__ import annotations

import functools
import hashlib
import io
import json
import pickle
import struct
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import flatbuf
from repro_torch.core.flatbuf import PackedLayout

WIRE_CODEC_ID = "packed-wire-v1-json"

MAGIC = b"RPRW"
VERSION = 1

KIND_PICKLE = 0
KIND_FULL = 1
KIND_DELTA = 2
KIND_UPDATE = 3

# magic(4) version(1) kind(1) n_aux(2) epoch(8) layout_fp(16) body_len(8)
_HEADER = struct.Struct("<4sBBHQ16sQ")
_ZERO_FP = b"\x00" * 16


class WireFormatError(ValueError):
    """Malformed / truncated / mismatched wire message."""


class StaleParamsError(WireFormatError):
    """A delta broadcast the receiver cannot apply (missed epochs or no
    pinned params): the sender must resync with a KIND_FULL message."""


def _np(x) -> np.ndarray:
    """A host numpy array of a tensor (copied off its device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(tree: dict) -> list:
    return [t for v in tree.values()
            for t in (v if isinstance(v, (list, tuple)) else [v])]


# ---------------------------------------------------------------------------
# Layout identity


@functools.lru_cache(maxsize=256)
def layout_fingerprint(layout: PackedLayout) -> bytes:
    """16-byte identity of a packed layout: two parties agreeing on it agree
    on the meaning of every byte of the buffer."""
    desc = repr((layout.paths, layout.shapes, layout.stacks, layout.sizes,
                 layout.offsets, layout.total))
    return hashlib.sha256(desc.encode()).digest()[:16]


def packable(tree) -> bool:
    """True when the packed codec is lossless for ``tree``: a non-empty flat
    dict whose every leaf is an fp32 tensor or array."""
    if not isinstance(tree, dict) or not tree:
        return False
    for leaf in _leaves(tree):
        dt = getattr(leaf, "dtype", None)
        if dt not in (torch.float32, np.float32):
            return False
    return True


# ---------------------------------------------------------------------------
# Host-side pack/unpack


def pack_np(layout: PackedLayout, tree: dict) -> np.ndarray:
    """``tree`` as one fp32 ``(total,)`` numpy buffer, padding zero. Device
    tensors are packed on their device and copied to the host once."""
    tensors = flatbuf.flat_tensors(layout, tree)
    if all(isinstance(t, torch.Tensor) for t in tensors):
        return flatbuf.pack_tensors(
            layout, [t.detach() for t in tensors]).cpu().numpy()
    buf = np.zeros((layout.total,), np.float32)
    it = iter(tensors)
    for k, size, off in zip(layout.stacks, layout.sizes, layout.offsets):
        part = size // k if k else size
        for j in range(k or 1):
            buf[off + j * part:off + (j + 1) * part] = \
                _np(next(it)).astype(np.float32, copy=False).reshape(-1)
    return buf


def unpack_np(layout: PackedLayout, buf: np.ndarray) -> dict:
    """Inverse of :func:`pack_np`: views of ``buf`` shaped as the layout's
    leaves (a list of per-tensor views for a stacked leaf)."""
    tree = {}
    for path, shape, k, size, off in zip(layout.paths, layout.shapes,
                                         layout.stacks, layout.sizes,
                                         layout.offsets):
        piece = np.asarray(buf[off:off + size]).reshape(shape)
        tree[path] = list(piece) if k else piece
    return tree


def _layout_descriptor(layout: PackedLayout) -> bytes:
    return json.dumps({"paths": list(layout.paths),
                       "shapes": [list(s) for s in layout.shapes],
                       "stacks": list(layout.stacks)}).encode()


def _layout_from_descriptor(desc: bytes) -> PackedLayout:
    try:
        d = json.loads(desc)
        return flatbuf.build_layout(d["paths"], d["shapes"], d["stacks"])
    except (ValueError, KeyError, TypeError) as e:
        raise WireFormatError(f"malformed layout descriptor: {e}") from None


# ---------------------------------------------------------------------------
# Framing


@dataclass(frozen=True)
class WireMessage:
    kind: int
    epoch: int
    layout_fp: bytes
    aux: tuple
    body: memoryview  # zero-copy view into the received blob


def _encode(kind: int, body, aux: tuple = (), epoch: int = 0,
            layout_fp: bytes = _ZERO_FP) -> bytes:
    header = _HEADER.pack(MAGIC, VERSION, kind, len(aux), epoch, layout_fp,
                          len(body))
    auxb = struct.pack(f"<{len(aux)}d", *aux) if aux else b""
    return b"".join((header, auxb, bytes(body)))


def decode(blob) -> WireMessage:
    """Parse a wire message; the body stays a zero-copy memoryview."""
    view = memoryview(blob)
    if len(view) < _HEADER.size:
        raise WireFormatError(
            f"wire message truncated: {len(view)} bytes < "
            f"{_HEADER.size}-byte header")
    magic, version, kind, n_aux, epoch, fp, body_len = \
        _HEADER.unpack_from(view, 0)
    if magic != MAGIC:
        raise WireFormatError(f"bad wire magic {bytes(magic)!r}")
    if version != VERSION:
        raise WireFormatError(f"unsupported wire version {version}")
    aux_off = _HEADER.size
    body_off = aux_off + 8 * n_aux
    if len(view) != body_off + body_len:
        raise WireFormatError(
            f"wire message length mismatch: header declares "
            f"{body_off + body_len} bytes, got {len(view)}")
    aux = struct.unpack_from(f"<{n_aux}d", view, aux_off) if n_aux else ()
    return WireMessage(kind=kind, epoch=epoch, layout_fp=bytes(fp), aux=aux,
                       body=view[body_off:])


# ---------------------------------------------------------------------------
# Tree payloads


@dataclass(frozen=True)
class _Slot:
    """Where leaf ``index`` sits in a pickled tree's skeleton."""
    index: int


def _split_tree(obj, leaves: list):
    if isinstance(obj, dict):
        return {k: _split_tree(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_split_tree(v, leaves) for v in obj)
    leaves.append(_np(obj))
    return _Slot(len(leaves) - 1)


def _fill_tree(obj, leaves: list):
    if isinstance(obj, dict):
        return {k: _fill_tree(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill_tree(v, leaves) for v in obj)
    return leaves[obj.index] if isinstance(obj, _Slot) else obj


def _encode_pickle_tree(tree) -> bytes:
    """The legacy wire format: the leaves as an uncompressed npz, the
    nested dict/list skeleton pickled beside them, framed."""
    leaves: list = []
    skeleton = _split_tree(tree, leaves)
    buf = io.BytesIO()
    np.savez(buf, *leaves)
    return _encode(KIND_PICKLE, pickle.dumps((buf.getvalue(), skeleton)))


def encode_tree(tree, codec: str = "packed", epoch: int = 0) -> bytes:
    """Serialize a tree: packed KIND_FULL when lossless (a flat dict of fp32
    leaves), the pickle fallback otherwise (or when ``codec='pickle'``)."""
    if codec == "pickle" or not packable(tree):
        return _encode_pickle_tree(tree)
    layout = flatbuf.layout_of(tree)
    return encode_full(layout, pack_np(layout, tree), epoch=epoch)


def decode_tree(blob):
    """Inverse of :func:`encode_tree`, with numpy leaves on the host."""
    msg = decode(blob)
    if msg.kind == KIND_PICKLE:
        data, skeleton = pickle.loads(msg.body)
        with np.load(io.BytesIO(data)) as z:
            leaves = [z[k] for k in z.files]
        return _fill_tree(skeleton, leaves)
    if msg.kind == KIND_FULL:
        layout, buf = decode_full(msg)
        return unpack_np(layout, buf)
    raise WireFormatError(
        f"decode_tree got a kind-{msg.kind} message (delta/update messages "
        f"need the session's pinned layout)")


# ---------------------------------------------------------------------------
# Packed params broadcast: FULL + XOR-DELTA


def encode_full(layout: PackedLayout, buf: np.ndarray, epoch: int = 0) -> bytes:
    desc = _layout_descriptor(layout)
    body = struct.pack("<I", len(desc)) + desc + \
        np.ascontiguousarray(buf, np.float32).tobytes()
    return _encode(KIND_FULL, body, epoch=epoch,
                   layout_fp=layout_fingerprint(layout))


def decode_full(msg: WireMessage) -> tuple:
    if msg.kind != KIND_FULL:
        raise WireFormatError(f"expected KIND_FULL, got kind {msg.kind}")
    if len(msg.body) < 4:
        raise WireFormatError("KIND_FULL body truncated (no descriptor)")
    (desc_len,) = struct.unpack_from("<I", msg.body, 0)
    if len(msg.body) < 4 + desc_len:
        raise WireFormatError("KIND_FULL descriptor truncated")
    layout = _layout_from_descriptor(bytes(msg.body[4:4 + desc_len]))
    if layout_fingerprint(layout) != msg.layout_fp:
        raise WireFormatError(
            "layout fingerprint in header does not match the descriptor "
            "(tampered or corrupted message)")
    raw = msg.body[4 + desc_len:]
    if len(raw) != 4 * layout.total:
        raise WireFormatError(
            f"KIND_FULL buffer is {len(raw)} bytes, layout needs "
            f"{4 * layout.total}")
    return layout, np.frombuffer(raw, np.float32)


def encode_delta(layout: PackedLayout, old_buf: np.ndarray,
                 new_buf: np.ndarray, epoch: int) -> bytes:
    """XOR of the fp32 words of two packed buffers: the per-round
    broadcast, reproducing the new buffer bit-exactly from the cached one."""
    delta = np.bitwise_xor(
        np.ascontiguousarray(old_buf, np.float32).view(np.uint32),
        np.ascontiguousarray(new_buf, np.float32).view(np.uint32))
    return _encode(KIND_DELTA, delta.tobytes(), epoch=epoch,
                   layout_fp=layout_fingerprint(layout))


def apply_delta(layout: PackedLayout, cached: np.ndarray,
                msg: WireMessage) -> np.ndarray:
    if msg.kind != KIND_DELTA:
        raise WireFormatError(f"expected KIND_DELTA, got kind {msg.kind}")
    if msg.layout_fp != layout_fingerprint(layout):
        raise WireFormatError("delta broadcast for a different packed layout")
    if len(msg.body) != 4 * layout.total:
        raise WireFormatError(
            f"delta is {len(msg.body)} bytes, layout needs {4 * layout.total}")
    delta = np.frombuffer(msg.body, np.uint32)
    return np.bitwise_xor(
        np.ascontiguousarray(cached, np.float32).view(np.uint32),
        delta).view(np.float32)


# ---------------------------------------------------------------------------
# Masked-update upload


def encode_update(layout: PackedLayout, buf: np.ndarray, loss: float,
                  norm: float, epoch: int = 0) -> bytes:
    """A handler's masked contribution: raw packed buffer + (loss, norm)."""
    return _encode(KIND_UPDATE,
                   np.ascontiguousarray(buf, np.float32).tobytes(),
                   aux=(float(loss), float(norm)), epoch=epoch,
                   layout_fp=layout_fingerprint(layout))


def decode_update(msg: WireMessage, layout: PackedLayout) -> tuple:
    """-> (fp32 (total,) view, loss, norm); rejects layout mismatches."""
    if msg.kind != KIND_UPDATE:
        raise WireFormatError(f"expected KIND_UPDATE, got kind {msg.kind}")
    if msg.layout_fp != layout_fingerprint(layout):
        raise WireFormatError(
            "masked update does not match the aggregator's packed layout "
            "(fingerprint mismatch)")
    if len(msg.body) != 4 * layout.total:
        raise WireFormatError(
            f"masked update is {len(msg.body)} bytes, layout needs "
            f"{4 * layout.total}")
    if len(msg.aux) != 2:
        raise WireFormatError(
            f"masked update carries {len(msg.aux)} aux scalars, expected 2 "
            f"(loss, norm)")
    buf = np.frombuffer(msg.body, np.float32)
    loss, norm = msg.aux
    return buf, loss, norm
