"""Manifest-verified, atomically committed checkpoints. Port of
``repro/checkpoint/checkpointer.py``, in its on-disk format, so that a
checkpoint crosses between the packages both ways:

    <dir>/step_00000123.tmp/...   (written)
    <dir>/step_00000123/          (renamed on commit)
        manifest.json             {"step", "entries": [{path, file, shape,
                                   dtype, sha256}], "extra"}
        arr_00000.npy ...         one file a leaf, in jax.tree_util order

A leaf's ``path`` is JAX's ``_tree_paths`` name: dict keys as they are,
a NamedTuple field as ``.field``, a sequence index as ``[i]``, joined by
``/``. Restore checks each file's hash and shape and raises ``KeyError``
for a leaf the checkpoint lacks.

A tree is either a nested dict / list / NamedTuple of tensors and arrays
(restored into new tensors of the template's dtype and device, as JAX
returns new arrays) or the port's ``TrainState``. The state is no pytree:
its parameters are views of the packed ``opt_state["master"]`` buffer, and
its moments are buffers of the same ``PackedLayout``. It is written as
JAX's ``TrainState`` is flattened (``.params/<leaf>``,
``.opt_state/{count,m,master,mu,v}[/<leaf>]``, ``.noise_state/.prev_key``,
``.has_prev``, ``.prev_active``, ``.step``, ``.clip_bound``), each leaf the
contiguous slice ``buf[off:off + size]`` of its buffer in JAX's shape, in
JAX's dtypes (``count`` and ``step`` int32, ``prev_key`` uint32 ``(2,)``,
the flags bool). Save moves one leaf at a time to the host; restore
``copy_``s each leaf into its slice in place, so ``master``, the moments
and the parameters viewing ``master`` keep their storage, and the packed
padding stays zero. The ``.params`` leaves equal ``master``'s in fp32:
restore checks their hash and shape and takes the values from ``master``.
With bf16 weights (``TrainState.weights``) the ``.params`` leaves of bf16
dtype are the bf16 buffer's and restore loads them into it; in a mixed
tree the fp32 leaves stay the master's, as in an fp32 state.

A bf16 leaf is stored as JAX's ``np.save`` stores an ``ml_dtypes``
bfloat16 array, which the port does not import: its raw 2-byte values
under the ``.npy`` descr ``<V2``, ``"dtype": "bfloat16"`` in the
manifest. On the host such a leaf is a ``V2`` array of the raw values
(:func:`_host`, :func:`_tensor`). JAX's own ``restore`` cannot read one
back (numpy has no cast from ``V2`` to ``bfloat16``).

Each leaf is hashed on a worker thread beside its write or read (a
chunk at a time, in order). ``timings`` (a dict, optional) accumulates
where a save or a restore spent its time: ``d2h_s``, ``write_s``,
``hash_s`` (save); ``read_s``, ``hash_s``, ``h2d_s`` (restore); and
``bytes``. The hash overlaps the write or read, so the parts add up to
more than the whole.
"""
from __future__ import annotations

import hashlib
import io
import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import flatbuf


@dataclass
class _Leaf:
    path: str
    shape: tuple
    get: Callable[[], np.ndarray]               # the leaf on the host
    put: Optional[Callable[[np.ndarray], None]]  # None: checked, not loaded


def _is_train_state(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "layout") \
        and hasattr(tree, "opt_state")


BF16_RAW = np.dtype("V2")   # a bf16 leaf's raw values on the host


def _host(x) -> np.ndarray:
    """A leaf on the host; a bf16 tensor as its raw values (``V2``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(BF16_RAW)
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor sharing its memory; ``V2`` raw values as
    bf16."""
    if a.dtype == BF16_RAW:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(a)


def _walk(tree, prefix: tuple = ()):
    """``(keys, leaf)`` in ``jax.tree_util`` order; None is an empty tree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), prefix + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _rebuild(tree, values: dict, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``values[path]`` in
    the template leaf's type, dtype and device."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, f), values,
                                     prefix + ("." + f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, values, prefix + (f"[{i}]",))
                          for i, x in enumerate(tree))
    arr = values["/".join(prefix)]
    if isinstance(tree, torch.Tensor):
        return _tensor(np.ascontiguousarray(arr)).to(
            device=tree.device, dtype=tree.dtype)
    return arr.astype(tree.dtype) if isinstance(tree, np.ndarray) else arr


def _generic_leaves(tree, values: dict) -> list:
    out = []
    for keys, leaf in _walk(tree):
        path = "/".join(keys)

        def put(a, path=path):
            values[path] = a.copy()
        out.append(_Leaf(path, tuple(np.shape(leaf)),
                         lambda leaf=leaf: _host(leaf), put))
    return out


def _buffer_leaves(prefix: str, layout, buf: torch.Tensor, load: bool,
                   bf16: Optional[torch.Tensor] = None) -> list:
    """An entry for each leaf of the layout, its slice of ``buf``; with
    ``bf16`` (the packed bf16 weights) a bf16 leaf's slice of that buffer
    instead, which always loads (the fp32 leaves are ``buf``'s and load as
    ``load`` says)."""
    out = []
    for path, shape, size, off, dt in zip(layout.paths, layout.shapes,
                                          layout.sizes, layout.offsets,
                                          layout.dtypes):
        half = bf16 is not None and dt == "bfloat16"
        view = (bf16 if half else buf)[off:off + size].view(shape)

        def put(a, view=view):
            view.copy_(_tensor(a).view(view.shape))
        out.append(_Leaf(prefix + path.replace(".", "/"), tuple(shape),
                         lambda view=view: _host(view),
                         put if load or half else None))
    return out


def _state_leaves(state, scalars: dict) -> list:
    """The leaves of the port's ``TrainState`` in JAX's order and names;
    the scalar ones load into ``scalars`` (path -> array)."""
    def scalar(path, value, dtype, shape=()):
        def put(a, path=path):
            scalars[path] = a.copy()
        return _Leaf(path, shape, lambda: np.asarray(value, dtype), put)

    layout = state.layout
    leaves = _buffer_leaves(".params/", layout, state.opt_state["master"],
                            load=False, bf16=state.weights)
    for k in sorted(state.opt_state):
        v = state.opt_state[k]
        if isinstance(v, torch.Tensor):
            leaves += _buffer_leaves(f".opt_state/{k}/", layout, v, load=True)
        else:
            leaves.append(scalar(f".opt_state/{k}", v, np.int32))
    ns = state.noise_state
    leaves.append(scalar(".noise_state/.prev_key", ns.prev_key, np.uint32,
                         (2,)))
    leaves.append(scalar(".noise_state/.has_prev", ns.has_prev, np.bool_))
    if ns.prev_active is not None:
        pa = np.asarray(ns.prev_active, bool)
        leaves.append(scalar(".noise_state/.prev_active", pa, np.bool_,
                             pa.shape))
    leaves.append(scalar(".step", state.step, np.int32))
    leaves.append(_Leaf(".clip_bound", (),
                        lambda: _host(state.clip_bound).astype(np.float32),
                        lambda a: scalars.__setitem__(".clip_bound",
                                                      a.copy())))
    return leaves


def tree_paths(tree) -> list:
    """The entry names a checkpoint of ``tree`` carries (JAX's
    ``_tree_paths`` of the matching JAX tree)."""
    leaves = _state_leaves(tree, {}) if _is_train_state(tree) \
        else _generic_leaves(tree, {})
    return [leaf.path for leaf in leaves]


CHUNK = 64 << 20  # bytes a write, read or hash update


class _Hasher:
    """sha256 on one worker thread, fed in order. hashlib releases the GIL
    on large updates, so the hash of a leaf runs beside its file's write
    or read; ``s`` is the worker's busy time."""

    def __init__(self, pool):
        self.pool, self.h, self.s, self.pending = pool, hashlib.sha256(), \
            0.0, []

    def feed(self, b) -> None:
        self.pending.append(self.pool.submit(self._update, b))

    def _update(self, b) -> None:
        t0 = time.perf_counter()
        self.h.update(b)
        self.s += time.perf_counter() - t0

    def hexdigest(self) -> str:
        for f in self.pending:
            f.result()
        return self.h.hexdigest()


def _add(timings: Optional[dict], key: str, v: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + v


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _write_npy(path: Path, arr: np.ndarray, pool) -> tuple:
    """``np.save``'s bytes for a C-contiguous ``arr``, written in chunks
    and hashed beside the write: ``(sha256, write s, hash s)``."""
    head = io.BytesIO()
    header = np.lib.format.header_data_from_array_1_0(arr)
    if arr.dtype == BF16_RAW:
        header["descr"] = "<V2"  # ml_dtypes' bfloat16, as np.save writes it
    np.lib.format.write_array_header_1_0(head, header)
    data = memoryview(arr.reshape(-1).view(np.uint8))
    hasher = _Hasher(pool)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for part in [memoryview(head.getvalue())] + [
                data[a:a + CHUNK] for a in range(0, len(data), CHUNK)]:
            hasher.feed(part)
            f.write(part)
    write_s = time.perf_counter() - t0
    return hasher.hexdigest(), write_s, hasher.s


def save(ckpt_dir, step: int, tree, extra: Optional[dict] = None,
         timings: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = _state_leaves(tree, {}) if _is_train_state(tree) \
        else _generic_leaves(tree, {})
    _sync()
    entries = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for i, leaf in enumerate(leaves):
            t0 = time.perf_counter()
            arr = np.asarray(leaf.get(), order="C")
            _add(timings, "d2h_s", time.perf_counter() - t0)
            fname = f"arr_{i:05d}.npy"
            digest, write_s, hash_s = _write_npy(tmp / fname, arr, pool)
            _add(timings, "write_s", write_s)
            _add(timings, "hash_s", hash_s)
            _add(timings, "bytes", (tmp / fname).stat().st_size)
            entries.append({"path": leaf.path, "file": fname,
                            "shape": list(arr.shape),
                            "dtype": "bfloat16" if arr.dtype == BF16_RAW
                            else str(arr.dtype), "sha256": digest})
            del arr
    manifest = {"step": step, "entries": entries, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp")
                   and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def _read(path: Path, hasher: Optional[_Hasher]) -> np.ndarray:
    """The file's bytes in one uninitialised buffer, read a chunk at a time
    (one read call stops short of 2 GiB), each chunk hashed beside the
    next one's read."""
    n = path.stat().st_size
    raw = np.empty(n, np.uint8)
    mv = memoryview(raw)
    with open(path, "rb", buffering=0) as f:
        got = 0
        while got < n:
            k = f.readinto(mv[got:min(got + CHUNK, n)])
            if not k:
                raise IOError(f"{path}: short read")
            if hasher is not None:
                hasher.feed(mv[got:got + k])
            got += k
    return raw


def _parse_npy(raw: np.ndarray) -> np.ndarray:
    """The array of an ``.npy`` file's bytes, a view of ``raw``."""
    head = io.BytesIO(bytes(raw[:65536]))
    version = np.lib.format.read_magic(head)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(head)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(head)
    arr = np.frombuffer(raw, dtype=dtype, count=math.prod(shape),
                        offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def restore(ckpt_dir, tree_template, step: Optional[int] = None,
            shardings=None, verify: bool = True,
            timings: Optional[dict] = None):
    """Restore into the template's structure: ``(tree, extra, step)``.
    A ``TrainState`` template is filled in place (its buffers keep their
    storage) and returned with its scalars replaced. ``shardings`` is
    accepted for the JAX signature and ignored: the port's state lies on
    one device. Every entry's presence and shape is checked before any
    leaf is loaded, so a ``KeyError`` or ``ValueError`` leaves the
    template untouched."""
    del shardings
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["entries"]}

    state = _is_train_state(tree_template)
    loaded: dict = {}
    leaves = _state_leaves(tree_template, loaded) if state \
        else _generic_leaves(tree_template, loaded)
    for leaf in leaves:
        e = by_path.get(leaf.path)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {leaf.path!r}")
        if tuple(e["shape"]) != tuple(leaf.shape):
            raise ValueError(f"{leaf.path!r}: checkpoint shape "
                             f"{tuple(e['shape'])} != template {leaf.shape}")
    with ThreadPoolExecutor(max_workers=1) as pool:
        for leaf in leaves:
            e = by_path[leaf.path]
            hasher = _Hasher(pool) if verify else None
            t0 = time.perf_counter()
            raw = _read(d / e["file"], hasher)
            _add(timings, "read_s", time.perf_counter() - t0)
            _add(timings, "bytes", len(raw))
            if verify:
                digest = hasher.hexdigest()
                _add(timings, "hash_s", hasher.s)
                if digest != e["sha256"]:
                    raise IOError(f"integrity check failed for "
                                  f"{leaf.path!r} ({e['file']}): hash "
                                  f"mismatch")
            if leaf.put is None:
                continue
            arr = _parse_npy(raw)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{leaf.path!r}: checkpoint shape "
                                 f"{arr.shape} != template {leaf.shape}")
            t1 = time.perf_counter()
            leaf.put(arr)
            _sync()
            _add(timings, "h2d_s", time.perf_counter() - t1)
            del raw, arr
    if not state:
        return _rebuild(tree_template, loaded), manifest["extra"], step
    return _restored_state(tree_template, loaded), manifest["extra"], step


def _restored_state(state, s: dict):
    """``state`` after its buffers were filled in place: the padding zeroed
    again, the scalar leaves put back in the port's types."""
    opt_state = dict(state.opt_state)
    for k, v in opt_state.items():
        if isinstance(v, torch.Tensor):
            flatbuf.zero_padding(state.layout, v)
        else:
            opt_state[k] = int(s[f".opt_state/{k}"])
    ns = state.noise_state
    pa = s.get(".noise_state/.prev_active")
    ns = ns._replace(
        prev_key=tuple(int(x) for x in s[".noise_state/.prev_key"]),
        has_prev=bool(s[".noise_state/.has_prev"]),
        prev_active=None if pa is None else np.asarray(pa, bool))
    dev = state.opt_state["master"].device
    clip = torch.tensor(float(s[".clip_bound"]), dtype=torch.float32,
                        device=dev)
    return state._replace(opt_state=opt_state, noise_state=ns,
                          step=int(s[".step"]), clip_bound=clip)


def garbage_collect(ckpt_dir, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
