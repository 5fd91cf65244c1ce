"""The CITADEL++ component protocol (paper sections 3.2-3.3), run end to
end in one process: management service, KDS, admin, data-handling and
model-updating components, each in its own simulated trust domain. Port of
``repro/core/tee/components.py``.

This is the wire tier: serialized, sealed payloads between components. The
barrier tier (``distributed/steps.py``) computes the same sum in one step;
the tests hold the two to each other.

Workflow (paper Fig. 1):
  1. owners encrypt assets -> untrusted storage
  2-3. owners attest the KDS, upload keys and the training config
  4-5. the management service deploys the components
  6-7. components register, attest to the KDS and get their keys
  loop: the admin distributes the round's keys -> each handler computes its
        clipped, DP-masked contribution (the model owner's code sandboxed)
        -> the updater aggregates (it sees only masked contributions) ->
        the admin advances

Where the work runs: each handler's forward/backward (the model owner's
``grad_fn``) and its contribution (``DPPipeline.silo_contribution``, one
``clip_mask`` launch on a CUDA device) run on the handler's device, on the
handler's own CUDA stream (the fault-tolerant rounds run the handlers on
worker threads, and a hung handler finishes late, beside the next round),
and the ``(P,)`` contribution leaves it once, to be sealed: that host copy
synchronises the handler's stream, so only numpy leaves a handler.
Everything else is numpy on the host, as in the JAX package: the codec,
the channels, the Merkle tag, and the updater's decrypt, decode, accumulate
and divide. The sharded accumulator's threads touch numpy only.

Speculative rounds: a handler keeps a key-tagged cache of at most two of
its xi streams, device tensors drawn by the ``noise_stream`` kernel (round
t's xi is round t+1's xi_{t-1}; the driver prefetches round t+1's xi while
round t closes), and its contribution reads them from memory (the
external-stream ``clip_mask``). A tag is the raw key's bytes, so a resync,
rejoin or skipped round misses and draws anew; serial rounds draw the
streams inside ``clip_mask``, bit for bit the same values.

Admin masks (``mask_mode='admin'``, the paper-faithful construction): each
handler draws its own O(P) mask row; the admin draws the one O(k P)
closing row once a round (:meth:`Admin.closing_mask_row`) and ships it to
the closing handler alone, which uses it instead of drawing it, bit for
bit the same.
"""
from __future__ import annotations

import contextlib
import hashlib
import hmac
import queue
import struct
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import PrivacyConfig
from repro_torch.core import flatbuf
from repro_torch.core.barrier import BarrierKeys, step_keys
from repro_torch.core.dp_pipeline import DPPipeline
from repro_torch.core.masking import _raw
from repro_torch.core.noise_correction import NoiseState, init_state
from repro_torch.core.privacy import PrivacyLedger
from repro_torch.core.tee import merkle, wire
from repro_torch.core.tee.attestation import (AttestationService,
                                              LaunchPolicy, measure_config,
                                              measure_modules)
from repro_torch.core.tee.channels import SecureChannel, spend_report_mac
from repro_torch.core.tee.kds import KeyDistributionService
from repro_torch.core.tee.sandbox import Sandbox


def _ser(tree) -> bytes:
    """A tree serialized for the wire or for sealed storage (JAX's
    ``components._ser``): the packed flat-buffer codec when lossless, the
    pickle + npz fallback otherwise (``core/tee/wire.py``)."""
    return wire.encode_tree(tree)


def _deser(blob: bytes):
    """Inverse of :func:`_ser`, numpy leaves on the host."""
    return wire.decode_tree(blob)


def _guarded_modules():
    """The service code whose measurement the KDS gates key release on: the
    DP engine, the privacy ledger, the packed layout and wire codec, and
    the pieces they compose (the port's own modules)."""
    import repro_torch.core.barrier as _b
    import repro_torch.core.clipping as _c
    import repro_torch.core.dp_pipeline as _p
    import repro_torch.core.flatbuf as _f
    import repro_torch.core.masking as _m
    import repro_torch.core.privacy.bounds as _pb
    import repro_torch.core.privacy.ledger as _pl
    import repro_torch.core.tee.merkle as _mk
    import repro_torch.core.tee.wire as _w
    return [_p, _pl, _pb, _b, _c, _m, _f, _w, _mk]


def _bind_configs(code: str, ledger_config: dict, wire_config: dict) -> str:
    """The code measurement extended with the session's launch
    configuration (per-silo budgets and the wire codec identity, optionally
    pinned to the packed layout's fingerprint)."""
    if not ledger_config and not wire_config:
        return code
    cfg = {"ledger": ledger_config, "wire": wire_config}
    return hashlib.sha256((code + measure_config(cfg)).encode()).hexdigest()


# ---------------------------------------------------------------------------
# Sharded round accumulation


class _ShardedAccumulator:
    """Accumulate per-silo ``(P,)`` fp32 buffers across worker threads,
    bit-identical to the serial left fold: each worker owns a contiguous
    slice of the parameter axis and folds the incoming buffers' matching
    slices in arrival (= silo) order, so every element is added in the
    serial order (numpy's add releases the GIL)."""

    def __init__(self, first: np.ndarray, workers: int):
        self._acc = np.array(first, np.float32, copy=True)
        n = self._acc.shape[0]
        workers = max(1, min(int(workers), n))
        bounds = np.linspace(0, n, workers + 1).astype(int)
        self._spans = [(int(lo), int(hi)) for lo, hi in
                       zip(bounds[:-1], bounds[1:]) if hi > lo]
        self._queues = [queue.Queue() for _ in self._spans]
        self._errors: list = []
        self._threads = []
        for (lo, hi), q in zip(self._spans, self._queues):
            t = threading.Thread(target=self._worker, args=(lo, hi, q),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, lo: int, hi: int, q: queue.Queue):
        acc = self._acc[lo:hi]
        while True:
            buf = q.get()
            if buf is None:
                return
            try:
                acc += buf[lo:hi]
            except Exception as e:  # surfaced by result()
                self._errors.append(e)

    def add(self, buf: np.ndarray) -> None:
        for q in self._queues:
            q.put(buf)

    def result(self) -> np.ndarray:
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]
        return self._acc


# ---------------------------------------------------------------------------
# Untrusted storage (everything at rest is encrypted)


class UntrustedStorage:
    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def put(self, asset_id: str, blob: bytes):
        self.blobs[asset_id] = blob

    def get(self, asset_id: str) -> bytes:
        try:
            return self.blobs[asset_id]
        except KeyError:
            raise KeyError(
                f"unknown asset {asset_id!r} in untrusted storage "
                f"({len(self.blobs)} assets held)") from None


# ---------------------------------------------------------------------------
# Components


@dataclass
class Component:
    name: str
    service: "ManagementService"
    report: object = None

    def __post_init__(self):
        # the ledger and wire configs in force at launch: a component
        # deployed under other terms attests to another value
        self.launch_ledger_config = dict(self.service.ledger_config) \
            if self.service is not None else {}
        self.launch_wire_config = dict(self.service.wire_config) \
            if self.service is not None else {}

    def measurement(self) -> str:
        code = measure_modules(_guarded_modules())
        return _bind_configs(code, self.launch_ledger_config,
                             self.launch_wire_config)

    def attest(self, policy: LaunchPolicy):
        self.report = self.service.attestation.issue(
            self.name, self.measurement(), policy.hash(),
            nonce=self.name + "-n0")
        return self.report


def _on_device(tree: dict, device) -> dict:
    """Copies of a numpy tree's leaves on ``device``. Never aliases: the
    handler's pinned buffer must stay what the broadcasts XOR against,
    whatever the model owner's code does to its params."""
    return {k: [torch.tensor(t, device=device) for t in v]
            if isinstance(v, list) else torch.tensor(v, device=device)
            for k, v in tree.items()}


def _tag(key) -> bytes:
    """A stream's cache tag: its raw key's 8 bytes."""
    return np.asarray(_raw(key), np.uint32).tobytes()


@dataclass
class DataHandler(Component):
    """One per dataset owner: runs the model owner's sandboxed code on the
    silo's data (on ``device``) and emits a sealed, clipped, DP-masked
    contribution through the shared :class:`DPPipeline` engine."""
    silo_idx: int = 0
    data: Optional[dict] = None
    sandbox: Sandbox = field(default_factory=Sandbox)
    channel: Optional[SecureChannel] = None
    # the attested admin this handler trusts for budget verdicts; when set,
    # a caller-supplied verdict is ignored
    admin: Optional["Admin"] = None
    codec: str = "packed"
    device: torch.device = torch.device("cpu")
    # the chaos harness's hook (core/tee/faults.py), called with the silo
    # index at compute_update entry: an injected crash raises there, a hang
    # sleeps. None outside chaos runs; not part of the measured code
    fault_hook: Optional[Callable] = None

    def __post_init__(self):
        super().__post_init__()
        # the delta broadcast's cache: the pinned packed buffer, its layout,
        # the pinned fingerprint and the epoch of the last applied broadcast
        self._cached_buf: Optional[np.ndarray] = None
        self._cached_layout = None
        self._params_epoch: int = -1
        pinned = self.launch_wire_config.get("layout")
        self._pinned_fp: Optional[bytes] = bytes.fromhex(pinned) \
            if pinned else None
        # digest of the last sealed update: this handler's leaf of the
        # round's Merkle batch tag
        self.last_leaf: Optional[bytes] = None
        # speculative rounds: at most two of this silo's xi streams, tagged
        # by their raw key's bytes (module docstring)
        self.speculative: bool = False
        self._stream_cache: dict = {}
        self._spec_hits: int = 0
        self._spec_pipe: Optional[DPPipeline] = None
        self._cuda_stream: Optional[torch.cuda.Stream] = None

    def _check_pin(self, fp: bytes) -> None:
        if self._pinned_fp is not None and fp != self._pinned_fp:
            raise wire.WireFormatError(
                f"{self.name}: broadcast layout fingerprint does not match "
                f"the attested session layout (possible model substitution)")

    def _sync_params(self, params_blob: bytes) -> dict:
        """Decode a params broadcast to a numpy tree. FULL (re)pins the
        packed cache; DELTA XORs onto it (bit-exact) and raises
        :class:`wire.StaleParamsError` when this handler missed epochs;
        pickle blobs pass through. The tree is views of the cache."""
        msg = wire.decode(params_blob)
        if msg.kind == wire.KIND_PICKLE:
            return wire.decode_tree(params_blob)
        if msg.kind == wire.KIND_FULL:
            layout, buf = wire.decode_full(msg)
            self._check_pin(msg.layout_fp)
            if self._pinned_fp is None:
                self._pinned_fp = msg.layout_fp
            self._cached_layout, self._cached_buf = layout, buf.copy()
            self._params_epoch = msg.epoch
            return wire.unpack_np(layout, self._cached_buf)
        if msg.kind == wire.KIND_DELTA:
            if self._cached_buf is None:
                raise wire.StaleParamsError(
                    f"{self.name}: delta broadcast but no pinned params "
                    f"(never synced): need a full resync")
            if msg.epoch != self._params_epoch + 1:
                raise wire.StaleParamsError(
                    f"{self.name}: delta epoch {msg.epoch} does not follow "
                    f"cached epoch {self._params_epoch} (missed rounds): "
                    f"need a full resync")
            self._check_pin(msg.layout_fp)
            self._cached_buf = wire.apply_delta(self._cached_layout,
                                                self._cached_buf, msg)
            self._params_epoch = msg.epoch
            return wire.unpack_np(self._cached_layout, self._cached_buf)
        raise wire.WireFormatError(
            f"{self.name}: unexpected wire kind {msg.kind} in params sync")

    def _remember_stream(self, tag: bytes, stream: torch.Tensor) -> None:
        """Insert with a cap of two entries: at any round the only reusable
        streams are xi(t), next round's xi_{t-1}, and a prefetched
        xi(t+1)."""
        cache = self._stream_cache
        cache[tag] = stream
        while len(cache) > 2:
            cache.pop(next(iter(cache)))

    def _round_streams(self, pipe: DPPipeline, keys: BarrierKeys,
                       state: NoiseState, use_prev: bool) -> tuple:
        """This round's xi and xi_{t-1} streams from the cache, or drawn by
        :meth:`DPPipeline.noise_stream` on a miss (a wrong or stale tag, or
        another length); every hit is counted in ``_spec_hits``."""
        xi_tag = _tag(keys.key_xi)
        xi = self._stream_cache.get(xi_tag)
        if xi is None or xi.shape[0] != pipe.layout.total:
            xi = pipe.noise_stream(keys.key_xi, self.silo_idx, self.device)
        else:
            self._spec_hits += 1
        self._remember_stream(xi_tag, xi)
        xp = None
        if use_prev:
            xp = self._stream_cache.get(_tag(state.prev_key))
            if xp is None or xp.shape[0] != pipe.layout.total:
                xp = pipe.noise_stream(state.prev_key, self.silo_idx,
                                       self.device)
            else:
                self._spec_hits += 1
        return xi, xp

    def prefetch_round(self, keys: BarrierKeys) -> None:
        """Draw round t+1's xi while round t closes (the driver calls this
        between handing the close to the updater's thread and collecting
        it). A membership change leaves xi valid (a stream depends on its
        key and silo only), and a resync or reschedule that lands another
        key misses the cache."""
        if not self.speculative or self._spec_pipe is None:
            return
        tag = _tag(keys.key_xi)
        if tag not in self._stream_cache:
            self._remember_stream(tag, self._spec_pipe.noise_stream(
                keys.key_xi, self.silo_idx, self.device))

    def _masked_contrib(self, pipe: DPPipeline, grads: dict, active,
                        keys: BarrierKeys, state: NoiseState, clip_bound,
                        admin_row=None):
        """norm -> clip scale -> ``silo_contribution`` on the gradients'
        device. On the packed pairwise path the contribution is one
        ``clip_mask`` launch. Serial rounds draw its xi and xi_{t-1}
        streams in the kernel: the values JAX's ``DPPipeline.noise_stream``
        draws for the same (key, silo), which its handler passes in as
        arguments. Speculative rounds pass them in, from the cache or
        :meth:`_round_streams`' draw (the external-stream kernel).
        ``admin_row``: under admin masks, the closing row the admin drew
        (this handler's row only when it closes the round)."""
        dev = next(iter(flatbuf.flat_tensors(pipe.layout, grads))).device
        with torch.no_grad():
            # a 0-dim tensor: C / norm is then a true division, as JAX's
            bound = torch.full((), float(clip_bound), dtype=torch.float32,
                               device=dev)
            norm = pipe.norm_tree(grads)
            scale = pipe.clip_scale(norm, bound)
            xi = xp = None
            if self.speculative and pipe.priv.mask_mode == "pairwise" \
                    and pipe.policy.mode == "packed":
                xi, xp = self._round_streams(pipe, keys, state,
                                             pipe.priv.noise_lambda > 0.0)
                for x in (xi, xp):
                    if x is not None and x.is_cuda:
                        # drawn on another stream (a prefetch): not freed
                        # for reuse before this stream has read it
                        x.record_stream(torch.cuda.current_stream(dev))
            return pipe.silo_contribution(grads, self.silo_idx, scale,
                                          active, keys, state, bound,
                                          admin_row=admin_row, xi=xi,
                                          xp=xp), norm

    def _stream(self):
        """The handler's own CUDA stream as a context, made once and made
        to wait for the calling thread's current stream (the data and any
        prefetched stream were enqueued there); nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._cuda_stream is None:
            self._cuda_stream = torch.cuda.Stream(device=self.device)
        self._cuda_stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._cuda_stream)

    def compute_update(self, params_blob: bytes, grad_fn: Callable,
                       priv: PrivacyConfig, keys: BarrierKeys, n_silos: int,
                       clip_bound: float, active=None,
                       noise_state: Optional[NoiseState] = None,
                       verdicts=None, admin_row=None) -> bytes:
        """This silo's sealed update for the round. ``active`` is the
        round's participation set, ``noise_state`` the admin's step-(t-1)
        key and set. With a wired ``admin`` the handler asks it for its own
        budget verdict and ignores ``verdicts``. ``admin_row``: under admin
        masks, the admin's ``(closing, row)`` of the round; only the closing
        silo reads the row. The device work runs on
        the handler's own CUDA stream, which the contribution's host copy
        synchronises."""
        if self.fault_hook is not None:
            self.fault_hook(self.silo_idx)
        if self.admin is not None:
            allowed = self.admin.verdict_for(self.silo_idx)
        else:
            allowed = verdicts is None or \
                bool(np.asarray(verdicts)[self.silo_idx])
        if not allowed:
            raise PermissionError(
                f"silo {self.silo_idx}: owner's privacy budget is exhausted "
                f"(ledger verdict); refusing to compute an update")
        params_np = self._sync_params(params_blob)
        with self._stream():
            params = _on_device(params_np, self.device)
            # untrusted model-owner code inside the sandbox (R1/R2)
            loss, grads = self.sandbox.run(grad_fn, params, self.data)
            pipe = DPPipeline(priv, flatbuf.layout_of(grads), n_silos)
            if priv.mask_mode == "pairwise" and pipe.policy.mode == "packed":
                # prefetch_round draws next round's stream over this layout
                self._spec_pipe = pipe
            active = pipe.full_active() if active is None \
                else np.asarray(active, bool)
            state = noise_state if noise_state is not None \
                else init_state((0, 0), n_silos=n_silos)
            row = admin_row[1] if admin_row is not None \
                and self.silo_idx == admin_row[0] else None
            contrib, norm = self._masked_contrib(pipe, grads, active, keys,
                                                 state, clip_bound,
                                                 admin_row=row)
            if self.codec == "packed":
                packed = contrib if isinstance(contrib, torch.Tensor) \
                    else flatbuf.pack(pipe.layout, contrib)  # perleaf: a tree
                # the contribution leaves the device once
                payload = wire.encode_update(pipe.layout,
                                             packed.cpu().numpy(),
                                             float(loss), float(norm))
            else:
                payload = wire.encode_tree(
                    {"update": pipe.finalize(contrib), "loss": loss,
                     "norm": norm}, codec="pickle")
        blob = self.channel.send(payload)
        # the leaf reported for the round's Merkle batch tag: a digest of
        # the whole channel blob, counter prefix included
        self.last_leaf = hashlib.sha256(blob).digest()
        return blob


@dataclass
class ModelUpdater(Component):
    """The model owner's component: aggregates the masked contributions in
    numpy on the host and applies the model-updating code. It never sees a
    raw gradient; the aggregate is divided by the silos that contributed.
    Per-message authentication can go through the round's Merkle batch tag,
    accumulation can shard over threads (``shard_workers``, bit-identical
    to the serial fold), and arrivals are folded in the round's expected
    silo order whatever order they come in."""
    channels: dict = field(default_factory=dict)
    received_updates: list = field(default_factory=list)
    # admin<->updater aggregation key for batch tags (KDS-released)
    agg_key: Optional[bytes] = None
    shard_workers: int = 0  # 0/1 = serial left fold
    # audit trail of the newest updates; aged-out entries are counted
    received_cap: int = 256
    truncated_entries: int = 0
    # the chaos harness's hook, called at finish_round entry: between the
    # last ingest and the commit, the crash window the round journal covers
    fault_hook: Optional[Callable] = None

    def verify_batch_tag(self, batch: dict) -> None:
        if self.agg_key is None:
            raise wire.WireFormatError(
                "updater holds no aggregation key: cannot verify a Merkle "
                "batch tag (was the updater attested and keyed via the KDS?)")
        mac = hmac.new(self.agg_key,
                       b"batch-mac-v1"
                       + struct.pack("<QI", batch["round"],
                                     len(batch["names"]))
                       + batch["root"], hashlib.sha256).digest()
        if not hmac.compare_digest(mac, batch["mac"]):
            raise wire.WireFormatError(
                "batch tag MAC verification failed (forged or tampered "
                "batch tag); refusing the round")

    def begin_round(self, params, expected=None, batch=None,
                    batch_mode: bool = False) -> dict:
        """Open a streaming round. ``expected``: the round's handler names in
        silo order (arrivals are staged and folded in that order).
        ``batch``: the admin's Merkle batch tag, verified now, each leaf at
        ingest; ``batch_mode=True`` without one defers the tag to
        :meth:`close_round` (the pipelined runner)."""
        if batch is not None:
            self.verify_batch_tag(batch)
            if expected is None:
                expected = list(batch["names"])
            elif list(expected) != list(batch["names"]):
                raise wire.WireFormatError(
                    "round's expected silo order disagrees with the batch "
                    "tag's leaf order")
            batch_mode = True
        expected = list(expected) if expected is not None else None
        return {"layout": flatbuf.layout_of(params), "params": params,
                "total": None, "acc": None, "losses": [],
                "expected": expected,
                "expected_set": set(expected) if expected is not None
                else None,
                "next": 0, "pending": {}, "seen": set(),
                "batch": batch, "batch_mode": batch_mode, "leaves": []}

    def _accumulate(self, rs: dict, buf: np.ndarray, loss: float) -> None:
        rs["losses"].append(loss)
        if rs["acc"] is not None:
            rs["acc"].add(buf)
        elif rs["total"] is None:
            if self.shard_workers > 1:
                rs["acc"] = _ShardedAccumulator(buf, self.shard_workers)
            else:
                rs["total"] = buf
        else:
            rs["total"] = rs["total"] + buf

    def ingest(self, round_state: dict, silo: str, blob: bytes) -> None:
        """Authenticate, decrypt, decode and accumulate one sealed update. A
        duplicate silo is rejected before any crypto; with a batch tag, a
        blob whose digest is not under the round's root is rejected here,
        attributed to its silo."""
        rs = round_state
        if silo in rs["seen"]:
            raise wire.WireFormatError(
                f"{silo}: duplicate update in one round (rejected)")
        if rs["expected_set"] is not None and silo not in rs["expected_set"]:
            raise wire.WireFormatError(
                f"{silo}: update from a silo outside this round's "
                f"expected set (rejected)")
        rs["seen"].add(silo)
        batch = rs["batch"]
        if batch is not None:
            leaf = hashlib.sha256(blob).digest()
            path = batch["paths"].get(silo)
            if path is None or not merkle.verify_path(batch["root"], leaf,
                                                      path):
                raise wire.WireFormatError(
                    f"{silo}: sealed update does not match the round's "
                    f"Merkle batch tag (tampered or substituted in "
                    f"transit); update rejected")
            raw = self.channels[silo].recv(blob, verify=False)
        elif rs["batch_mode"]:
            # the tag comes at close_round: record the leaf, decrypt now,
            # commit nothing until every leaf verifies
            rs["leaves"].append((silo, hashlib.sha256(blob).digest()))
            raw = self.channels[silo].recv(blob, verify=False)
        else:
            raw = self.channels[silo].recv(blob)
        layout = rs["layout"]
        msg = wire.decode(raw)
        if msg.kind == wire.KIND_UPDATE:
            buf, loss, _norm = wire.decode_update(msg, layout)
            self.received_updates.append(wire.unpack_np(layout, buf))
        else:
            payload = wire.decode_tree(raw)
            self.received_updates.append(payload["update"])
            loss = float(payload["loss"])
            buf = wire.pack_np(layout, payload["update"])
        overflow = len(self.received_updates) - self.received_cap
        if overflow > 0:
            self.truncated_entries += overflow
            del self.received_updates[:-self.received_cap]
        if rs["expected"] is None:
            self._accumulate(rs, buf, loss)
            return
        rs["pending"][silo] = (buf, loss)
        exp, nxt = rs["expected"], rs["next"]
        while nxt < len(exp) and exp[nxt] in rs["pending"]:
            b, l = rs["pending"].pop(exp[nxt])
            self._accumulate(rs, b, l)
            nxt += 1
        rs["next"] = nxt

    def close_round(self, round_state: dict,
                    batch: Optional[dict] = None) -> tuple:
        """The host half of closing a round: verify a deferred batch tag
        (a failing leaf is attributed and the aggregate discarded), check
        the expected set is complete, and divide by the contribution count.
        Returns ``(mean update as a numpy tree, mean loss)``."""
        rs = round_state
        if rs["batch_mode"] and rs["batch"] is None:
            if batch is None:
                raise wire.WireFormatError(
                    "round opened in batch-MAC mode but closed without a "
                    "batch tag; aggregate discarded")
            self.verify_batch_tag(batch)
            bad = [silo for silo, leaf in rs["leaves"]
                   if batch["paths"].get(silo) is None
                   or not merkle.verify_path(batch["root"], leaf,
                                             batch["paths"][silo])]
            if bad:
                raise wire.WireFormatError(
                    f"batch tag verification failed for {', '.join(bad)}: "
                    f"sealed update(s) do not match the round's Merkle "
                    f"root (tampered or substituted); aggregate discarded")
        if rs["expected"] is not None and rs["next"] != len(rs["expected"]):
            missing = [s for s in rs["expected"][rs["next"]:]
                       if s not in rs["pending"]]
            raise wire.WireFormatError(
                f"round closed with updates missing from "
                f"{', '.join(missing)}; aggregate discarded")
        total = rs["acc"].result() if rs["acc"] is not None else rs["total"]
        n_contrib = max(len(rs["losses"]), 1)
        mean_update = wire.unpack_np(rs["layout"],
                                     total / np.float32(n_contrib))
        return mean_update, float(np.mean(rs["losses"]))

    def finish_round(self, round_state: dict, update_fn: Callable,
                     lr: float, batch: Optional[dict] = None):
        """Close the round and run the model-updating code, which moves the
        numpy mean update onto the params' device. Returns (new params,
        mean loss)."""
        if self.fault_hook is not None:
            self.fault_hook()
        mean_update, loss = self.close_round(round_state, batch)
        return update_fn(round_state["params"], mean_update, lr), loss

    def aggregate(self, blobs: dict, params, update_fn: Callable, lr: float,
                  batch: Optional[dict] = None):
        """One whole round from its sealed updates (in silo order); the
        divisor is the actual contribution count."""
        rs = self.begin_round(params, expected=list(blobs), batch=batch)
        for silo, blob in blobs.items():
            self.ingest(rs, silo, blob)
        return self.finish_round(rs, update_fn, lr)


@dataclass
class Admin(Component):
    """Coordinates the rounds: owns the per-step keys (the whole of the
    mask distribution on the pairwise path), the session's privacy ledger
    and the noise-correction state."""
    root_key: Optional[tuple] = None  # raw (k0, k1), as prng.PRNGKey
    ledger: Optional[PrivacyLedger] = None
    n_silos: int = 0
    noise_state: Optional[NoiseState] = None
    agg_key: Optional[bytes] = None
    _verdict_cache: Optional[tuple] = field(default=None, repr=False)

    def keys_for_step(self, step: int) -> BarrierKeys:
        return step_keys(self.root_key, step)

    def verdicts(self) -> np.ndarray:
        """Per-silo budget verdicts (True = budget left), cached per ledger
        state; all-allowed without a ledger."""
        if self.ledger is None:
            return np.ones(max(self.n_silos, 1), bool)
        fp = (self.ledger.steps, self.ledger.epsilon_budget,
              tuple(sorted(self.ledger.budgets.items())))
        if self._verdict_cache is None or self._verdict_cache[0] != fp:
            self._verdict_cache = (fp, self.ledger.allowed_mask())
        return self._verdict_cache[1]

    def verdict_for(self, silo: int) -> bool:
        return bool(np.asarray(self.verdicts())[silo])

    def batch_tag(self, leaves: list, round_id: int) -> dict:
        """The round's Merkle batch tag over ``[(name, leaf), ...]`` in silo
        order: the tree's root, its HMAC binding (round, leaf count, root)
        under the aggregation key, and each silo's authentication path."""
        if self.agg_key is None:
            raise ValueError(
                "admin holds no aggregation key: cannot issue a Merkle "
                "batch tag (was the admin attested and keyed via the KDS?)")
        names = [name for name, _ in leaves]
        tree = merkle.MerkleTree([leaf for _, leaf in leaves])
        mac = hmac.new(self.agg_key,
                       b"batch-mac-v1"
                       + struct.pack("<QI", round_id, len(names))
                       + tree.root, hashlib.sha256).digest()
        return {"round": int(round_id), "names": names, "root": tree.root,
                "mac": mac,
                "paths": {name: tree.path(i)
                          for i, name in enumerate(names)}}

    def closing_mask_row(self, priv: PrivacyConfig, template, keys, active,
                         state, clip_bound) -> tuple:
        """The admin-mode closing row, drawn once a round on the admin (on
        the template's device) and shipped to the one closing handler: an
        O(P) fan-out instead of that handler drawing every other silo's row
        to close the sum. Returns ``(closing index, packed (P,) row)``."""
        pipe = DPPipeline(priv, flatbuf.layout_of(template), self.n_silos)
        first = flatbuf.flat_tensors(pipe.layout, template)[0]
        bound = torch.full((), float(clip_bound), dtype=torch.float32,
                           device=first.device)
        with torch.no_grad():
            return pipe.admin_closing_row(template, active, keys, state,
                                          bound)

    def state_for_step(self) -> NoiseState:
        if self.noise_state is None:
            self.noise_state = init_state((0, 0),
                                          n_silos=max(self.n_silos, 1))
        return self.noise_state

    def advance(self, keys: BarrierKeys, active) -> None:
        """End of round: roll the correction state forward (xi_t's key
        becomes the next round's prev_key) and record the round's
        participation bitmask with the ledger."""
        active = np.asarray(active, bool)
        self.noise_state = NoiseState(prev_key=_raw(keys.key_xi),
                                      has_prev=True, prev_active=active)
        if self.ledger is not None:
            self.ledger.record(active)

    def sign_spend_report(self, round_trip_s: Optional[dict] = None) -> dict:
        """The ledger's spend report, HMAC-signed with a key derived from
        this admin's attestation identity (not embedded: a verifier
        recomputes it through the attestation service, see
        ``analysis.report.verify_spend_report``)."""
        if self.ledger is None:
            raise ValueError("admin has no ledger to report on")
        report = self.ledger.spend_report(round_trip_s=round_trip_s)
        if self.report is None:
            return report  # unattested admin: plain report
        signed = dict(report)
        signed["signature"] = {
            "scheme": "hmac-sha256/attestation-identity",
            "hmac": spend_report_mac(report, self.report.signature),
            "signer": {
                "component": self.report.component,
                "code_measurement": self.report.code_measurement,
                "policy_hash": self.report.policy_hash,
                "nonce": self.report.nonce,
            },
        }
        return signed


class ManagementService:
    """Sets up a training session and tracks metadata (paper section 3.2)."""

    def __init__(self):
        self.attestation = AttestationService()
        self.kds = KeyDistributionService(self.attestation)
        self.storage = UntrustedStorage()
        self.policy = LaunchPolicy()
        self.sessions: dict[str, dict] = {}
        self.ledger_config: dict = {}
        self.wire_config: dict = {"codec": wire.WIRE_CODEC_ID}

    def expected_measurement(self) -> str:
        """The guarded code measurement bound to the session's ledger and
        wire configs."""
        return _bind_configs(measure_modules(_guarded_modules()),
                             self.ledger_config, self.wire_config)

    def create_session(self, session_id: str, n_silos: int,
                       priv: PrivacyConfig,
                       ledger_config: Optional[dict] = None,
                       wire_config: Optional[dict] = None) -> dict:
        cfg = ledger_config if ledger_config is not None else \
            PrivacyLedger.from_privacy_config(priv, n_silos).config_dict()
        wcfg = dict(self.wire_config) if wire_config is None \
            else dict(wire_config)
        if self.sessions and (cfg != self.ledger_config
                              or wcfg != self.wire_config):
            raise ValueError(
                "this ManagementService already measures a different ledger/"
                "wire config; deploy a separate service for a session with "
                "different enforcement or protocol terms")
        self.ledger_config = cfg
        self.wire_config = wcfg
        s = {"id": session_id, "n_silos": n_silos, "priv": priv,
             "progress": 0, "components": {},
             "ledger_config": dict(cfg), "wire_config": dict(wcfg)}
        self.sessions[session_id] = s
        return s
