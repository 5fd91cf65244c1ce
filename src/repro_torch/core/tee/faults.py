"""Seeded fault injection for the TEE wire tier (the chaos harness). Port
of ``repro/core/tee/faults.py`` (numpy only, as there): the same plans from
the same seeds, event for event.

A :class:`FaultPlan` is a deterministic schedule of faults, built once from
a seed via ``np.random.default_rng`` in a fixed iteration order, so every
chaos run is replayable from ``(seed, n_silos, n_rounds, rates)``. A
:class:`FaultInjector` wraps the plan with one-shot consumption: each
scheduled event fires exactly once, so the session's round replay (which
re-runs a round after shrinking the active set) does not re-trigger the
fault that caused the shrink.

Fault taxonomy (``docs/failure_model.md`` has the handling matrix):

========== ============ =====================================================
kind       class        injection site
========== ============ =====================================================
CRASH      liveness     ``DataHandler.compute_update`` entry: raises
                        :class:`SiloCrashError`; the silo never responds this
                        round.
HANG       liveness     same site: sleeps past the round deadline, then
                        completes; the quorum closes the round without it.
DROP       transient    the sealed update blob is withheld in transit; the
                        driver re-delivers the SAME blob after backoff (the
                        channel's monotone counter admits a first delivery at
                        any counter value).
CORRUPT    integrity    seeded bytes of the sealed blob are flipped in
                        transit; detected at the updater's MAC / Merkle-leaf
                        check, attributed to the silo, never retried.
KDS_DENY   transient    ``KeyDistributionService.request_key`` raises
                        :class:`KdsTransientDenial` (a release hiccup, not an
                        attestation failure: that stays ``PermissionError``
                        and is never retried).
UPDATER    liveness     the updater dies between ``ingest`` and
                        ``finish_round``: :class:`UpdaterCrashError`; the
                        partial round is discarded and replayed (round-keyed
                        streams make the replay bit-exact).
========== ============ =====================================================

Faults inject through optional hook attributes on the components
(``DataHandler.fault_hook``, ``KeyDistributionService.fault_hook``,
``ModelUpdater.fault_hook``) and through the session's tolerant collect
loop: no overhead when no injector is attached.

This module is not in ``components._guarded_modules()``: the chaos harness
is test scaffolding outside the trusted computing base, and adding it would
change every component's attestation measurement.

The journal's params blob is the port's own ``wire.encode_tree`` (a FULL
message whose layout is JSON, where JAX pickles its treedef): a journal
written by the JAX package does not resume a port session, nor the reverse.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# fault kinds
CRASH = "crash"            # silo dies mid-compute (liveness)
HANG = "hang"              # silo stalls past the deadline (liveness)
DROP = "drop"              # sealed blob lost in transit (transient)
CORRUPT = "corrupt"        # sealed blob bit-flipped in transit (integrity)
KDS_DENY = "kds_deny"      # transient key-release denial (transient)
UPDATER_CRASH = "updater_crash"  # updater dies before finish_round (liveness)

TRANSIENT = frozenset({DROP, KDS_DENY})
LIVENESS = frozenset({CRASH, HANG, UPDATER_CRASH})
INTEGRITY = frozenset({CORRUPT})


class SiloCrashError(RuntimeError):
    """Injected: the handler's TEE died mid-compute. A liveness fault — the
    session treats the silo as a non-responder for the round."""


class KdsTransientDenial(RuntimeError):
    """Injected: the KDS could not release a key *right now* (service
    hiccup). Transient — retried with backoff. Distinct from
    ``PermissionError`` (attestation/measurement mismatch), which is an
    integrity failure and is never retried."""


class UpdaterCrashError(RuntimeError):
    """Injected: the updater died with a round partially ingested. The
    partial round is discarded and replayed from the journal."""


@dataclass
class Backoff:
    """Exponential backoff with deterministic jitter: attempt k sleeps
    ``base * factor**k * (1 + jitter_k)`` capped at ``max_s``, where
    jitter_k is drawn from a generator seeded by ``seed`` — two runs with
    the same seed back off identically, so chaos runs stay replayable."""

    base_s: float = 0.01
    factor: float = 2.0
    max_s: float = 0.25
    max_attempts: int = 6
    seed: int = 0
    attempt: int = field(default=0, init=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def delay(self) -> float:
        d = min(self.base_s * self.factor ** self.attempt, self.max_s)
        return d * (1.0 + 0.5 * float(self._rng.random()))

    def sleep(self) -> bool:
        """Sleep for the next backoff interval. Returns False once the
        attempt budget is exhausted (caller escalates)."""
        if self.attempt >= self.max_attempts:
            return False
        time.sleep(self.delay())
        self.attempt += 1
        return True


@dataclass(frozen=True)
class FaultEvent:
    round_id: int
    kind: str
    silo: Optional[int] = None  # None for updater-scoped faults
    # kind-specific payload: HANG -> sleep seconds; CORRUPT -> byte offsets
    # to flip; KDS_DENY -> number of consecutive denials
    param: float = 0.0


@dataclass
class FaultPlan:
    """A deterministic fault schedule: ``events[(round_id, site)]`` lists.

    ``from_seed`` draws the schedule in one fixed pass (rounds outer, fault
    kinds inner) from ``np.random.default_rng(seed)``, capping the
    liveness + transient faults in any round at ``n_silos - quorum`` distinct
    silos so a quorum of responders always exists — chaos must degrade the
    run, not wedge it."""

    seed: int
    n_silos: int
    n_rounds: int
    events: list = field(default_factory=list)

    @classmethod
    def from_seed(cls, seed: int, n_silos: int, n_rounds: int, *,
                  quorum: Optional[int] = None,
                  crash_rate: float = 0.08, hang_rate: float = 0.08,
                  drop_rate: float = 0.08, corrupt_rate: float = 0.05,
                  kds_deny_rate: float = 0.3,
                  updater_crash_rate: float = 0.06,
                  hang_s: float = 0.5) -> "FaultPlan":
        rng = np.random.default_rng(seed)
        quorum = max(1, quorum if quorum is not None else (n_silos + 1) // 2)
        budget_per_round = max(0, n_silos - quorum)
        events: list = []
        for t in range(n_rounds):
            afflicted: set = set()

            def pick_silo() -> Optional[int]:
                free = [s for s in range(n_silos) if s not in afflicted]
                if not free or len(afflicted) >= budget_per_round:
                    return None
                s = int(free[int(rng.integers(len(free)))])
                afflicted.add(s)
                return s

            # fixed draw order per round keeps the schedule reproducible
            for kind, rate in ((CRASH, crash_rate), (HANG, hang_rate),
                               (DROP, drop_rate), (CORRUPT, corrupt_rate)):
                if float(rng.random()) < rate:
                    silo = pick_silo()
                    if silo is None:
                        continue
                    param = float(hang_s * (0.6 + 0.8 * rng.random())) \
                        if kind == HANG else float(rng.integers(1, 4))
                    events.append(FaultEvent(t, kind, silo, param))
            if float(rng.random()) < kds_deny_rate:
                # consumed by the next rejoin's request_key calls: deny the
                # first 1-2 attempts, then release
                events.append(FaultEvent(t, KDS_DENY, None,
                                         float(rng.integers(1, 3))))
            if float(rng.random()) < updater_crash_rate:
                events.append(FaultEvent(t, UPDATER_CRASH, None,
                                         float(rng.random())))
        return cls(seed=seed, n_silos=n_silos, n_rounds=n_rounds,
                   events=events)

    def counts(self) -> dict:
        c: dict = {}
        for e in self.events:
            c[e.kind] = c.get(e.kind, 0) + 1
        return c


class FaultInjector:
    """One-shot consumption of a :class:`FaultPlan`, queried at each
    injection site. Every event fires at most once — the session's
    round-replay path (re-running a shrunk round) does not re-trigger the
    fault that shrank it. ``stats`` counts what actually fired."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending: dict = {}
        for e in plan.events:
            self._pending.setdefault((e.round_id, e.kind), []).append(e)
        # KDS denials are consumed off a global burst counter: the plan
        # schedules a burst, each request_key call during the burst is
        # denied once
        self._kds_burst: int = 0
        self.fired: dict = {}
        # the collect loop queries from many worker threads at once
        self._lock = threading.Lock()

    def _take(self, round_id: int, kind: str,
              silo: Optional[int] = None) -> Optional[FaultEvent]:
        with self._lock:
            evs = self._pending.get((round_id, kind))
            if not evs:
                return None
            for i, e in enumerate(evs):
                if silo is None or e.silo == silo:
                    evs.pop(i)
                    self.fired[kind] = self.fired.get(kind, 0) + 1
                    return e
            return None

    # ---- injection sites -------------------------------------------------
    def handler_fault(self, round_id: int, silo: int) -> None:
        """Called at ``compute_update`` entry via ``DataHandler.fault_hook``.
        Raises for a scheduled CRASH; sleeps for a scheduled HANG."""
        e = self._take(round_id, CRASH, silo)
        if e is not None:
            raise SiloCrashError(
                f"injected crash: silo {silo} died mid-compute (round "
                f"{round_id})")
        e = self._take(round_id, HANG, silo)
        if e is not None:
            time.sleep(e.param)

    def transit_fault(self, round_id: int, silo: int,
                      blob: bytes) -> Optional[bytes]:
        """Called on each sealed update blob in transit. Returns None for a
        scheduled DROP (the driver re-delivers the same blob after backoff),
        a corrupted copy for a scheduled CORRUPT, else the blob unchanged."""
        if self._take(round_id, DROP, silo) is not None:
            return None
        e = self._take(round_id, CORRUPT, silo)
        if e is not None:
            buf = bytearray(blob)
            rng = np.random.default_rng((self.plan.seed, round_id, silo))
            # flip bytes past the counter prefix so the corruption hits the
            # authenticated region, not the replay counter framing
            for _ in range(int(e.param)):
                i = 8 + int(rng.integers(max(1, len(buf) - 8)))
                buf[i] ^= 0xFF
            return bytes(buf)
        return blob

    def arm_kds(self, round_id: int) -> None:
        """Move a scheduled KDS_DENY burst into the live counter (called
        when the session is about to exercise the KDS, e.g. a rejoin)."""
        e = self._take(round_id, KDS_DENY)
        if e is not None:
            with self._lock:
                self._kds_burst += int(e.param)

    def kds_fault(self, asset_id: str, report) -> None:
        """Called at ``request_key`` entry via the KDS ``fault_hook``."""
        with self._lock:
            if self._kds_burst <= 0:
                return
            self._kds_burst -= 1
            self.fired["kds_denied"] = self.fired.get("kds_denied", 0) + 1
        raise KdsTransientDenial(
                f"injected transient denial: KDS cannot release "
                f"{asset_id!r} right now (retry with backoff)")

    def updater_fault(self, round_id: int) -> None:
        """Called between the last ``ingest`` and ``finish_round``."""
        if self._take(round_id, UPDATER_CRASH) is not None:
            raise UpdaterCrashError(
                f"injected crash: updater died with round {round_id} "
                f"partially ingested")


# ---------------------------------------------------------------------------
# Crash-consistent round journal


@dataclass
class RoundJournal:
    """Crash-consistent record of COMMITTED rounds: which participation set
    each closed round realized, the wire-encoded params after the latest
    commit, and the currently-downed silos. A round enters the journal only
    after ``finish_round`` + ``admin.advance`` succeed, so an updater or
    driver crash mid-round leaves the journal at the last good round — the
    partial round is simply not there, and replaying it is safe because
    every stream is keyed by the round index (replay is bit-exact).

    ``path=None`` keeps the journal in memory (tests, benchmarks' oracle
    replay). With a path, every commit persists via write-to-temp +
    ``os.replace`` so a crash during the write itself leaves the previous
    consistent snapshot in place. ``CollaborativeSession.resume(journal)``
    rebuilds a fresh session's admin/ledger state from the journal after a
    driver restart."""

    path: Optional[str] = None
    rounds: list = field(default_factory=list)  # [{"round": t, "active": [...]}]
    params_blob: Optional[bytes] = None
    downed: dict = field(default_factory=dict)  # silo -> round it went down

    @property
    def rounds_done(self) -> int:
        return len(self.rounds)

    def commit(self, round_id: int, active, params_blob: bytes,
               downed: Optional[dict] = None) -> None:
        self.rounds.append({"round": int(round_id),
                            "active": [bool(b) for b in np.asarray(active)]})
        self.params_blob = params_blob
        if downed is not None:
            self.downed = {int(s): int(r) for s, r in downed.items()}
        self._persist()

    def _persist(self) -> None:
        if self.path is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"rounds": self.rounds,
                         "params_blob": self.params_blob,
                         "downed": self.downed}, f)
        os.replace(tmp, self.path)

    @classmethod
    def load(cls, path: str) -> "RoundJournal":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(path=path, rounds=d["rounds"],
                   params_blob=d["params_blob"], downed=d["downed"])
