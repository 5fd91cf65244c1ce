"""Authenticated encryption for component-to-component payloads and assets
at rest. Port of ``repro/core/tee/channels.py`` (numpy and hashlib, the
same constructions, so a blob sealed by either package opens in the
other).

SIMULATION: a keyed counter-mode keystream plus HMAC-SHA256
(encrypt-then-MAC), not production crypto (a deployment uses AES-GCM).
The protocol properties the paper needs, confidentiality, integrity and
replay rejection by monotone counters, are enforced and tested.

Two keystream versions, selected by a version byte the MAC covers:

* ``VER_FAST`` (default): a Philox4x64 counter stream keyed by
  SHA-256(enc_key || nonce), drawn in one batched numpy pass and XORed
  onto the payload.
* ``VER_LEGACY``: SHA-256 a 32-byte block with a per-byte Python XOR, the
  seed's construction (the pickle codec's channel).
"""
from __future__ import annotations

import functools
import hashlib
import hmac
import json
import os
import struct
from dataclasses import dataclass

import numpy as np

VER_LEGACY = 1
VER_FAST = 2


class IntegrityError(ValueError):
    """Authentication failure on a sealed blob or channel message (bad MAC,
    truncated frame, replayed counter): never retried."""


def _keystream_legacy(key: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hashlib.sha256(key + nonce + struct.pack("<Q", counter)).digest()
        counter += 1
    return bytes(out[:n])


def _keystream(key: bytes, nonce: bytes, n: int) -> np.ndarray:
    """Counter-mode keystream in one batched pass: Philox4x64 keyed by
    SHA-256(key || nonce). A uint8 array of length ``n``."""
    if n <= 0:
        return np.empty(0, np.uint8)
    seed = hashlib.sha256(key + nonce).digest()
    bitgen = np.random.Philox(key=np.frombuffer(seed[:16], np.uint64))
    return np.frombuffer(np.random.Generator(bitgen).bytes(n), np.uint8)


def derive_key(master: bytes, label: str) -> bytes:
    return hmac.new(master, label.encode(), hashlib.sha256).digest()


@functools.lru_cache(maxsize=4096)
def _enc_mac_keys(key: bytes) -> tuple:
    """The per-channel enc/mac subkeys (a pure function of the key)."""
    return derive_key(key, "enc"), derive_key(key, "mac")


def spend_report_mac(body: dict, attestation_signature: str) -> str:
    """The MAC of a ledger-signed spend report, shared by the signer
    (``Admin.sign_spend_report``) and the verifier
    (``analysis.report.verify_spend_report``): strict JSON with sorted keys,
    the key derived from the admin's attestation-report signature under the
    'spend-report-v1' label."""
    canonical = json.dumps(body, sort_keys=True).encode()
    key = derive_key(attestation_signature.encode(), "spend-report-v1")
    return hmac.new(key, canonical, hashlib.sha256).hexdigest()


def _xor_fast(data, ks: np.ndarray) -> bytes:
    return np.bitwise_xor(np.frombuffer(data, np.uint8), ks).tobytes()


def seal(key: bytes, plaintext, aad: bytes = b"",
         version: int = VER_FAST) -> bytes:
    """Encrypt-then-MAC; ``plaintext`` is bytes or any buffer."""
    enc_key, mac_key = _enc_mac_keys(key)
    nonce = os.urandom(16)
    pt = memoryview(plaintext).cast("B")
    if version == VER_FAST:
        ct = _xor_fast(pt, _keystream(enc_key, nonce, len(pt)))
    elif version == VER_LEGACY:
        ct = bytes(a ^ b for a, b in
                   zip(pt.tobytes(), _keystream_legacy(enc_key, nonce, len(pt))))
    else:
        raise ValueError(f"unknown seal version {version}")
    ver = bytes([version])
    tag = hmac.new(mac_key, ver + nonce + aad + ct, hashlib.sha256).digest()
    return ver + nonce + tag + ct


def open_sealed(key: bytes, blob: bytes, aad: bytes = b"",
                verify: bool = True) -> bytes:
    """``verify=False`` only decrypts: strictly for callers that already
    authenticated the whole blob through a round's Merkle batch tag."""
    enc_key, mac_key = _enc_mac_keys(key)
    if len(blob) < 49:
        raise IntegrityError("sealed blob truncated (needs version+nonce+tag)")
    version, nonce, tag, ct = blob[0], blob[1:17], blob[17:49], blob[49:]
    if verify:
        expect = hmac.new(mac_key, bytes([version]) + nonce + aad + ct,
                          hashlib.sha256).digest()
        if not hmac.compare_digest(expect, tag):
            raise IntegrityError("authentication failed (tampered or wrong key)")
    if version == VER_FAST:
        return _xor_fast(ct, _keystream(enc_key, nonce, len(ct)))
    if version == VER_LEGACY:
        return bytes(a ^ b for a, b in
                     zip(ct, _keystream_legacy(enc_key, nonce, len(ct))))
    raise ValueError(f"unknown sealed-blob version {version}")


@dataclass
class SecureChannel:
    """Replay-protected duplex channel between two attested components."""
    key: bytes
    peer: str
    version: int = VER_FAST
    _send_ctr: int = 0
    _recv_ctr: int = -1

    def send(self, payload) -> bytes:
        aad = f"{self.peer}:{self._send_ctr}".encode()
        blob = struct.pack("<Q", self._send_ctr) + \
            seal(self.key, payload, aad, version=self.version)
        self._send_ctr += 1
        return blob

    def recv(self, blob: bytes, verify: bool = True) -> bytes:
        """``verify=False`` still enforces the monotone replay counter but
        leaves the payload's integrity to the round's Merkle batch tag. The
        counter advances only after a successful open."""
        ctr = struct.unpack("<Q", blob[:8])[0]
        if ctr <= self._recv_ctr:
            raise IntegrityError(
                f"replayed message (ctr {ctr} <= {self._recv_ctr})")
        aad = f"{self.peer}:{ctr}".encode()
        out = open_sealed(self.key, blob[8:], aad, verify=verify)
        self._recv_ctr = ctr
        return out
