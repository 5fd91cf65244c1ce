"""Remote-attestation protocol simulation (paper section 6, Fig. 4). Port
of ``repro/core/tee/attestation.py``.

The root of trust is software (labelled SIMULATION): measured components,
an attestation report binding measurements and policy, and key release
gated on verification. A measurement is SHA-256 over the source of the
modules a component declares plus its launch configuration. The port
measures its own guarded modules (``components._guarded_modules``), so
its measurements differ from the JAX package's by design.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import hmac
import inspect
import json
from dataclasses import dataclass
from typing import Any

SIMULATION_NOTICE = "SIMULATED-TEE (software root of trust; protocol-faithful)"


def measure_modules(modules) -> str:
    """Cryptographic measurement of the service code, memoized per module
    set (sources cannot change inside one process)."""
    return _measure_modules_cached(tuple(modules))


@functools.lru_cache(maxsize=64)
def _measure_modules_cached(modules: tuple) -> str:
    h = hashlib.sha256()
    for mod in modules:
        try:
            src = inspect.getsource(mod)
        except (OSError, TypeError):
            src = repr(mod)
        h.update(src.encode())
    return h.hexdigest()


def measure_config(cfg: Any) -> str:
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    return hashlib.sha256(
        json.dumps(cfg, sort_keys=True, default=str).encode()).hexdigest()


@dataclass(frozen=True)
class AttestationReport:
    """The attestation-report analogue: code measurement, policy hash,
    component role and a signature by the (simulated) hardware root key."""
    component: str
    code_measurement: str
    policy_hash: str
    nonce: str
    signature: str = ""

    def payload(self) -> bytes:
        return json.dumps({
            "component": self.component,
            "code_measurement": self.code_measurement,
            "policy_hash": self.policy_hash,
            "nonce": self.nonce,
        }, sort_keys=True).encode()


class AttestationService:
    """Signs reports with the hardware root key and verifies them for
    relying parties (the KDS)."""

    def __init__(self, root_key: bytes = b"simulated-hardware-root-key"):
        self._root_key = root_key
        self.notice = SIMULATION_NOTICE

    def issue(self, component: str, code_measurement: str, policy_hash: str,
              nonce: str) -> AttestationReport:
        r = AttestationReport(component, code_measurement, policy_hash, nonce)
        sig = hmac.new(self._root_key, r.payload(), hashlib.sha256).hexdigest()
        return dataclasses.replace(r, signature=sig)

    def verify(self, report: AttestationReport) -> bool:
        expect = hmac.new(self._root_key, report.payload(),
                          hashlib.sha256).hexdigest()
        return hmac.compare_digest(expect, report.signature)


@dataclass
class LaunchPolicy:
    """Runtime access policy (paper section 6.2): only the protocol RPCs
    exposed; the policy hash is bound into the report."""
    allowed_rpcs: tuple = ("register", "get_mask_keys", "submit_update",
                           "get_model", "heartbeat")
    exec_process: bool = False
    network_egress: tuple = ()

    def hash(self) -> str:
        return measure_config(dataclasses.asdict(self))
