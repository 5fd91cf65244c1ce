"""Key Distribution Service (paper section 3.2, steps 2-3 and 6-7). Port
of ``repro/core/tee/kds.py``: stores asset keys uploaded by the owners and
releases one only to a component whose attestation report verifies and
whose measurement and policy match the owner's expected values. (The
chaos hook of the fault-tolerant rounds comes with them, ``ROADMAP.md``
queue 1, item 8b.)
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.tee.attestation import (AttestationReport,
                                              AttestationService)


@dataclass
class KeyRecord:
    key: bytes
    owner: str
    expected_measurement: str
    expected_policy: str
    released_to: list = field(default_factory=list)


class KeyDistributionService:
    def __init__(self, attestation: AttestationService):
        self.attestation = attestation
        self._records: dict[str, KeyRecord] = {}
        self.audit_log: list = []

    def upload_key(self, asset_id: str, key: bytes, owner: str,
                   expected_measurement: str, expected_policy: str) -> None:
        self._records[asset_id] = KeyRecord(key, owner, expected_measurement,
                                            expected_policy)

    def request_key(self, asset_id: str, report: AttestationReport) -> bytes:
        rec = self._records.get(asset_id)
        if rec is None:
            raise KeyError(f"unknown asset {asset_id!r}")
        ok_sig = self.attestation.verify(report)
        ok_code = report.code_measurement == rec.expected_measurement
        ok_policy = report.policy_hash == rec.expected_policy
        self.audit_log.append({"asset": asset_id, "component": report.component,
                               "sig": ok_sig, "code": ok_code,
                               "policy": ok_policy})
        if not (ok_sig and ok_code and ok_policy):
            raise PermissionError(
                f"attestation failed for {report.component!r} requesting "
                f"{asset_id!r}: sig={ok_sig} code={ok_code} policy={ok_policy}")
        rec.released_to.append(report.component)
        return rec.key
