"""Privacy spend reporting: the port's copy of ``privacy_spend_table``,
``privacy_spend_summary`` and ``verify_spend_report`` from
``repro/analysis/report.py``, for the spend reports of the port's ledger
(the trainer's, and the wire tier's signed ones with their round-trip
column).
"""
from __future__ import annotations

import hmac
import json
from pathlib import Path


def _eps(x) -> str:
    return "inf" if x is None else f"{x:.4f}"


def verify_spend_report(report: dict, attestation, *, component: str = "admin",
                        expected_measurement: str = None) -> bool:
    """Verify a ledger-signed spend report (``Admin.sign_spend_report``).
    Both checks are required: the MAC, whose key derives from the
    hardware-root signature over the signer's attestation report, recomputed
    here through ``attestation`` (the root of trust) from the embedded
    identity claim; and the identity, the claimed signer being
    ``component`` (and, when given, measuring ``expected_measurement``), so
    no other attested party can re-sign a tampered body. False for a
    missing or invalid signature or a mismatched signer."""
    from repro_torch.core.tee.channels import spend_report_mac

    sig = report.get("signature")
    if not isinstance(sig, dict) or "hmac" not in sig or "signer" not in sig:
        return False
    signer = sig["signer"]
    try:
        if signer["component"] != component:
            return False
        if expected_measurement is not None \
                and signer["code_measurement"] != expected_measurement:
            return False
        att = attestation.issue(signer["component"],
                                signer["code_measurement"],
                                signer["policy_hash"], signer["nonce"])
    except (KeyError, TypeError):
        return False
    body = {k: v for k, v in report.items() if k != "signature"}
    return hmac.compare_digest(spend_report_mac(body, att.signature),
                               sig["hmac"])


def privacy_spend_table(report: dict, attestation=None) -> str:
    """Markdown table of one :meth:`PrivacyLedger.spend_report` dict: one
    row per silo with its own participation history, spend and verdict,
    and its round-trip EMA where the report has one. With ``attestation``
    (the session's attestation service) a signature is verified and its
    status shown; without it the signature is only surfaced."""
    with_rt = any(s.get("avg_round_trip_ms") is not None
                  for s in report["silos"])
    lines = [
        f"mode={report['mode']} sigma={report['sigma']:.4g} "
        f"delta={report['delta']:.1e} lam={report['lam']:.2f} "
        f"steps={report['steps']} "
        f"global eps={_eps(report['epsilon_global'])}",
        "",
        "| silo | steps in | steps out | epsilon | budget | remaining "
        "| status |" + (" rt (ms) |" if with_rt else ""),
        "|---|---|---|---|---|---|---|" + ("---|" if with_rt else ""),
    ]
    for s in report["silos"]:
        budget = "—" if s["budget"] is None else f"{s['budget']:.4f}"
        remaining = "—" if s["remaining"] is None else f"{s['remaining']:.4f}"
        status = "EXHAUSTED" if s["exhausted"] else "ok"
        rt = ""
        if with_rt:
            ms = s.get("avg_round_trip_ms")
            rt = " — |" if ms is None else f" {ms:.3f} |"
        lines.append(
            f"| {s['silo']} | {s['steps_participated']} "
            f"| {s['steps_sat_out']} | {_eps(s['epsilon'])} "
            f"| {budget} | {remaining} | {status} |{rt}")
    for e in report.get("exclusions", []):
        lines.append(f"silo {e['silo']} excluded at step {e['step']} "
                     f"(eps {_eps(e['epsilon'])} >= budget "
                     f"{_eps(e['budget'])})")
    sig = report.get("signature")
    if sig is not None:
        signer = sig.get("signer", {})
        status = "present" if attestation is None else \
            ("VERIFIED" if verify_spend_report(report, attestation)
             else "INVALID")
        lines.append(
            f"signature: {status} — {sig.get('scheme')} by "
            f"{signer.get('component', '?')} "
            f"(measurement {signer.get('code_measurement', '')[:12]}…); "
            f"verify with verify_spend_report(report, attestation_service)")
    return "\n".join(lines)


def privacy_spend_summary(path) -> str:
    """Render a spend-report JSON file (as ``launch/train.py
    --spend-report`` writes it)."""
    return privacy_spend_table(json.loads(Path(path).read_text()))
