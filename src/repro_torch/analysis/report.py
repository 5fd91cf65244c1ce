"""Privacy spend reporting: the port's copy of ``privacy_spend_table`` from
``repro/analysis/report.py``, for the reports the port's ledger writes
(no round-trip telemetry and no ledger signature yet: those come with the
wire tier, ``ROADMAP.md`` queue 1, item 8).
"""
from __future__ import annotations


def _eps(x) -> str:
    return "inf" if x is None else f"{x:.4f}"


def privacy_spend_table(report: dict) -> str:
    """Markdown table of one :meth:`PrivacyLedger.spend_report` dict: one
    row per silo with its own participation history, spend and verdict."""
    lines = [
        f"mode={report['mode']} sigma={report['sigma']:.4g} "
        f"delta={report['delta']:.1e} lam={report['lam']:.2f} "
        f"steps={report['steps']} "
        f"global eps={_eps(report['epsilon_global'])}",
        "",
        "| silo | steps in | steps out | epsilon | budget | remaining "
        "| status |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in report["silos"]:
        budget = "—" if s["budget"] is None else f"{s['budget']:.4f}"
        remaining = "—" if s["remaining"] is None else f"{s['remaining']:.4f}"
        status = "EXHAUSTED" if s["exhausted"] else "ok"
        lines.append(
            f"| {s['silo']} | {s['steps_participated']} "
            f"| {s['steps_sat_out']} | {_eps(s['epsilon'])} "
            f"| {budget} | {remaining} | {status} |")
    for e in report.get("exclusions", []):
        lines.append(f"silo {e['silo']} excluded at step {e['step']} "
                     f"(eps {_eps(e['epsilon'])} >= budget "
                     f"{_eps(e['budget'])})")
    return "\n".join(lines)
