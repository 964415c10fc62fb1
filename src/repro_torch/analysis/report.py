"""Findings and reports — the linter's only output vocabulary.

A copy of ``repro/analysis/report.py`` (the port imports nothing of
``repro``).  Every analysis returns ``list[Finding]``; the CLI aggregates them into a
:class:`Report` that serializes to JSON (machine/CI) and markdown (humans).
Severity contract: ``error`` findings gate CI, ``warning`` findings are
surfaced but non-fatal, ``info`` findings record skipped or informational
checks (e.g. the collective audit on a single-device host).
"""

from __future__ import annotations

import json
from typing import Iterable, NamedTuple

SEVERITIES = ("error", "warning", "info")


class Finding(NamedTuple):
    """One lint result.

    ``check``   — the analysis that produced it (``grid-race``, ``launch-
                  budget``, ``collective-budget``, ``retrace``,
                  ``host-transfer``).
    ``severity``— ``error`` | ``warning`` | ``info``.
    ``target``  — what was analyzed, e.g. ``"afa[fused]/interpret"``.
    ``message`` — human-readable description.
    """

    check: str
    severity: str
    target: str
    message: str

    def as_dict(self) -> dict[str, str]:
        return {
            "check": self.check,
            "severity": self.severity,
            "target": self.target,
            "message": self.message,
        }


def error(check: str, target: str, message: str) -> Finding:
    return Finding(check, "error", target, message)


def warning(check: str, target: str, message: str) -> Finding:
    return Finding(check, "warning", target, message)


def info(check: str, target: str, message: str) -> Finding:
    return Finding(check, "info", target, message)


class Report:
    """An ordered collection of findings plus run metadata."""

    def __init__(self, meta: dict | None = None) -> None:
        self.findings: list[Finding] = []
        self.meta: dict = dict(meta or {})
        self.checks_run: list[str] = []

    def extend(self, findings: Iterable[Finding]) -> None:
        for f in findings:
            if f.severity not in SEVERITIES:
                raise ValueError(f"invalid severity {f.severity!r} in {f}")
            self.findings.append(f)

    def mark_ran(self, check: str) -> None:
        if check not in self.checks_run:
            self.checks_run.append(check)

    def by_severity(self, severity: str) -> list[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> list[Finding]:
        return self.by_severity("error")

    @property
    def ok(self) -> bool:
        return not self.errors

    def counts(self) -> dict[str, int]:
        return {s: len(self.by_severity(s)) for s in SEVERITIES}

    def to_json(self) -> str:
        return json.dumps(
            {
                "ok": self.ok,
                "meta": self.meta,
                "checks_run": self.checks_run,
                "counts": self.counts(),
                "findings": [f.as_dict() for f in self.findings],
            },
            indent=2,
            sort_keys=True,
        )

    def to_markdown(self) -> str:
        counts = self.counts()
        lines = [
            "# repro_torch.analysis lint report",
            "",
            f"**Status:** {'PASS' if self.ok else 'FAIL'} — "
            f"{counts['error']} error(s), {counts['warning']} warning(s), "
            f"{counts['info']} info",
            "",
        ]
        if self.meta:
            lines.append("## Run metadata")
            lines.append("")
            for k in sorted(self.meta):
                lines.append(f"- `{k}`: {self.meta[k]}")
            lines.append("")
        if self.checks_run:
            lines.append("## Checks run")
            lines.append("")
            for c in self.checks_run:
                lines.append(f"- {c}")
            lines.append("")
        if self.findings:
            lines.append("## Findings")
            lines.append("")
            lines.append("| severity | check | target | message |")
            lines.append("|---|---|---|---|")
            order = {s: i for i, s in enumerate(SEVERITIES)}
            for f in sorted(self.findings, key=lambda f: order[f.severity]):
                msg = f.message.replace("|", "\\|").replace("\n", " ")
                lines.append(
                    f"| {f.severity} | {f.check} | `{f.target}` | {msg} |"
                )
            lines.append("")
        else:
            lines.append("No findings — every audited invariant holds.")
            lines.append("")
        return "\n".join(lines)
