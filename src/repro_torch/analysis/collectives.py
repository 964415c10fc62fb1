"""Collective-budget checker for the client-sharded screening loop.

Counterpart of ``repro/analysis/collectives.py``.  The client-sharded AFA
(``core/afa.py``'s sharded branch on a ``launch.mesh.ClientMesh``) moves,
per screening pass, one heavy D-wide sum (the partial aggregates) and one
heavy K-row gather (the similarities), plus O(1)-sized statistics (the
3-scalar mean / median / std), which are free at the wire level and left
out of the budget by an element count.  The mesh logs each collective with
the ``trace.region`` spans open at the call, and the passes are read from
the ``"screen-pass"`` spans, so the check runs on CPU ranks (gloo) and on
the card alike.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.analysis.report import Finding, error
from repro_torch.analysis.trace import SCREEN_PASS, region_label

SUM_KINDS = ("psum",)
GATHER_KINDS = ("gather", "all_gather")


class CollectiveUse(NamedTuple):
    """One collective: its kind and the elements it carries."""

    kind: str
    elements: int


class CollectiveBudget(NamedTuple):
    """Per-screening-pass budget on *heavy* collectives: those carrying more
    than ``scalar_elements`` elements."""

    max_heavy_sum: int = 1
    max_heavy_gather: int = 1
    scalar_elements: int = 64

    def is_heavy(self, use: CollectiveUse) -> bool:
        return use.elements > self.scalar_elements


def collective_uses(calls) -> list[CollectiveUse]:
    """The recorded collectives (``launch.mesh.CollectiveCall``) as uses."""
    return [CollectiveUse(c.kind, c.elements) for c in calls]


def pass_collectives(calls, label: str = SCREEN_PASS) -> list[list[CollectiveUse]]:
    """The collectives of each span labelled ``label``, in order."""
    passes: dict = {}
    for c in calls:
        span = next((r for r in reversed(c.regions) if region_label(r) == label), None)
        if span is not None:
            passes.setdefault(span, []).append(CollectiveUse(c.kind, c.elements))
    return list(passes.values())


def check_screening_budget(calls, budget: CollectiveBudget = CollectiveBudget(), *,
                           target: str = "<anonymous>") -> list[Finding]:
    """Check every screening pass against the heavy budget; a recording
    with no pass at all is an error (the budget would hold vacuously)."""
    passes = pass_collectives(calls)
    if not passes:
        return [error("collective-budget", target,
                      "no screening pass recorded — cannot audit the per-pass collective "
                      "budget")]
    findings: list[Finding] = []
    for i, uses in enumerate(passes):
        heavy = [u for u in uses if budget.is_heavy(u)]
        sums = [u for u in heavy if u.kind in SUM_KINDS]
        gathers = [u for u in heavy if u.kind in GATHER_KINDS]
        other = [u for u in heavy if u.kind not in SUM_KINDS + GATHER_KINDS]
        if len(sums) > budget.max_heavy_sum:
            findings.append(error("collective-budget", target,
                                  f"pass {i}: {len(sums)} heavy sums exceed the budget of "
                                  f"{budget.max_heavy_sum} (heavy = > {budget.scalar_elements} "
                                  f"elements; {sums})"))
        if len(gathers) > budget.max_heavy_gather:
            findings.append(error("collective-budget", target,
                                  f"pass {i}: {len(gathers)} heavy gathers exceed the budget of "
                                  f"{budget.max_heavy_gather} ({gathers})"))
        if other:
            findings.append(error("collective-budget", target,
                                  f"pass {i}: unbudgeted heavy collective(s) "
                                  f"{sorted({u.kind for u in other})}"))
    return findings
