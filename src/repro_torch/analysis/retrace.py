"""Recapture auditor: the programs the engines build stay O(log K).

Counterpart of ``repro/analysis/retrace.py``.  The JAX package's
counterpart of a recompile is a jit cache entry; the port's is a program
and, on the card, its CUDA graph capture: a ``fed.engine._RoundProgram``
per client row count of a fused or segmented run (``_program_runner``'s
``programs``), a ``launch.serve.DecodeProgram`` per key of ``generate``'s
``programs``.  The segmented engine compacts the live clients onto
power-of-two buckets (``data.sharding.pow2_bucket``), so a run that blocks
clients may build at most one program per bucket it passes through, and
repeating an identical run must build none (growth means an argument
drifts between calls).  The host factories cached with ``lru_cache`` are
audited the same way.  These checks run the calls (tiny, on the CPU unless
the caller asks for the card).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from repro_torch.analysis.report import Finding, error


def pow2_bucket_bound(ks: Iterable[int], cap: int) -> int:
    """Number of distinct pow2 buckets a run over live counts ``ks`` may
    occupy — the O(log K) bound on its programs: the distinct powers of two
    at or above each count, clamped to ``[1, cap]``.  Computed here, not by
    the engine's ``data.sharding.pow2_bucket``, so that a bucketing that
    regressed cannot raise its own bound."""
    return len({max(1, min(1 << max(int(k) - 1, 0).bit_length(), int(cap))) for k in ks})


def _programs(holder) -> dict:
    return holder if isinstance(holder, dict) else holder.programs


def audit_programs(holder: Any, drive: Callable[[], None], *, bound: int,
                   target: str = "<anonymous>", captured: bool = False) -> list[Finding]:
    """Run ``drive()`` twice; ``holder`` is the programs dict (or has it as
    ``.programs``).  The first run may build at most ``bound`` programs, the
    identical repeat none; with ``captured`` every program must hold a CUDA
    graph (the card)."""
    programs = _programs(holder)
    before = len(programs)
    drive()
    first = len(programs) - before
    findings = []
    if first > bound:
        findings.append(error("retrace", target,
                              f"the run built {first} programs, exceeding the O(log K) bound "
                              f"of {bound}"))
    drive()
    again = len(programs) - before - first
    if again:
        findings.append(error("retrace", target,
                              f"repeating an identical run built {again} more program(s) — an "
                              "argument drifts between calls"))
    if captured:
        bare = [k for k, p in programs.items() if getattr(p, "graph", None) is None]
        if bare:
            findings.append(error("retrace", target,
                                  f"program(s) {bare} were not captured as CUDA graphs"))
    return findings


def audit_host_cache(cached_fn: Any, build: Callable[[], None], *, bound: int,
                     target: str = "<anonymous>") -> list[Finding]:
    """Audit an ``lru_cache``-backed host factory: run ``build()`` and
    require that the new cache misses it incurred stay within ``bound``."""
    before = cached_fn.cache_info().misses
    build()
    misses = cached_fn.cache_info().misses - before
    if misses > bound:
        return [error("retrace", target,
                      f"host factory cache took {misses} misses for the build, exceeding the "
                      f"bound of {bound}")]
    return []
