"""CLI: ``python -m repro_torch.analysis.lint``.

Counterpart of ``repro/analysis/lint.py``.  Runs the registered lint checks
over every rule × kernel mode × proposal buffer and writes a JSON and a
markdown report.  Exit status:

* 0 — no error findings (warnings and info allowed);
* 1 — at least one error finding;
* 2 — ``--known-bad`` self-test failed (the race check did NOT flag the
  seeded known-bad geometry and source: the linter has lost its teeth).

``--ranks N`` starts N gloo ranks (``launch.shards.spawn``) for the
collective budget of the client-sharded AFA (the counterpart of the JAX
package's ``--host-devices``); ``--device cuda`` runs the matrix on the
card (``chip_smoke.py --phase Z`` does, with 2 gloo ranks sharing it).

  PYTHONPATH=src python -m repro_torch.analysis.lint --ranks 2
  PYTHONPATH=src python -m repro_torch.analysis.lint --known-bad
"""

from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Program-invariant linter of the PyTorch port's aggregation stack.")
    p.add_argument("--ranks", type=int, default=0, metavar="N",
                   help="N gloo ranks for the collective-budget check (default: skipped, "
                        "recorded as info)")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                   help="where the entry points run (default: cpu, the kernels' twins)")
    p.add_argument("--checks", nargs="*", default=None, metavar="CHECK",
                   help="subset of checks to run (default: all registered)")
    p.add_argument("--rules", nargs="*", default=None, metavar="RULE",
                   help="subset of aggregation rules (default: the full registry)")
    p.add_argument("--modes", nargs="*", default=None, metavar="MODE",
                   help="subset of kernel modes (default: plain kernels)")
    p.add_argument("--json", default=None, metavar="PATH", help="write the JSON report here")
    p.add_argument("--markdown", default=None, metavar="PATH",
                   help="write the markdown report here")
    p.add_argument("--known-bad", action="store_true",
                   help="self-test: lint the seeded known-bad geometry and source and require "
                        "the race check to flag both (exit 2 if it does not)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    from repro_torch.analysis.registry import known_bad_findings, run_lint
    from repro_torch.analysis.report import Report

    if args.known_bad:
        findings = known_bad_findings()
        report = Report(meta={"self_test": "known-bad geometry and source"})
        report.extend(findings)
        report.mark_ran("grid-race[known-bad]")
        _emit(report, args)
        seeds = {"gram": any(f.severity == "error" and f.target.startswith("known-bad:gram")
                             for f in findings),
                 "float atomic": any(f.severity == "error" and "float atomic" in f.message
                                     for f in findings)}
        for f in findings:
            print(f"  [{f.severity}] {f.check} {f.target}: {f.message}")
        if all(seeds.values()):
            print("known-bad self-test: both seeds DETECTED as errors (as required)")
            return 0
        print(f"known-bad self-test FAILED: not flagged: "
              f"{[k for k, v in seeds.items() if not v]}", file=sys.stderr)
        return 2

    report = run_lint(checks=tuple(args.checks) if args.checks else None,
                      rules=tuple(args.rules) if args.rules else None,
                      modes=tuple(args.modes) if args.modes else None,
                      device=args.device, ranks=args.ranks)
    _emit(report, args)
    counts = report.counts()
    print(f"repro_torch.analysis.lint: {'PASS' if report.ok else 'FAIL'} — "
          f"{counts['error']} error(s), {counts['warning']} warning(s), {counts['info']} info "
          f"across {len(report.checks_run)} check(s)")
    for f in report.findings:
        stream = sys.stderr if f.severity == "error" else sys.stdout
        print(f"  [{f.severity}] {f.check} {f.target}: {f.message}", file=stream)
    return 0 if report.ok else 1


def _emit(report, args) -> None:
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(report.to_json() + "\n")
    if args.markdown:
        with open(args.markdown, "w") as fh:
            fh.write(report.to_markdown())


if __name__ == "__main__":
    sys.exit(main())
