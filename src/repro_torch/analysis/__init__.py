"""Program invariants of the PyTorch port, checked by machine.

Counterpart of ``repro/analysis``.  The JAX package traces its entry points
to jaxprs; the port records what a call does (``trace``: the aten
operations through a ``TorchDispatchMode``, the kernel wrapper calls, the
mesh collectives, each under the ``region`` spans open at the time), on the
CPU, where the wrappers take their twins, or on the card, and checks:

* ``races`` — the grid-race detector: rebuilds the blocks of every recorded
  kernel call from the declared geometry (``kernels.meta``) and proves their
  write maps disjoint, every partial a reduce reads written and the
  declaration true; a source pass over ``csrc/*.cu`` adds no float atomics
  and fenced tickets;
* ``launches`` — kernel wrapper calls against declared budgets per rule
  (fused AFA = exactly 1), and on the card the device kernels of a profiler
  trace against the budget expanded by ``kernels.meta.DEVICE_OPS_PER_CALL``;
* ``collectives`` — the collective budget of the client-sharded screening
  loop (<= 1 heavy sum + 1 heavy gather per pass);
* ``retrace`` — the programs (CUDA graph captures) a segmented run and the
  decode loop build stay within the O(log K) pow2-bucket bound, and a
  repeat builds none;
* ``transfers`` — no host read in a capturable call or a fused round body;
* ``costs`` — matrix-product FLOPs, a device-traffic proxy and collective
  bytes of a recorded call (the counterpart of ``hlo.py``).

CLI: ``python -m repro_torch.analysis.lint`` runs the rule × mode × buffer
matrix and emits a JSON and markdown report.  Nothing here imports JAX or
the JAX package.
"""

from repro_torch.analysis.collectives import (
    CollectiveBudget,
    CollectiveUse,
    check_screening_budget,
    collective_uses,
    pass_collectives,
)
from repro_torch.analysis.launches import (
    LaunchBudget,
    check_launch_budget,
    count_kernel_calls,
    kernel_call_names,
)
from repro_torch.analysis.races import analyze_kernel_races, check_sources
from repro_torch.analysis.report import Finding, Report
from repro_torch.analysis.retrace import audit_programs, pow2_bucket_bound
from repro_torch.analysis.trace import record, region
from repro_torch.analysis.transfers import check_no_host_syncs

__all__ = [
    "CollectiveBudget",
    "CollectiveUse",
    "Finding",
    "LaunchBudget",
    "Report",
    "analyze_kernel_races",
    "audit_programs",
    "check_launch_budget",
    "check_no_host_syncs",
    "check_screening_budget",
    "check_sources",
    "collective_uses",
    "count_kernel_calls",
    "kernel_call_names",
    "pass_collectives",
    "pow2_bucket_bound",
    "record",
    "region",
]
