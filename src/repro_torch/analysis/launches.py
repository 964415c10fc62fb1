"""Launch-count checker: declared kernel budgets per entry point.

Counterpart of ``repro/analysis/launches.py``.  The JAX package counts the
``pallas_call`` equations of a traced entry point; the port counts its
kernel wrapper calls, recorded by ``kernels.ops.recording()`` on the twin
route (CPU tensors) and on the card alike, so a CPU test holds a rule to its
budget.  On the card ``device_kernel_names`` also lists the device kernels
one call launches, from a profiler trace, for the budget expanded by
``kernels.meta``'s table (AFA fused: one wrapper call, three device
kernels).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.analysis.report import Finding, error
from repro_torch.analysis.trace import record
from repro_torch.kernels import meta


class LaunchBudget(NamedTuple):
    """Budget for the number of kernel wrapper calls of one entry point.

    ``exact`` pins the count; otherwise ``min``/``max`` bound it (either may
    be None for unbounded on that side)."""

    exact: int | None = None
    min: int | None = None
    max: int | None = None

    def describe(self) -> str:
        if self.exact is not None:
            return f"exactly {self.exact}"
        parts = []
        if self.min is not None:
            parts.append(f">= {self.min}")
        if self.max is not None:
            parts.append(f"<= {self.max}")
        return " and ".join(parts) if parts else "unconstrained"

    def satisfied_by(self, count: int) -> bool:
        if self.exact is not None:
            return count == self.exact
        if self.min is not None and count < self.min:
            return False
        if self.max is not None and count > self.max:
            return False
        return True


def kernel_calls(fn: Callable, *args: Any) -> list:
    """The wrapper calls (``kernels.ops.WrapperCall``) of one ``fn(*args)``."""
    return record(fn, *args)[1].calls


def kernel_call_names(fn_or_calls: Any, *args: Any) -> list:
    """The names of every wrapper call: of a recorded list of calls, or of
    one call of ``fn(*args)``."""
    calls = kernel_calls(fn_or_calls, *args) if callable(fn_or_calls) else fn_or_calls
    return [c.name for c in calls]


def count_kernel_calls(fn_or_calls: Any, *args: Any) -> int:
    return len(kernel_call_names(fn_or_calls, *args))


def expected_device_kernels(calls) -> list:
    """The device kernels the recorded wrapper calls launch, each at its own
    geometry (``kernels.meta.device_ops``), in order."""
    return [k for c in calls for k in meta.device_ops(c.name, c.params)]


def device_kernel_names(fn: Callable, *args: Any) -> list:
    """This repository's device kernels (``meta.KERNEL_NAMES``) that one call
    of ``fn(*args)`` on the card launches, in launch order, from a
    ``torch.profiler`` trace taken after a warm call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [e.name for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                                    key=lambda e: e.time_range.start)]
    return [next(k for k in meta.KERNEL_NAMES if k in n) for n in names
            if any(k in n for k in meta.KERNEL_NAMES)]


def check_launch_budget(fn_or_calls: Any, *args: Any, budget: LaunchBudget,
                        target: str = "<anonymous>") -> list[Finding]:
    """Record + count + compare; one ``error`` finding on violation."""
    names = kernel_call_names(fn_or_calls, *args)
    if budget.satisfied_by(len(names)):
        return []
    return [error("launch-budget", target,
                  f"expected {budget.describe()} kernel wrapper call(s), recorded "
                  f"{len(names)}: {names or '(none)'}")]


def check_device_kernels(fn: Callable, *args: Any, target: str = "<anonymous>",
                         tries: int = 5) -> list[Finding]:
    """On the card: the device kernels of one call equal the recorded wrapper
    calls expanded by ``kernels.meta``'s table; one ``error`` otherwise.  The
    profiler can drop device events (a whole trace at a process's first, and
    some late in a long process), so a trace that disagrees is taken again,
    up to ``tries`` traces: a dropped event only shortens the list, so a
    retry cannot pass a call that launches other kernels."""
    want = expected_device_kernels(kernel_calls(fn, *args))
    for _ in range(tries):
        got = device_kernel_names(fn, *args)
        if got == want:
            return []
    return [error("launch-budget", target,
                  f"device kernels {got or '(none)'} != the wrapper budget expanded by "
                  f"kernels.meta: {want or '(none)'}")]
