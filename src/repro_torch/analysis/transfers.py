"""Host-sync detector for calls that must not read the device.

Counterpart of ``repro/analysis/transfers.py``.  The fused engines capture a
round as a CUDA graph: a capture breaks on any operation that waits for the
device, and a host read inside a round serialises every round on the host.
The JAX package checks its scan and while bodies for host callbacks; the
port records the call (``trace.record``, on the CPU unless the operands are
on the card) and flags, with the ``file:line`` of the port's code that made
it:

* ``aten::_local_scalar_dense`` (``.item()``, ``bool()``, ``int()`` of a
  tensor);
* operations whose output shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``, indexing with a boolean mask, ...);
* copies from a device to the CPU.

A kernel wrapper's plain twin (``trace.TWIN`` spans, CPU operands) is left
out: on the card the wrapper launches its kernel in the twin's place.

On the card the call also runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises at any operation
that synchronises with the host.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.analysis.report import Finding, error
from repro_torch.analysis.trace import TWIN, _tensors, record, region_label


def host_syncs(fn_or_rec: Any, *args: Any) -> list:
    """The recorded operations (``trace.OpRecord``) of one ``fn(*args)`` (or
    of a ``trace.Recording``) that read the device on the host, outside the
    kernels' twins."""
    rec = record(fn_or_rec, *args)[1] if callable(fn_or_rec) else fn_or_rec
    return [op for op in rec.ops
            if op.host and not any(region_label(r) == TWIN for r in op.regions)]


def check_no_host_syncs(fn: Callable, *args: Any, target: str = "<anonymous>") -> list[Finding]:
    """One ``error`` per distinct host read in ``fn(*args)``."""
    seen = {}
    for op in host_syncs(fn, *args):
        seen.setdefault((op.name, op.where), op)
    findings = [error("host-transfer", target,
                      f"{name} at {where or '<unknown>'} reads the device on the host: a "
                      "captured round would break there")
                for name, where in seen]
    if any(t.device.type == "cuda" for t in _tensors(args)):
        import torch

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args)
        except RuntimeError as e:
            findings.append(error("host-transfer", target,
                                  f"synchronises with the host under sync debug mode 'error': "
                                  f"{str(e).splitlines()[0]}"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return findings
