"""What a call does, recorded on any device: the plumbing of every analysis.

Counterpart of ``repro/analysis/jaxpr_utils.py``.  The JAX package traces a
call to a jaxpr and walks its equations; the port runs the call (on the CPU
unless the caller's tensors are on the card, or on ``meta``) and records,
in one pass:

* every aten operation that reaches the dispatcher (a ``TorchDispatchMode``):
  its name, the shapes, dtypes and devices of its tensor operands and
  results, their bytes, its matrix-product FLOPs by
  ``torch.utils.flop_counter``'s formulas, the stack of ``region`` labels
  open at the call, and, for an operation that reaches the host
  (``HOST_SYNC_OPS``, ``DATA_DEPENDENT_OPS``, a copy to the CPU), the
  ``file:line`` of the port's code that made it;
* every kernel wrapper call (``kernels.ops.recording``);
* every collective of a client mesh or grid (``launch.mesh.recording``).

The region labels are ``utils.regions``'s (``region(label)`` marks a span
of the port's code: a screening pass, the fused round body, a wrapper's
twin); this module reads them and re-exports them.
"""

from __future__ import annotations

import contextlib
import os
import traceback
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.utils.regions import (
    ROUND_BODY,
    SCREEN_PASS,
    TWIN,
    current_regions,
    region,
    region_label,
)

# operations that read a device value on the host (``.item()``, ``bool()``,
# ``int()``), and operations whose output shape depends on the data, which
# read a count from the device before they can allocate their result
HOST_SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::item", "aten::is_nonzero"})
DATA_DEPENDENT_OPS = frozenset({
    "aten::nonzero", "aten::nonzero_static", "aten::masked_select", "aten::unique",
    "aten::_unique", "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::repeat_interleave", "aten::argwhere", "aten::bincount", "aten::histc",
})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_", "aten::to"})
# operations that move no bytes: left out of the traffic proxy
_FREE = frozenset({"aten::detach", "aten::lift_fresh", "aten::alias", "aten::empty",
                   "aten::empty_like", "aten::empty_strided"})

class OpRecord(NamedTuple):
    """One aten operation of a recorded call."""

    name: str                 # e.g. "aten::mm"
    in_shapes: tuple
    out_shapes: tuple
    dtypes: tuple             # of the operands, then the results
    devices: tuple
    in_bytes: int
    out_bytes: int
    flops: int                # matrix products only (torch.utils.flop_counter)
    is_view: bool
    regions: tuple
    host: bool                # reads the device on the host (see ``reaches_host``)
    where: str | None         # "core/afa.py:221" where ``host``


class Recording(NamedTuple):
    ops: list                 # OpRecord
    calls: list               # kernels.ops.WrapperCall
    collectives: list         # launch.mesh.CollectiveCall


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _where() -> str | None:
    """The innermost frame of the port's code (outside this package) on the
    stack, as ``path/under/repro_torch.py:line``; else the innermost frame
    outside torch."""
    stack = traceback.extract_stack()[:-3]
    for fr in reversed(stack):
        f = fr.filename.replace(os.sep, "/")
        if "/repro_torch/" in f and "/repro_torch/analysis/" not in f:
            return f"{f.split('/repro_torch/', 1)[1]}:{fr.lineno}"
    for fr in reversed(stack):
        f = fr.filename.replace(os.sep, "/")
        if "/torch/" not in f and "/repro_torch/analysis/" not in f:
            return f"{os.path.basename(f)}:{fr.lineno}"
    return None


def reaches_host(name: str, devices: tuple, out_devices: tuple) -> bool:
    """Whether an operation reads the device on the host: a scalar read, a
    data-dependent shape, or a copy from a device to the CPU."""
    if name in HOST_SYNC_OPS or name in DATA_DEPENDENT_OPS:
        return True
    return (name in _COPIES and any(d != "cpu" and d != "meta" for d in devices)
            and "cpu" in out_devices)


def bool_index(name: str, args) -> bool:
    """``aten::index`` with a boolean index, which runs ``nonzero`` inside."""
    if name != "aten::index":
        return False
    return any(t.dtype == torch.bool for t in _tensors(args[1:]))


class _Recorder(TorchDispatchMode):
    def __init__(self, ops: list):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name().split(".")[0]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        devices = tuple(t.device.type for t in ins)
        out_devices = tuple(t.device.type for t in outs)
        packet = func.overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        host = reaches_host(name, devices, out_devices) or bool_index(name, args)
        self.ops.append(OpRecord(
            name, tuple(tuple(t.shape) for t in ins), tuple(tuple(t.shape) for t in outs),
            tuple(str(t.dtype) for t in ins + outs), devices + out_devices,
            sum(map(_nbytes, ins)), sum(map(_nbytes, outs)), flops,
            bool(func.is_view) or name in _FREE, current_regions(), host,
            _where() if host else None))
        return out


@contextlib.contextmanager
def recording():
    """Record the aten operations, wrapper calls and collectives made inside
    the block: yields a ``Recording`` whose lists fill as they run."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch import mesh

    with kernel_ops.recording() as calls, mesh.recording() as collectives:
        rec = Recording([], calls, collectives)
        with _Recorder(rec.ops):
            yield rec


def record(fn: Callable, *args: Any, **kwargs: Any) -> tuple:
    """``(fn(*args, **kwargs), Recording)``."""
    with recording() as rec:
        out = fn(*args, **kwargs)
    return out, rec


__all__ = [
    "DATA_DEPENDENT_OPS",
    "HOST_SYNC_OPS",
    "OpRecord",
    "ROUND_BODY",
    "Recording",
    "SCREEN_PASS",
    "TWIN",
    "bool_index",
    "current_regions",
    "reaches_host",
    "record",
    "recording",
    "region",
    "region_label",
]
