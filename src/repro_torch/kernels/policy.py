"""Kernel execution policy of the PyTorch port: ``torch`` / ``cuda``.

Counterpart of ``repro/kernels/policy.py``.  Two modes:

* ``torch`` — the plain PyTorch reference path in ``repro_torch.core``; it
  launches no kernel (the JAX package's ``jnp`` mode).
* ``cuda``  — the kernel route through ``repro_torch.kernels.ops`` (the JAX
  package's ``pallas`` / ``interpret`` modes).  Each wrapper there launches
  its hand-written CUDA kernel for a CUDA tensor and takes the kernel's plain
  twin for a CPU tensor, so the route runs (and is tested) on the CPU too.

Selection has two inputs, resolved by :func:`resolve_kernel_mode`:

1. the per-call/config request ``use_kernels``: ``False`` (no kernels),
   ``True`` (kernels, by the process-wide policy) or a mode string that pins
   the route;
2. the process-wide policy from ``$REPRO_TORCH_KERNELS`` (``auto`` when
   unset), consulted only for ``use_kernels=True``.  ``auto`` resolves to
   ``cuda``.  The JAX package's ``$REPRO_KERNELS`` is not read.
"""

from __future__ import annotations

import dataclasses
import os

ENV_VAR = "REPRO_TORCH_KERNELS"
MODES = ("torch", "cuda")

# AFA screening launch geometries (core/afa.py): "fused" = the whole
# screening loop through the afa_screen kernel, "chained" = per-op launches
LAUNCHES = ("fused", "chained")
# aggregation representations of the tree dispatch (FedServer.aggregate_tree):
# "packed" / "tree" pack the stacked tree into one (K, D) buffer, "leaf"
# runs a rule's tree form (AFA's) or its matrix form on the per-leaf
# flatten.  The fused engines always aggregate the packed buffer.
LAYOUTS = ("packed", "tree", "leaf")


def requested_policy() -> str:
    """Process-wide kernel policy from ``$REPRO_TORCH_KERNELS`` (default ``auto``)."""
    val = os.environ.get(ENV_VAR, "auto").strip().lower()
    if val not in ("auto",) + MODES:
        raise ValueError(
            f"{ENV_VAR}={val!r} invalid; expected one of {('auto',) + MODES}"
        )
    return val


def resolve_kernel_mode(use_kernels: bool | str | None) -> str:
    """Resolve a ``use_kernels`` request to ``torch`` or ``cuda``.

    * ``False``/``None`` -> ``torch`` (kernels not requested; env ignored).
    * ``True`` -> the ``$REPRO_TORCH_KERNELS`` policy; ``auto`` -> ``cuda``.
    * a mode string -> itself (``"auto"`` -> ``cuda``).
    """
    if use_kernels is None or use_kernels is False:
        return "torch"
    policy = use_kernels if isinstance(use_kernels, str) else requested_policy()
    policy = policy.strip().lower()
    if policy == "auto":
        return "cuda"
    if policy not in MODES:
        raise ValueError(
            f"kernel mode {policy!r} invalid; expected one of {('auto',) + MODES}"
        )
    return policy


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The one resolved kernel and layout decision of an aggregation stack.

    ``mode`` is the resolved ``use_kernels`` value: a mode string when the
    route is pinned (by the config, or by an env pin elevating ``True``), or
    a bool for auto selection.
    """

    mode: bool | str = False   # resolved kernel request (bool = auto)
    launch: str = "fused"      # AFA screening geometry: fused | chained
    layout: str = "packed"     # aggregation representation: packed | tree | leaf

    def __post_init__(self):
        if self.launch not in LAUNCHES:
            raise ValueError(
                f"KernelPlan.launch={self.launch!r} invalid; expected {LAUNCHES}"
            )
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"KernelPlan.layout={self.layout!r} invalid; expected {LAYOUTS}"
            )
        if not (isinstance(self.mode, bool) or self.mode in MODES):
            raise ValueError(
                f"KernelPlan.mode={self.mode!r} invalid; expected a bool or "
                f"one of {MODES}"
            )


def resolve_kernel_plan(
    use_kernels: bool | str | None = False,
    agg_layout: str = "packed",
    kernel_launch: str = "fused",
) -> KernelPlan:
    """Collapse ``use_kernels`` / ``agg_layout`` / ``kernel_launch`` (and the
    env var) into one :class:`KernelPlan`; an unknown layout or launch
    raises.

    Precedence for the kernel route, highest first: an explicit mode string
    in ``use_kernels``; ``$REPRO_TORCH_KERNELS`` pinning a mode elevates
    ``use_kernels=True`` to it; otherwise the bool stays (auto selection).
    A config-pinned mode that disagrees with an env-pinned one raises.
    """
    explicit = explicit_kernel_request(use_kernels)
    if isinstance(use_kernels, str) and use_kernels.strip().lower() != "auto":
        env = requested_policy()
        if env != "auto" and env != explicit:
            raise ValueError(
                f"conflicting explicit kernel requests: config pins "
                f"use_kernels={explicit!r} but {ENV_VAR}={env!r}; drop one "
                "(config mode strings and the env pin must agree)"
            )
    mode = explicit if explicit is not None else bool(use_kernels)
    return KernelPlan(mode=mode, launch=kernel_launch, layout=agg_layout)


def explicit_kernel_request(use_kernels: bool | str | None) -> str | None:
    """The mode the caller explicitly named, or None for auto selection.

    Explicit means: ``use_kernels`` is a mode string other than ``"auto"``,
    or it is truthy while ``$REPRO_TORCH_KERNELS`` pins a mode.
    """
    if isinstance(use_kernels, str):
        if use_kernels.strip().lower() == "auto":
            return None
        return resolve_kernel_mode(use_kernels)
    if use_kernels and requested_policy() != "auto":
        return requested_policy()
    return None
