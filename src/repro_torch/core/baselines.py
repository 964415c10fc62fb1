"""The rule registry the server dispatches through, and Federated Averaging.

Counterpart of ``repro/core/baselines.py``.  Every dispatchable rule
registers a :class:`RuleSpec` whose matrix form is ``(updates (K, d), n_k,
p_k, mask, opts) -> result``; :func:`dispatch_rule` (a matrix) and
:func:`dispatch_rule_tree` (a stacked tree, packed ONCE into a ``(K, D)``
buffer) are the entry points.  Ported so far: ``fa`` here and ``afa``
(``core/afa.py``); the other baselines are not.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.policy import resolve_kernel_mode
from repro_torch.utils.trees import pack_spec, pack_stack, unpack_stack

EPS = 1e-12


class AggResult(NamedTuple):
    aggregate: torch.Tensor
    good_mask: torch.Tensor
    # True when the participation mask was empty: the aggregate is then a
    # zero update and callers keep the previous model
    all_blocked: torch.Tensor | bool = False


def _norm_weights(mask, w):
    c = torch.where(mask, w, 0.0)
    return c / torch.clamp(c.sum(), min=EPS)


def fa_aggregate(updates, n_k, p_k=None, mask=None, *,
                 use_kernels: bool | str = False) -> AggResult:
    """Federated Averaging: the n_k-weighted mean of the live rows."""
    K = updates.shape[0]
    mask = torch.ones((K,), dtype=torch.bool, device=updates.device) if mask is None else mask
    c = _norm_weights(mask, n_k.float())
    u32 = updates.float().contiguous()
    if resolve_kernel_mode(use_kernels) == "cuda":
        agg = kernel_ops.weighted_sum(c, u32)
    else:
        agg = c @ u32
    return AggResult(agg.to(updates.dtype), mask)


class RuleOptions(NamedTuple):
    """Per-call rule knobs.  ``afa`` holds an ``AFAConfig`` when rule == afa."""

    use_kernels: bool | str = False
    afa: Any = None  # AFAConfig | None (typed Any to avoid an import cycle)


class RuleSpec(NamedTuple):
    name: str
    matrix_fn: Callable  # (updates, n_k, p_k, mask, opts) -> result
    tree_fn: Callable | None = None
    updates_reputation: bool = False  # AFA: result drives the Beta posterior


RULES: dict[str, RuleSpec] = {}


def register_rule(
    name: str,
    matrix_fn: Callable,
    tree_fn: Callable | None = None,
    *,
    updates_reputation: bool = False,
) -> RuleSpec:
    spec = RuleSpec(name, matrix_fn, tree_fn, updates_reputation)
    RULES[name] = spec
    return spec


def _guard_all_blocked(res, mask):
    """Empty participation: an explicit zero update plus ``all_blocked``;
    with any live client the aggregate passes through unchanged."""
    if mask is None:
        return res._replace(all_blocked=False)
    all_blocked = ~mask.any()
    aggregate = torch.where(all_blocked, torch.zeros_like(res.aggregate), res.aggregate)
    return res._replace(aggregate=aggregate, all_blocked=all_blocked)


def _spec(name: str) -> RuleSpec:
    try:
        return RULES[name]
    except KeyError:
        raise ValueError(f"unknown rule {name!r}; registered: {sorted(RULES)}") from None


def dispatch_rule(name: str, updates, n_k, p_k=None, mask=None,
                  opts: RuleOptions = RuleOptions()):
    """Matrix-form dispatch: ``updates`` is (K, d)."""
    spec = _spec(name)
    return _guard_all_blocked(spec.matrix_fn(updates, n_k, p_k, mask, opts), mask)


def dispatch_rule_tree(name: str, stacked, n_k, p_k=None, mask=None,
                       opts: RuleOptions = RuleOptions()):
    """Tree-form dispatch over a stacked tree: packed ONCE into a ``(K, D)``
    buffer, the rule's matrix form on it, the aggregate unpacked ONCE back to
    the tree (the JAX package's packed layout; its per-leaf layout is not
    ported)."""
    spec = _spec(name)
    pspec = pack_spec(stacked, stacked=True)
    res = spec.matrix_fn(pack_stack(stacked, pspec), n_k, p_k, mask, opts)
    res = _guard_all_blocked(res, mask)
    return res._replace(aggregate=unpack_stack(res.aggregate, pspec))


register_rule(
    "fa", lambda u, n, p, m, o: fa_aggregate(u, n, mask=m, use_kernels=o.use_kernels)
)
