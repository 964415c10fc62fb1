"""The baseline aggregation rules the paper compares against, and the rule
registry the server dispatches through.

Counterpart of ``repro/core/baselines.py``:

* ``fa``           — Federated Averaging (McMahan et al. 2017)
* ``mkrum``        — Multi-KRUM (Blanchard et al. 2017)
* ``comed``        — coordinate-wise median (Yin et al. 2018)
* ``trimmed_mean`` — coordinate-wise trimmed mean (Yin et al. 2018)
* ``bulyan``       — MKRUM selection, then per coordinate the mean of the
  values closest to the median (Mhamdi et al. 2018)
* ``norm_clip``    — norm-clipped mean

``afa`` registers from ``core/afa.py``, ``geomed`` and ``centered_clip``
from ``core/extra_rules.py``.  Every dispatchable rule registers a
:class:`RuleSpec` whose matrix form is ``(updates (K, d), n_k, p_k, mask,
opts) -> result`` (AFA also registers a tree form); :func:`dispatch_rule`
(a matrix) and :func:`dispatch_rule_tree` (a stacked tree, packed ONCE into
a ``(K, D)`` buffer, or per leaf with ``layout="leaf"``) are the entry
points.

On the kernel route (``use_kernels`` resolving to ``cuda``) the hot ops go
through ``repro_torch.kernels.ops``: ``weighted_sum`` (fa, mkrum,
norm_clip), ``gram`` (the distances of mkrum and bulyan), ``coord_median``
(comed, bulyan's median) and ``trimmed_mean``.  The plain route keeps the
JAX package's jnp semantics, comed's balanced +-inf fill of dead rows
included.  Every sort or argsort whose order decides a result is stable, as
``jnp.sort`` and ``jnp.argsort`` are.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.stats import masked_median
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.policy import resolve_kernel_mode
from repro_torch.utils.trees import pack_spec, pack_stack, tree_map, unpack_stack

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


def _kernels(use_kernels: bool | str) -> bool:
    return resolve_kernel_mode(use_kernels) == "cuda"


def _all_live(updates):
    return torch.ones((updates.shape[0],), dtype=torch.bool, device=updates.device)


def _weighted_rows(c, u32, kernels: bool):
    """(K,) @ (K, d) -> (d,): the weighted_sum kernel or a plain product."""
    return kernel_ops.weighted_sum(c, u32) if kernels else c @ u32


def fa_aggregate(updates, n_k, p_k=None, mask=None, *,
                 use_kernels: bool | str = False) -> AggResult:
    """Federated Averaging: the n_k-weighted mean of the live rows."""
    mask = _all_live(updates) if mask is None else mask
    c = _norm_weights(mask, n_k.float())
    agg = _weighted_rows(c, updates.float().contiguous(), _kernels(use_kernels))
    return AggResult(agg.to(updates.dtype), mask)


def pairwise_sq_dists(updates, *, use_kernels: bool | str = False):
    """K x K squared euclidean distances through the Gram identity (the gram
    kernel on the kernel route)."""
    u = updates.float().contiguous()
    g = kernel_ops.gram(u) if _kernels(use_kernels) else u @ u.T
    return kernel_ops.pairwise_sq_dists_from_gram(g)


def _ranks(order):
    """Inverse permutation along dim 0: ``ranks[order[r]] = r``."""
    pos = torch.arange(order.shape[0], dtype=torch.int32, device=order.device)
    pos = pos.reshape((-1,) + (1,) * (order.ndim - 1)).expand(order.shape)
    return torch.empty_like(pos).scatter_(0, order, pos)


def mkrum_aggregate(updates, n_k=None, p_k=None, mask=None, *, num_byzantine: int,
                    num_selected: int, use_kernels: bool | str = False) -> AggResult:
    """Multi-KRUM: score_k = sum of the K-f-2 smallest distances to the other
    live rows; average the ``num_selected`` lowest-scoring updates."""
    K = updates.shape[0]
    mask = _all_live(updates) if mask is None else mask
    kernels = _kernels(use_kernels)
    d2 = pairwise_sq_dists(updates, use_kernels=use_kernels)
    big = 3.4e38
    eye = torch.eye(K, dtype=torch.bool, device=updates.device)
    # self-distance and masked-out columns excluded from neighbour sets
    off = torch.where(eye | ~mask[None, :], big, d2)
    n_neigh = torch.clamp(mask.sum() - num_byzantine - 2, min=1)
    srt = torch.sort(off, dim=1).values
    idx = torch.arange(K, device=updates.device)[None, :]
    scores = torch.where(idx < n_neigh, srt, 0.0).sum(dim=1)
    scores = torch.where(mask, scores, big)
    m = torch.clamp(mask.sum(), max=num_selected)
    sel = (_ranks(torch.argsort(scores, stable=True)) < m) & mask
    c = _norm_weights(sel, torch.ones((K,), dtype=torch.float32, device=updates.device))
    agg = _weighted_rows(c, updates.float().contiguous(), kernels)
    return AggResult(agg.to(updates.dtype), sel)


def comed_aggregate(updates, n_k=None, p_k=None, mask=None, *,
                    use_kernels: bool | str = False) -> AggResult:
    """Coordinate-wise median across the live rows.

    The kernel ranks each live row among the live rows only.  The plain route
    pushes dead rows to +-inf in balanced pairs, so they never shift the
    median of the live subset."""
    if _kernels(use_kernels):
        med = kernel_ops.coord_median(updates.float().contiguous(), mask)
        return AggResult(med.to(updates.dtype), _all_live(updates) if mask is None else mask)
    mask = _all_live(updates) if mask is None else mask
    u = updates.float()
    m = mask.sum()
    dead = ~mask
    dead_rank = torch.cumsum(dead.int(), dim=0) - 1  # rank among dead rows, valid where dead
    fill = torch.where(dead_rank % 2 == 0, torch.inf, -torch.inf)[:, None]
    u = torch.where(mask[:, None], u, fill)
    srt = torch.sort(u, dim=0).values
    n_dead_lo = torch.div(dead.sum(), 2, rounding_mode="floor")
    lo_i = n_dead_lo + torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
    hi_i = n_dead_lo + torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)
    med = 0.5 * (srt.index_select(0, lo_i.reshape(1)) + srt.index_select(0, hi_i.reshape(1)))[0]
    return AggResult(med.to(updates.dtype), mask)


def trimmed_mean_aggregate(updates, n_k=None, p_k=None, mask=None, *, trim: int,
                           use_kernels: bool | str = False) -> AggResult:
    """Coordinate-wise mean after dropping ``trim`` extremes at both ends.

    When the live count ``m <= 2 trim`` the trim window is empty and the rule
    gives the masked mean, not a zero aggregate; the kernel does the same."""
    K = updates.shape[0]
    mask = _all_live(updates) if mask is None else mask
    u32 = updates.float()
    if _kernels(use_kernels):
        out = kernel_ops.trimmed_mean(u32.contiguous(), mask, trim=trim)
        return AggResult(out.to(updates.dtype), mask)
    srt = torch.sort(torch.where(mask[:, None], u32, torch.inf), dim=0).values
    m = mask.sum()
    i = torch.arange(K, device=updates.device)[:, None]
    live = (i >= trim) & (i < m - trim)
    cnt = torch.clamp(live.sum(), min=1)
    trimmed = torch.where(live, srt, 0.0).sum(dim=0) / cnt
    w = mask.float()[:, None]
    masked_mean = (u32 * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    mean = torch.where(m > 2 * trim, trimmed, masked_mean)
    return AggResult(mean.to(updates.dtype), mask)


def bulyan_aggregate(updates, n_k=None, p_k=None, mask=None, *, num_byzantine: int,
                     use_kernels: bool | str = False) -> AggResult:
    """Bulyan: MKRUM-style selection of theta = K-2f updates, then per
    coordinate the mean of the beta = theta-2f values closest to their
    median."""
    K = updates.shape[0]
    mask = _all_live(updates) if mask is None else mask
    theta = max(K - 2 * num_byzantine, 1)
    sel = mkrum_aggregate(
        updates, mask=mask, num_byzantine=num_byzantine, num_selected=theta,
        use_kernels=use_kernels,
    ).good_mask
    med = comed_aggregate(updates, mask=sel, use_kernels=use_kernels).aggregate.float()
    u32 = updates.float()
    dist = torch.where(sel[:, None], (u32 - med[None]).abs(), torch.inf)
    beta = max(theta - 2 * num_byzantine, 1)
    use = _ranks(torch.argsort(dist, dim=0, stable=True)) < beta
    out = torch.where(use, u32, 0.0).sum(dim=0) / beta
    return AggResult(out.to(updates.dtype), sel)


def norm_clip_aggregate(updates, n_k, p_k=None, mask=None, clip=None, *,
                        use_kernels: bool | str = False) -> AggResult:
    """Clip each update to the masked-median norm (or ``clip``), then take
    the n_k-weighted mean."""
    mask = _all_live(updates) if mask is None else mask
    u = updates.float()
    norms = torch.linalg.vector_norm(u, dim=1)
    c = masked_median(norms, mask) if clip is None else clip
    scale = torch.clamp(c / torch.clamp(norms, min=EPS), max=1.0)
    u = (u * scale[:, None]).contiguous()
    w = _norm_weights(mask, n_k.float())
    return AggResult(_weighted_rows(w, u, _kernels(use_kernels)).to(updates.dtype), mask)


class RuleOptions(NamedTuple):
    """Per-call rule knobs.  ``afa`` holds an ``AFAConfig`` when rule == afa;
    ``num_selected`` (MKRUM) comes from the participation count on the host
    (``fed.server.make_rule_options``).  ``capturable``, set by the fused
    engines whose rounds are captured, asks a rule for no host read, so a
    CUDA graph can capture it (AFA then unrolls its screening loop).  ``plan_rows``, also set by the
    fused engines, is the run's full K: AFA's Gram kernels plan their column
    splits for it, whatever bucket the rows were compacted into."""

    num_byzantine: int = 3
    trim: int = 3
    num_selected: int | None = None
    use_kernels: bool | str = False
    afa: Any = None  # AFAConfig | None (typed Any to avoid an import cycle)
    capturable: bool = False
    plan_rows: int | None = None


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


def _opts_client_mesh(opts: RuleOptions):
    """The client mesh the options ask for, or None: the mesh matters only
    when ``opts.afa`` both names one and spans more than one shard (a
    one-shard mesh runs the unsharded code)."""
    cfg = opts.afa
    mesh = getattr(cfg, "client_mesh", None) if cfg is not None else None
    return mesh if (mesh is not None and mesh.num_shards > 1) else None


def _guard_all_blocked(res, mask, mesh=None):
    """Empty participation: an explicit zero update (a vector, or a tree on
    the leaf layout's tree forms) plus ``all_blocked``; with any live client
    the aggregate passes through unchanged.  Under a client mesh ``mask`` is
    this rank's rows, so the test sums the live flags over the ranks: a rank
    whose own clients are all blocked keeps the aggregate the others keep."""
    if mask is None:
        return res._replace(all_blocked=False)
    if mesh is not None:
        all_blocked = mesh.psum(mask.any().to(torch.int32)) == 0
    else:
        all_blocked = ~mask.any()
    aggregate = tree_map(lambda l: torch.where(all_blocked, torch.zeros_like(l), l),
                         res.aggregate)
    return res._replace(aggregate=aggregate, all_blocked=all_blocked)


def _spec(name: str) -> RuleSpec:
    try:
        return RULES[name]
    except KeyError:
        raise ValueError(f"unknown rule {name!r}; registered: {sorted(RULES)}") from None


def dispatch_rule(name: str, updates, n_k, p_k=None, mask=None,
                  opts: RuleOptions = RuleOptions()):
    """Matrix-form dispatch: ``updates`` is (K, d).  With a client mesh in
    ``opts.afa`` (the sharded fused engine) ``updates`` is this rank's
    rows, and only AFA, which has a hierarchical form, may dispatch."""
    spec = _spec(name)
    mesh = _opts_client_mesh(opts)
    if mesh is not None and name != "afa":
        raise ValueError(f"rule {name!r} has no client-sharded form; only 'afa' runs "
                         "hierarchically over a client mesh")
    return _guard_all_blocked(spec.matrix_fn(updates, n_k, p_k, mask, opts), mask, mesh)


TREE_LAYOUTS = ("packed", "leaf")


def dispatch_rule_tree(name: str, stacked, n_k, p_k=None, mask=None,
                       opts: RuleOptions = RuleOptions(), *, layout: str = "packed"):
    """Tree-form dispatch over a stacked tree.

    ``layout="packed"``: the tree is packed ONCE into a ``(K, D)`` buffer,
    the rule's matrix form runs on it and the aggregate is unpacked ONCE back
    to the tree.  ``layout="leaf"``: a rule with a tree form (AFA) runs it
    on the leaves; any other rule has only its matrix form, whose per-leaf
    flatten is the packed buffer, so it takes the packed path (and reaches
    the same kernels)."""
    spec = _spec(name)
    if layout not in TREE_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected {TREE_LAYOUTS}")
    if _opts_client_mesh(opts) is not None:
        raise ValueError("tree dispatch has no client-sharded form; the sharded engine packs "
                         "once and calls dispatch_rule on this rank's (K_local, D) block")
    if layout == "leaf" and spec.tree_fn is not None:
        return _guard_all_blocked(spec.tree_fn(stacked, n_k, p_k, mask, opts), mask)
    pspec = pack_spec(stacked, stacked=True)
    res = spec.matrix_fn(pack_stack(stacked, pspec), n_k, p_k, mask, opts)
    res = _guard_all_blocked(res, mask)
    return res._replace(aggregate=unpack_stack(res.aggregate, pspec))


def _mkrum_rule(u, n_k, p_k, mask, o: RuleOptions):
    m_sel = o.num_selected
    if m_sel is None:  # no participation count given: assume every client
        m_sel = max(u.shape[0] - o.num_byzantine - 2, 1)
    return mkrum_aggregate(u, mask=mask, num_byzantine=o.num_byzantine, num_selected=m_sel,
                           use_kernels=o.use_kernels)


register_rule(
    "fa", lambda u, n, p, m, o: fa_aggregate(u, n, mask=m, use_kernels=o.use_kernels)
)
register_rule("mkrum", _mkrum_rule)
register_rule(
    "comed", lambda u, n, p, m, o: comed_aggregate(u, mask=m, use_kernels=o.use_kernels)
)
register_rule(
    "trimmed_mean",
    lambda u, n, p, m, o: trimmed_mean_aggregate(u, mask=m, trim=o.trim,
                                                 use_kernels=o.use_kernels),
)
register_rule(
    "bulyan",
    lambda u, n, p, m, o: bulyan_aggregate(u, mask=m, num_byzantine=o.num_byzantine,
                                           use_kernels=o.use_kernels),
)
register_rule(
    "norm_clip",
    lambda u, n, p, m, o: norm_clip_aggregate(u, n, mask=m, use_kernels=o.use_kernels),
)
