"""Adaptive Federated Averaging — the paper's Algorithm 1, in PyTorch.

Counterpart of ``repro/core/afa.py``, in two forms:

* the matrix form (``afa_aggregate``): updates as a dense ``(K, d)`` matrix,
  the form the packed dispatch and the kernels run;
* the tree form (``afa_aggregate_tree``): updates as a stacked tree (a
  leading client axis on every leaf), the form the ``leaf`` layout runs.
  Its Gram and dot products are accumulated leaf by leaf in leaf order, as
  the JAX package's are; it launches no kernel, whatever ``use_kernels``
  says (the JAX tree form has no Pallas call), and it runs the stopping
  loop.

The client-sharded form (``AFAConfig.client_mesh`` over more than one
shard, iterative variant only) runs on this rank's rows of the proposals and
meets the other ranks in all-reduces: each pass sums the local weighted
rows (a (d,) all-reduce), gathers the K similarities of the local rows
against that aggregate (an O(K) all-reduce of zero-padded blocks), and
shares the masked mean, median and std that rank 0 computes (a 3-scalar
all-reduce to which the other ranks add zeros); the tail test then runs
alike on every rank.  ``good_mask`` and ``similarities`` come back for the
local rows, the aggregate whole on every rank.

On a grid (``afa_aggregate_tree(..., shards=TreeShards(...))``: the vmap
round of ``fed.distributed`` under a data x model mesh, or its ``scan``
round under FSDP), the tree form runs on this rank's client rows (under
FSDP all K where the grid has no client axis and ``rows`` is ``()``, else
its client row's, ``rows`` ``("client",)``) and this rank's blocks of the
leaves, each split over its own axes (``TreeShards.split``: none, ``model``,
the data axes, or both).  Each dot product is a leaf's float32 partial sum
over its block, summed over exactly that leaf's axes in one all-reduce a
product and group of axes (a replicated leaf counted once), then the leaves
folded in leaf order; a weighted sum over the clients is a fold of the
local rows, a row at a time, summed over the client rows; the similarities
of the local rows are gathered to all K (sums of zero-padded blocks), so
every rank screens the same K scalars.  A leaf is read a client row at a
time (``Dequantized``: the ``scan`` round's int8 store, dequantized a row
at a time), so no stack of float32 rows is held.  The aggregate comes back
as this rank's blocks, the mask and the similarities whole.  The gram
variant needs every client row's products, so it runs only when the
clients are on one row.

Two variants:

* ``variant="iterative"`` — paper-faithful: every screening pass recomputes
  the aggregate and touches the full update set.
* ``variant="gram"`` — the K x K Gram matrix once, then O(K^2) passes:
  <w_agg, u_k> = (G c)_k and |w_agg|^2 = c^T G c.

Kernel routes (``AFAConfig.use_kernels`` resolving to ``cuda``):

* iterative: ``cosine_sim`` against ``weighted_sum`` each pass, and a final
  ``weighted_sum``;
* gram, ``kernel_launch="chained"``: ``gram`` and a final ``weighted_sum``;
* gram, ``kernel_launch="fused"``: ``afa_screen``, all of Algorithm 1.

Each route keeps its own EPS placement, as in the JAX package: the plain
iterative route clamps the norms, the kernel iterative route clamps the
squared norms before the square root, the gram route clamps c^T G c.

Sums over the client axis (the weights' normaliser, c^T U, G c, c^T G c) are
left folds in row order (``core.stats.row_sum``), so a live client's result
does not depend on the row it occupies: the segmented fused engine compacts
blocked rows away between segments.

The screening loop stops after the first pass that marks no client, which
reads the device once a pass.  With ``unroll=True`` it runs ``max_rounds``
passes under a device flag instead: a pass after the loop would have stopped
leaves the mask, xi, the pass count and the similarities as they are, so the
outputs equal the stopping loop's bit for bit with no host read
(``lax.while_loop`` in the JAX package).  The fused engines ask for it,
since they capture the round as a CUDA graph; the batched engine keeps the
stopping loop, whose fewer passes launch fewer operations from the host.
Each pass runs inside ``utils.regions.region("screen-pass")``, from which
``analysis.collectives`` reads the sharded form's collectives a pass.

``plan_rows`` reaches the Gram kernels (``gram``, ``afa_screen``): their
column splits are planned for that many rows, so the fused engines pass the
run's full K and a compacted bucket sums each Gram entry over D in the
one-shot run's chunks (``kernels.ops.gram_geometry``).

Direction convention follows the paper's algorithm box: when mean >= median
the high-similarity tail is removed, otherwise the low tail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.stats import masked_mean, masked_median, masked_std, row_sum
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.policy import resolve_kernel_mode
from repro_torch.utils.regions import SCREEN_PASS, region
from repro_torch.utils.trees import (
    tree_dot,
    tree_leaves,
    tree_map,
    tree_structure,
    tree_unflatten,
)

EPS = 1e-12


class AFAConfig(NamedTuple):
    xi0: float = 2.0
    delta_xi: float = 0.5
    max_rounds: int = 8
    ddof: int = 0
    variant: str = "iterative"  # "iterative" | "gram"
    # bool for selection by $REPRO_TORCH_KERNELS, or a pinned mode string
    # "torch" / "cuda" (repro_torch.kernels.policy)
    use_kernels: bool | str = False
    # "fused" (one afa_screen call, gram variant only) | "chained"
    kernel_launch: str = "fused"
    # hierarchical two-stage screening over a client mesh
    # (repro_torch.launch.mesh.ClientMesh): over more than one shard the
    # inputs are this rank's K / num_shards rows; a one-shard mesh takes the
    # unsharded route unchanged
    client_mesh: object = None


class TreeShards(NamedTuple):
    """Where the tree form's inputs lie on a grid (``launch.mesh.GridMesh``):
    the client rows over ``rows`` (axes; ``()``: every rank holds all K),
    and, in leaf order, the axes each leaf's blocks split over (``()``,
    ``("model",)``, the data axes, or both, in the grid's order)."""

    grid: object
    rows: tuple
    split: tuple


class Dequantized:
    """A stacked leaf stored as int8 deltas from ``base`` with one scale a
    row (``fed.distributed``'s int8 ``scan`` store): row k reads ``q[k] *
    scales[k] + base`` in float32, the one-card dequantization's
    elementwise ops, one row at a time."""

    dtype = torch.float32

    def __init__(self, q: torch.Tensor, scales: torch.Tensor, base: torch.Tensor):
        self.q, self.scales, self.base = q, scales, base

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.base.device

    def row(self, k: int) -> torch.Tensor:
        return self.q[k].float() * self.scales[k] + self.base.float()


def _row(leaf, k: int) -> torch.Tensor:
    """Client row ``k`` of a stacked leaf, in float32."""
    return leaf.row(k) if isinstance(leaf, Dequantized) else leaf[k].float()


class AFAResult(NamedTuple):
    aggregate: torch.Tensor        # (d,) vector
    good_mask: torch.Tensor        # (K,) bool — True = kept
    rounds: torch.Tensor           # () int32 — outlier-removal rounds run
    similarities: torch.Tensor     # (K,) final-round cosine similarities
    # set by dispatch_rule: True when the participation mask was empty, in
    # which case the aggregate is a zero update
    all_blocked: torch.Tensor | bool = False


def _weights(mask, p, n):
    c = torch.where(mask, p * n, 0.0)
    return c / torch.clamp(row_sum(c), min=EPS)


def _mark_bad(s, mask, xi, ddof):
    """One Algorithm-1 screening pass: returns the newly-bad mask."""
    mu_hat = masked_mean(s, mask)
    mu_bar = masked_median(s, mask)
    sigma = masked_std(s, mask, ddof=ddof)
    low_tail = mask & (s < mu_bar - xi * sigma)
    high_tail = mask & (s > mu_bar + xi * sigma)
    bad = torch.where(mu_hat < mu_bar, low_tail, high_tail)
    # never remove below 2 survivors — the similarity stats stop being defined
    keep_floor = (mask & ~bad).sum() >= 2
    return bad & keep_floor


def _screen(sims, mask, p, n, config: AFAConfig, unroll: bool, mark_bad=None):
    """Algorithm 1's screening passes from the participation ``mask``:
    ``sims(c)`` gives the K similarities against the aggregate of weights
    ``c``, ``mark_bad(s, mask, xi)`` a pass's newly bad clients
    (``_mark_bad`` by default).  Returns ``(similarities, mask, rounds)``;
    ``unroll`` runs ``max_rounds`` passes under a device flag instead of
    stopping."""
    if mark_bad is None:
        mark_bad = lambda s, mask, xi: _mark_bad(s, mask, xi, config.ddof)
    dev = mask.device
    # round-0 similarities, not zeros, when max_rounds=0: the loop never runs
    s = (sims(_weights(mask, p, n)) if config.max_rounds == 0
         else torch.zeros(mask.shape, dtype=torch.float32, device=dev))
    xi = torch.full((), config.xi0, dtype=torch.float32, device=dev)
    if unroll:
        rounds = torch.zeros((), dtype=torch.int32, device=dev)
        live = torch.ones((), dtype=torch.bool, device=dev)   # this pass runs
        for _ in range(config.max_rounds):
            with region(SCREEN_PASS):
                s_pass = sims(_weights(mask, p, n))
                bad = mark_bad(s_pass, mask, xi)
                s = torch.where(live, s_pass, s)
                mask = torch.where(live, mask & ~bad, mask)
                xi = torch.where(live, xi + config.delta_xi, xi)
                rounds = rounds + live.to(torch.int32)
                live = live & bad.any()
        return s, mask, rounds
    n_passes, changed = 0, True
    while changed and n_passes < config.max_rounds:
        with region(SCREEN_PASS):
            s = sims(_weights(mask, p, n))
            bad = mark_bad(s, mask, xi)
            mask = mask & ~bad
            xi = xi + config.delta_xi
            changed = bool(bad.any())
        n_passes += 1
    return s, mask, torch.full((), n_passes, dtype=torch.int32, device=dev)


def afa_aggregate(
    updates: torch.Tensor,          # (K, d)
    n_k: torch.Tensor,              # (K,) data-point counts
    p_k: torch.Tensor,              # (K,) reputation means
    mask0: torch.Tensor | None = None,  # (K,) initial participation
    config: AFAConfig = AFAConfig(),
    *,
    unroll: bool = False,
    plan_rows: int | None = None,
) -> AFAResult:
    if config.kernel_launch not in ("fused", "chained"):
        raise ValueError(
            f"AFAConfig.kernel_launch={config.kernel_launch!r} invalid; "
            "expected 'fused' or 'chained'"
        )
    if config.variant not in ("iterative", "gram"):
        raise ValueError(
            f"AFAConfig.variant={config.variant!r} invalid; "
            "expected 'iterative' or 'gram'"
        )
    K = updates.shape[0]
    dev = updates.device
    mask0 = torch.ones((K,), dtype=torch.bool, device=dev) if mask0 is None else mask0.bool()
    upd32 = updates.float().contiguous()
    n32 = n_k.float()
    p32 = p_k.float()
    kernels = resolve_kernel_mode(config.use_kernels) == "cuda"

    if config.client_mesh is not None and config.client_mesh.num_shards > 1:
        if config.variant != "iterative":
            raise ValueError(
                "sharded AFA implements the iterative variant only: the gram variant needs "
                "O(K_local * K) Gram rows a shard, which defeats the client sharding; set "
                f"variant='iterative' (got {config.variant!r})"
            )
        return _afa_aggregate_sharded(updates.dtype, upd32, n32, p32, mask0, config, kernels,
                                      unroll)

    if config.variant == "gram" and kernels and config.kernel_launch == "fused":
        agg, good, rounds, sims = kernel_ops.afa_screen(
            upd32, (p32 * n32).contiguous(), mask0,
            xi0=config.xi0, delta_xi=config.delta_xi,
            max_rounds=config.max_rounds, ddof=config.ddof, plan_rows=plan_rows,
        )
        return AFAResult(agg.to(updates.dtype), good, rounds, sims)

    if config.variant == "gram":
        gram = kernel_ops.gram(upd32, plan_rows=plan_rows) if kernels else upd32 @ upd32.T
        row_norms = torch.linalg.vector_norm(upd32, dim=1)

        def sims(c):
            gc = row_sum(gram.T * c[:, None])                    # (G c)_i = sum_k G_ik c_k
            agg_norm = torch.sqrt(torch.clamp(row_sum(c * gc), min=EPS))
            return gc / (torch.clamp(row_norms, min=EPS) * agg_norm)

    elif kernels:

        def sims(c):
            return kernel_ops.cosine_sim(upd32, kernel_ops.weighted_sum(c, upd32))

    else:
        row_norms = torch.linalg.vector_norm(upd32, dim=1)

        def sims(c):
            agg = row_sum(c[:, None] * upd32)
            agg_norm = torch.linalg.vector_norm(agg)
            return (upd32 @ agg) / (
                torch.clamp(row_norms, min=EPS) * torch.clamp(agg_norm, min=EPS)
            )

    s, mask, rounds = _screen(sims, mask0, p32, n32, config, unroll)
    w = _weights(mask, p32, n32)
    agg = kernel_ops.weighted_sum(w, upd32) if kernels else row_sum(w[:, None] * upd32)
    return AFAResult(
        aggregate=agg.to(updates.dtype), good_mask=mask, rounds=rounds, similarities=s,
    )


def _afa_aggregate_sharded(dtype, upd32, n32, p32, mask0, config, kernels, unroll):
    """Algorithm 1 over the client mesh ``config.client_mesh`` (matrix form,
    iterative).  The inputs are this rank's K_local rows; the screening
    state (the mask, the p*n weights, the similarities) is K scalars, the
    same on every rank.  On the kernel route the local weighted sum and the
    local similarities run ``weighted_sum`` and ``cosine_sim`` on this
    rank's rows."""
    mesh = config.client_mesh
    K_local = upd32.shape[0]
    K = K_local * mesh.num_shards
    local = mesh.row_block(K_local)
    dev = upd32.device

    # n, p and the mask of every rank, in one all-reduce
    nps = mesh.gather_rows(torch.stack([n32, p32, mask0.float()], dim=1), K)
    n_g, p_g, mask = nps[:, 0], nps[:, 1], nps[:, 2] > 0

    if kernels:

        def sims(c):
            w_agg = mesh.psum(kernel_ops.weighted_sum(c[local].contiguous(), upd32))
            return mesh.gather_rows(kernel_ops.cosine_sim(upd32, w_agg), K)

    else:
        row_norms_l = torch.linalg.vector_norm(upd32, dim=1)

        def sims(c):
            w_agg = mesh.psum(row_sum(c[local][:, None] * upd32))
            agg_norm = torch.linalg.vector_norm(w_agg)
            s_l = (upd32 @ w_agg) / (
                torch.clamp(row_norms_l, min=EPS) * torch.clamp(agg_norm, min=EPS)
            )
            return mesh.gather_rows(s_l, K)

    def mark_bad(s, mask, xi):
        # _mark_bad's tail test with the statistics (a sort of the K
        # similarities) on rank 0 only, shared as a 3-scalar all-reduce: the
        # other ranks add exact zeros, so every rank reads rank 0's bits
        if mesh.rank == 0:
            stats = torch.stack([masked_mean(s, mask), masked_median(s, mask),
                                 masked_std(s, mask, ddof=config.ddof)])
        else:
            stats = torch.zeros((3,), dtype=torch.float32, device=dev)
        mu_hat, mu_bar, sigma = mesh.psum(stats)
        low_tail = mask & (s < mu_bar - xi * sigma)
        high_tail = mask & (s > mu_bar + xi * sigma)
        bad = torch.where(mu_hat < mu_bar, low_tail, high_tail)
        return bad & ((mask & ~bad).sum() >= 2)

    s, mask, rounds = _screen(sims, mask, p_g, n_g, config, unroll, mark_bad)
    w = _weights(mask, p_g, n_g)[local].contiguous()
    part = kernel_ops.weighted_sum(w, upd32) if kernels else row_sum(w[:, None] * upd32)
    return AFAResult(aggregate=mesh.psum(part).to(dtype), good_mask=mask[local],
                     rounds=rounds, similarities=s[local])


def _stacked_weighted_sum(stacked, c):
    """sum_k c_k * u_k over the leading client axis, leaf by leaf (a
    row-order fold)."""
    def leaf(l):
        cb = c.reshape((-1,) + (1,) * (l.ndim - 1)).float()
        return row_sum(cb * l.float()).to(l.dtype)

    return tree_map(leaf, stacked)


def _stacked_gram(stacked):
    """K x K Gram matrix, accumulated leaf by leaf."""
    tot = None
    for l in tree_leaves(stacked):
        f = l.reshape(l.shape[0], -1).float()
        part = f @ f.T
        tot = part if tot is None else tot + part
    return tot


def afa_aggregate_tree(
    stacked_updates,               # tree, every leaf (K, ...)
    n_k: torch.Tensor,
    p_k: torch.Tensor,
    mask0: torch.Tensor | None = None,
    config: AFAConfig = AFAConfig(),
    *,
    shards: TreeShards | None = None,
    unroll: bool = False,
) -> AFAResult:
    """Algorithm 1 on a stacked tree; the aggregate is a tree of one
    client's leaves.  The row norms are clamped inside the square root,
    and sums over the client axis are row-order folds, as in the matrix
    form.  ``shards``: the leaves hold this rank's rows and blocks on a
    grid (see the module docstring); ``n_k``, ``p_k`` and ``mask0`` are
    whole.  ``unroll`` (one card): ``max_rounds`` screening passes under a
    device flag, with no host read, as the matrix form's."""
    if config.variant not in ("iterative", "gram"):
        raise ValueError(
            f"AFAConfig.variant={config.variant!r} invalid; "
            "expected 'iterative' or 'gram'"
        )
    if shards is not None and (shards.grid.size(shards.rows) > 1 or any(shards.split)):
        return _afa_tree_sharded(stacked_updates, n_k.float(), p_k.float(), mask0, config,
                                 shards)
    leaves = tree_leaves(stacked_updates)
    K, dev = leaves[0].shape[0], leaves[0].device
    mask0 = torch.ones((K,), dtype=torch.bool, device=dev) if mask0 is None else mask0.bool()
    n32, p32 = n_k.float(), p_k.float()
    row_norms = torch.sqrt(torch.clamp(tree_dot(stacked_updates, stacked_updates, axes=1),
                                       min=EPS))

    if config.variant == "gram":
        gram = _stacked_gram(stacked_updates)

        def sims(c):
            gc = row_sum(gram.T * c[:, None])
            agg_norm = torch.sqrt(torch.clamp(row_sum(c * gc), min=EPS))
            return gc / (row_norms * agg_norm)

    else:

        def sims(c):
            agg = _stacked_weighted_sum(stacked_updates, c)
            dots = tree_dot(stacked_updates, tree_map(lambda v: v[None], agg), axes=1)
            agg_norm = torch.sqrt(torch.clamp(tree_dot(agg, agg), min=EPS))
            return dots / (row_norms * agg_norm)

    s, mask, rounds = _screen(sims, mask0, p32, n32, config, unroll)
    agg = _stacked_weighted_sum(stacked_updates, _weights(mask, p32, n32))
    return AFAResult(aggregate=agg, good_mask=mask, rounds=rounds, similarities=s)


def _leaf_sums(parts: list, split: tuple, grid) -> torch.Tensor:
    """Per-leaf float32 partial sums (one shape), each group of leaves with
    the same axes summed over them in one all-reduce, then folded in leaf
    order."""
    parts = torch.stack(parts)
    for axes in sorted(set(split) - {()}):
        at = torch.tensor([i for i, a in enumerate(split) if a == axes], device=parts.device)
        parts = parts.index_copy(0, at, grid.psum(parts.index_select(0, at), axes))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum()


def _afa_tree_sharded(stacked, n32, p32, mask0, config, shards: TreeShards) -> AFAResult:
    grid, rows, split = shards
    if config.variant == "gram" and grid.size(rows) > 1:
        raise ValueError(
            "the tree form's gram variant needs the Gram entries of every pair of clients, "
            f"which lie on {grid.size(rows)} client rows; set variant='iterative'")
    leaves = tree_leaves(stacked)
    K_local = leaves[0].shape[0]
    K = K_local * grid.size(rows)
    dev = leaves[0].device
    mask0 = (torch.ones((K,), dtype=torch.bool, device=dev) if mask0 is None
             else mask0.bool())
    if mask0.shape[0] != K:
        raise ValueError(f"{K_local} client rows a rank x {grid.size(rows)} rows != the "
                         f"{mask0.shape[0]} clients of the mask")
    local = grid.block(K, rows)

    def norms2(l):
        return torch.stack([_dot(u, u) for u in (_row(l, k) for k in range(K_local))])

    row_norms = torch.sqrt(torch.clamp(_leaf_sums([norms2(l) for l in leaves], split, grid),
                                       min=EPS))

    def weighted_sum(c):
        """sum_k c_k u_k over all K clients, this rank's blocks, each leaf
        in its dtype: a fold of the local rows, summed over the rows."""
        cl = c[local].float()
        out = []
        for l in leaves:
            part = cl[0] * _row(l, 0)
            for k in range(1, K_local):
                part = part + cl[k] * _row(l, k)
            if grid.size(rows) > 1:
                part = grid.psum(part, rows)
            out.append(part.to(l.dtype))
        return out

    if config.variant == "gram":

        def gram_leaf(l):
            g = torch.zeros((K, K), dtype=torch.float32, device=dev)
            for i in range(K):
                ui = _row(l, i)
                for j in range(i, K):
                    g[i, j] = g[j, i] = _dot(ui, _row(l, j))
            return g

        gram = _leaf_sums([gram_leaf(l) for l in leaves], split, grid)

        def sims(c):
            gc = row_sum(gram.T * c[:, None])
            agg_norm = torch.sqrt(torch.clamp(row_sum(c * gc), min=EPS))
            return gc / (row_norms * agg_norm)

    else:

        def sims(c):
            agg = [a.float() for a in weighted_sum(c)]
            # each leaf's dots of the local rows and its |agg|^2, summed in one
            # all-reduce a group of axes
            total = _leaf_sums([torch.cat([torch.stack([_dot(_row(l, k), a)
                                                        for k in range(K_local)]),
                                           _dot(a, a)[None]])
                                for l, a in zip(leaves, agg)], split, grid)
            agg_norm = torch.sqrt(torch.clamp(total[K_local], min=EPS))
            s_local = total[:K_local] / (row_norms * agg_norm)
            return grid.gather_rows(s_local, K, rows) if grid.size(rows) > 1 else s_local

    s, mask, rounds = _screen(sims, mask0, p32, n32, config, False)
    agg = tree_unflatten(tree_structure(stacked), weighted_sum(_weights(mask, p32, n32)))
    return AFAResult(aggregate=agg, good_mask=mask, rounds=rounds, similarities=s)


def _default_p(p_k, K, device):
    return torch.full((K,), 0.5, dtype=torch.float32, device=device) if p_k is None else p_k


def _afa_matrix_rule(updates, n_k, p_k, mask, opts):
    cfg = opts.afa if opts.afa is not None else AFAConfig(use_kernels=opts.use_kernels)
    return afa_aggregate(
        updates, n_k, _default_p(p_k, updates.shape[0], updates.device),
        mask0=mask, config=cfg, unroll=opts.capturable, plan_rows=opts.plan_rows,
    )


def _afa_tree_rule(stacked, n_k, p_k, mask, opts):
    cfg = opts.afa if opts.afa is not None else AFAConfig()
    leaf = tree_leaves(stacked)[0]
    return afa_aggregate_tree(
        stacked, n_k, _default_p(p_k, leaf.shape[0], leaf.device), mask0=mask, config=cfg,
        unroll=opts.capturable,
    )


from repro_torch.core.baselines import register_rule  # noqa: E402  (baselines does not import afa)

register_rule("afa", _afa_matrix_rule, _afa_tree_rule, updates_reputation=True)
