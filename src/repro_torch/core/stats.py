"""Masked scalar statistics used by the robust aggregation rules.

Counterpart of ``repro/core/stats.py``: a ``(K,)`` vector plus a boolean
participation mask, fixed-shape ops only (no boolean indexing, and no host
read: every function runs inside a captured CUDA graph).

Sums over the client axis are left folds in row order (``row_sum``).  The
segmented fused engine compacts blocked clients out of the client axis, so a
live client's row moves; a fold adds the live rows in the same order in
every layout (a dead row adds an exact zero), where a tree reduction would
pair them differently and round differently.
"""

from __future__ import annotations

import torch


def row_sum(x):
    """Sum over dim 0 as a left fold in row order: ``x[0] + x[1] + ...``.
    A scan along the outer dimension, which adds sequentially on the CPU and
    on the card (the CPU accumulates float32 in float64)."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    return flat.cumsum(0)[-1].reshape(x.shape[1:])


def masked_mean(x, mask):
    m = mask.sum()
    mean = row_sum(torch.where(mask, x, 0.0)) / torch.clamp(m, min=1)
    return torch.where(m > 0, mean, 0.0)


def masked_std(x, mask, *, ddof: int = 0):
    m = mask.sum()
    mu = masked_mean(x, mask)
    var = row_sum(torch.where(mask, (x - mu) ** 2, 0.0)) / torch.clamp(m - ddof, min=1)
    return torch.sqrt(torch.clamp(var, min=0.0))


def masked_median(x, mask):
    """Median of the masked subset (average of the two central order stats).

    Masked-out entries are pushed to +inf before the sort so they land at the
    tail; the order statistics ``(m-1)//2`` and ``m//2`` come from the live
    count ``m``.
    """
    m = mask.sum()
    xs = torch.sort(torch.where(mask, x, torch.inf)).values
    lo = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)
    med = 0.5 * (xs.index_select(0, lo.reshape(1)) + xs.index_select(0, hi.reshape(1)))[0]
    return torch.where(m > 0, med, 0.0)
