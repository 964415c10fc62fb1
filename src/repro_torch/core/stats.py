"""Masked scalar statistics used by the robust aggregation rules.

Counterpart of ``repro/core/stats.py``: a ``(K,)`` vector plus a boolean
participation mask, fixed-shape ops only (no boolean indexing).
"""

from __future__ import annotations

import torch


def masked_mean(x, mask):
    m = mask.sum()
    mean = torch.where(mask, x, 0.0).sum() / torch.clamp(m, min=1)
    return torch.where(m > 0, mean, 0.0)


def masked_std(x, mask, *, ddof: int = 0):
    m = mask.sum()
    mu = masked_mean(x, mask)
    var = torch.where(mask, (x - mu) ** 2, 0.0).sum() / torch.clamp(m - ddof, min=1)
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
    med = 0.5 * (xs[lo] + xs[hi])
    return torch.where(m > 0, med, 0.0)
