"""Robust aggregation rules from the surrounding literature.

Counterpart of ``repro/core/extra_rules.py``:

* ``geomed`` — the geometric median by smoothed Weiszfeld iterations
  (Pillutla et al. 2019).
* ``centered_clip`` — centered clipping (Karimireddy et al. 2021): iterate
  v <- v + sum_k clip(u_k - v, tau) / K from the coordinate-wise median.
* :func:`zeno_aggregate` — Zeno (Xie et al. 2019): keep the updates whose
  validation loss drops most, less a norm penalty.

No kernel covers the Weiszfeld or clipping iterations, so both registered
rules run plain torch on every kernel route and never read
``opts.use_kernels``; ``centered_clip`` starts from the plain route's
median.  Zeno needs a server-side validation loss and the current weights,
which the uniform dispatch signature does not carry, so it stays out of the
registry, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.baselines import (
    AggResult,
    _all_live,
    _norm_weights,
    _ranks,
    comed_aggregate,
    register_rule,
)
from repro_torch.core.stats import masked_median

EPS = 1e-8


def geometric_median_aggregate(updates, n_k=None, p_k=None, mask=None, *,
                               iters: int = 8) -> AggResult:
    """``iters`` Weiszfeld steps from the mean of the live rows."""
    mask = _all_live(updates) if mask is None else mask
    u = updates.float()
    v = torch.where(mask[:, None], u, 0.0).sum(dim=0) / torch.clamp(mask.sum(), min=1)
    for _ in range(iters):
        dist = torch.sqrt(((u - v[None]) ** 2).sum(dim=1) + EPS)
        w = torch.where(mask, 1.0 / dist, 0.0)
        v = (w @ u) / torch.clamp(w.sum(), min=EPS)
    return AggResult(v.to(updates.dtype), mask)


def centered_clip_aggregate(updates, n_k=None, p_k=None, mask=None, *,
                            clip_tau: float | None = None, iters: int = 5) -> AggResult:
    """``iters`` clipped steps from the coordinate-wise median.
    ``clip_tau=None`` takes tau = twice the median distance of the live
    updates to that median: benign spread passes unclipped, outliers clip."""
    mask = _all_live(updates) if mask is None else mask
    u = updates.float()
    # a mean start is already poisoned by large-norm outliers, and tau-clipped
    # steps may never recover from it
    v = comed_aggregate(updates, mask=mask).aggregate.float()
    if clip_tau is None:
        dists = torch.sqrt(((u - v[None]) ** 2).sum(dim=1) + EPS)
        clip_tau = 2.0 * masked_median(dists, mask)
    for _ in range(iters):
        d = u - v[None]
        norms = torch.sqrt((d * d).sum(dim=1) + EPS)
        scale = torch.clamp(clip_tau / norms, max=1.0)
        d = d * torch.where(mask, scale, 0.0)[:, None]
        v = v + d.sum(dim=0) / torch.clamp(mask.sum(), min=1)
    return AggResult(v.to(updates.dtype), mask)


def zeno_aggregate(updates, n_k=None, p_k=None, mask=None, *,
                   loss_fn: Callable, w_prev, num_keep: int,
                   rho: float = 1e-3) -> AggResult:
    """Zeno's score loss(w_prev) - loss(u_k) - rho |u_k - w_prev|^2; the mean
    of the ``num_keep`` highest-scoring live updates.  ``loss_fn`` maps one
    (d,) parameter vector to a scalar validation loss."""
    K = updates.shape[0]
    mask = _all_live(updates) if mask is None else mask
    base = loss_fn(w_prev)
    losses = torch.stack([loss_fn(u) for u in updates])
    pen = rho * ((updates - w_prev[None]) ** 2).sum(dim=1)
    scores = torch.where(mask, base - losses - pen, -torch.inf)
    keep = (_ranks(torch.argsort(-scores, stable=True)) < num_keep) & mask
    c = _norm_weights(keep, torch.ones((K,), dtype=torch.float32, device=updates.device))
    return AggResult((c @ updates.float()).to(updates.dtype), keep)


register_rule("geomed", lambda u, n, p, m, o: geometric_median_aggregate(u, mask=m))
register_rule("centered_clip", lambda u, n, p, m, o: centered_clip_aggregate(u, mask=m))
