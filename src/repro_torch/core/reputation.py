"""Beta-Bernoulli client reputation (the paper's "Hidden Markov Model").

Counterpart of ``repro/core/reputation.py``.  Each client k carries a
Beta(alpha_k, beta_k) posterior over "provides good updates".  The posterior
mean weights the aggregation (eq. 3/5); the Beta CDF at 0.5 drives blocking
(eq. 6):

    block_k  <=>  Pr(G_k <= 0.5) = I_{0.5}(alpha_k, beta_k) > delta

torch has no ``betainc``, so :func:`betainc` evaluates the regularized
incomplete beta by Lentz's continued fraction, in float64, on the K scalars
moved to the host CPU (a few hundred tiny tensor ops; on the card each would
be a kernel launch).  The batched engine calls it every round.

The fused engines decide blocking on the device instead.  A client's counts
``g = alpha - alpha0`` and ``b = beta - beta0`` are integers, and
``I_{0.5}(alpha0 + g, beta0 + b)`` rises with ``b``; so once per run the host
tabulates, for each ``g`` in ``0..n``, the smallest ``b`` that blocks
(:func:`blocking_table`, with :func:`betainc` at the very float32 values the
posteriors hold), and each round gathers from that table
(``update_reputation(..., table=...)``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

_CF_TINY = 1e-300
_CF_EPS = 1e-15
_CF_MAX_ITER = 1000


class ReputationState(NamedTuple):
    alpha: torch.Tensor    # (K,) float32 — alpha0 + n_good
    beta: torch.Tensor     # (K,) float32 — beta0  + n_bad
    blocked: torch.Tensor  # (K,) bool


def init_reputation(num_clients: int, alpha0: float = 3.0, beta0: float = 3.0, *,
                    device="cuda") -> ReputationState:
    """Prior Beta(alpha0, beta0) for every client, none blocked, on
    ``device`` (the card unless ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    return ReputationState(
        alpha=torch.full((num_clients,), float(alpha0), dtype=torch.float32, device=device),
        beta=torch.full((num_clients,), float(beta0), dtype=torch.float32, device=device),
        blocked=torch.zeros((num_clients,), dtype=torch.bool, device=device),
    )


def p_good(state: ReputationState) -> torch.Tensor:
    """Posterior mean E[G_k | o_{1:t}] = alpha / (alpha + beta)  (eq. 5)."""
    return state.alpha / (state.alpha + state.beta)


def block_probability(state: ReputationState) -> torch.Tensor:
    """Pr(G_k <= 0.5) = I_{0.5}(alpha_k, beta_k)  (eq. 6): :func:`betainc` in
    float64 on the host, returned as float32 on the posteriors' device."""
    return betainc(state.alpha, state.beta, 0.5).to(state.alpha.device, torch.float32)


def _guard(v):
    return torch.where(v.abs() < _CF_TINY, torch.full_like(v, _CF_TINY), v)


def _betacf(a, b, x):
    """Continued fraction of I_x(a, b) by the modified Lentz method; every
    argument a float64 tensor of one shape."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _guard(1.0 - qab * x / qap)
    h = d.clone()
    for m in range(1, _CF_MAX_ITER + 1):
        m2 = 2.0 * m
        num = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / _guard(1.0 + num * d)
        c = _guard(1.0 + num / c)
        h = h * d * c
        num = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / _guard(1.0 + num * d)
        c = _guard(1.0 + num / c)
        step = d * c
        h = h * step
        if bool(((step - 1.0).abs() < _CF_EPS).all()):
            break
    return h


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` in float64 on the CPU.

    ``a``, ``b``, ``x`` broadcast against each other (tensors on any device
    or Python numbers); the result is a float64 CPU tensor.
    """
    a, b, x = torch.broadcast_tensors(
        *(torch.as_tensor(v).detach().to("cpu", torch.float64) for v in (a, b, x))
    )
    # the fraction converges fast for x < (a + 1) / (a + b + 2); use the
    # symmetry I_x(a, b) = 1 - I_{1-x}(b, a) elsewhere
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    inner = (xx > 0) & (xx < 1)
    xs = torch.where(inner, xx, torch.full_like(xx, 0.5))
    log_front = (torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
                 + aa * torch.log(xs) + bb * torch.log1p(-xs))
    val = torch.exp(log_front) * _betacf(aa, bb, xs) / aa
    val = torch.where(inner, val, torch.where(xx <= 0, 0.0, 1.0))
    return torch.where(swap, 1.0 - val, val)


def _f32_counts(start: float, n: int) -> torch.Tensor:
    """``start``, ``start + 1``, ..., ``start + n`` as float32 sums one at a
    time: the values a posterior holds after 0..n increments."""
    vals = [torch.tensor(float(start), dtype=torch.float32)]
    for _ in range(n):
        vals.append(vals[-1] + 1.0)
    return torch.stack(vals)


@functools.lru_cache(maxsize=16)
def _blocking_table(alpha0: float, beta0: float, delta: float, n: int) -> np.ndarray:
    a = _f32_counts(alpha0, n)
    b = _f32_counts(beta0, n)
    over = (betainc(a[:, None], b[None, :], 0.5) > delta).numpy()   # (g, b)
    first = np.where(over.any(axis=1), over.argmax(axis=1), n + 1)
    return first.astype(np.int64)


def blocking_table(alpha0: float, beta0: float, delta: float, n: int) -> np.ndarray:
    """``(n + 1,)`` int64: entry ``g`` is the smallest bad count ``b`` in
    ``0..n`` with ``I_{0.5}(alpha0 + g, beta0 + b) > delta``, or ``n + 1`` when
    none is.  The arguments are the float32 posteriors after ``g`` and ``b``
    increments, as ``update_reputation`` builds them, so a table lookup blocks
    exactly where :func:`betainc` does for every count up to ``n``."""
    return _blocking_table(float(alpha0), float(beta0), float(delta), int(n)).copy()


def blocked_by_table(alpha, beta, table: torch.Tensor, alpha0: float,
                     beta0: float) -> torch.Tensor:
    """``I_{0.5}(alpha, beta) > delta`` read from ``blocking_table``'s
    ``table`` (on the posteriors' device), with no host read: ``b >=
    table[g]``.  Pad rows of a compacted state (``alpha = beta = 1``) have
    negative counts; their index is clamped, and they are blocked already."""
    n = table.shape[0] - 1
    g = torch.round(alpha - alpha0).to(torch.int64).clamp(0, n)
    b = torch.round(beta - beta0).to(torch.int64)
    return b >= table.index_select(0, g)


def update_reputation(
    state: ReputationState,
    good_mask: torch.Tensor,
    participated: torch.Tensor,
    *,
    delta: float = 0.95,
    table=None,
) -> ReputationState:
    """Bayesian update from one round's aggregation outcome.

    Only participating, un-blocked clients get their posterior touched.
    Blocking is monotone: once blocked, always blocked.  ``table`` None
    tests ``betainc`` on the host; else ``(table, alpha0, beta0)`` with
    ``blocking_table``'s table on the posteriors' device, for the rounds no
    host read may interrupt.
    """
    participated = participated & ~state.blocked
    good = participated & good_mask
    bad = participated & ~good_mask
    alpha = state.alpha + good.float()
    beta = state.beta + bad.float()
    if table is None:
        over = (betainc(alpha, beta, 0.5) > delta).to(state.blocked.device)
    else:
        over = blocked_by_table(alpha, beta, *table)
    return ReputationState(alpha, beta, state.blocked | over)


def update_reputation_weighted(
    state: ReputationState,
    good_mask: torch.Tensor,
    participated: torch.Tensor,
    weights,
    *,
    delta: float = 0.95,
) -> ReputationState:
    """:func:`update_reputation` with per-client evidence weights in [0, 1].

    The serving tier's staleness decay: an update trained against the
    parameters of round ``t - tau`` enters the posterior fractionally,
    ``alpha += w * good`` and ``beta += w * bad`` with ``w = decay**tau``, a
    tempered Beta update.  The counts are then fractional, which
    ``blocking_table`` does not cover, so blocking tests :func:`betainc` on
    the host.  ``weights = 1`` gives :func:`update_reputation` (``table=None``)
    bit for bit: ``x * 1.0`` is ``x``.
    """
    participated = participated & ~state.blocked
    good = participated & good_mask
    bad = participated & ~good_mask
    w = torch.as_tensor(weights, dtype=torch.float32, device=state.alpha.device)
    alpha = state.alpha + good.float() * w
    beta = state.beta + bad.float() * w
    over = (betainc(alpha, beta, 0.5) > delta).to(state.blocked.device)
    return ReputationState(alpha, beta, state.blocked | over)


def mark_blocked_round(
    rounds_blocked: torch.Tensor,
    blocked_before: torch.Tensor,
    blocked_after: torch.Tensor,
    round_index,
) -> torch.Tensor:
    """Record *when* each client was blocked, 1-indexed.

    ``round_index`` is the 0-based index of the round being absorbed; a client
    blocked during the first round gets 1.  Entries stay -1 until their client
    is blocked and are never overwritten afterwards.
    """
    newly = blocked_after & ~blocked_before & (rounds_blocked < 0)
    stamp = torch.as_tensor(round_index, dtype=torch.int32, device=rounds_blocked.device) + 1
    return torch.where(newly, stamp, rounds_blocked)


def gather_reputation(state: ReputationState, keep, pad_to: int) -> ReputationState:
    """Compact the posteriors to the kept client ids ``keep`` (ascending;
    ``-1`` marks a pad slot) and pad to ``pad_to`` entries.  Pads are blocked
    for good, with ``alpha = beta = 1``."""
    keep = np.asarray(keep, np.int64)
    dev = state.alpha.device
    idx = torch.from_numpy(np.maximum(keep, 0)).to(dev)
    live = torch.from_numpy(keep >= 0).to(dev)
    pad = pad_to - keep.shape[0]

    def take(leaf, fill):
        out = torch.where(live, leaf.index_select(-1, idx), torch.full_like(leaf[..., :1], fill))
        if pad > 0:
            tail = torch.full(out.shape[:-1] + (pad,), fill, dtype=out.dtype, device=dev)
            out = torch.cat([out, tail], dim=-1)
        return out

    return ReputationState(
        alpha=take(state.alpha, 1.0), beta=take(state.beta, 1.0),
        blocked=take(state.blocked, True),
    )


def scatter_reputation(full: ReputationState, compact: ReputationState,
                       keep) -> ReputationState:
    """Re-embed a compacted posterior into the full-K layout (inverse of
    :func:`gather_reputation`): clients not in ``keep`` keep their entries
    in ``full``, which is exact because only blocked clients are dropped and
    blocking freezes a posterior; pad slots are dropped."""
    keep = np.asarray(keep, np.int64)
    live = keep >= 0
    dev = full.alpha.device
    idx = torch.from_numpy(keep[live]).to(dev)
    sel = torch.from_numpy(np.nonzero(live)[0]).to(dev)

    def put(f, c):
        out = f.clone()
        out[..., idx] = c.index_select(-1, sel)
        return out

    return ReputationState(
        alpha=put(full.alpha, compact.alpha), beta=put(full.beta, compact.beta),
        blocked=put(full.blocked, compact.blocked),
    )


def min_rounds_to_block(alpha0: float = 3.0, beta0: float = 3.0, delta: float = 0.95) -> int:
    """Smallest n with I_{0.5}(alpha0, beta0 + n) > delta.

    With the paper's alpha0 = beta0 = 3 and delta = 0.95 this returns 6:
    I_{0.5}(3, 8) = 0.94531 < 0.95 and I_{0.5}(3, 9) = 0.96729.
    """
    for n in range(1, 10_000):
        if float(betainc(alpha0, beta0 + n, 0.5)) > delta:
            return n
    raise ValueError("delta unreachable")
