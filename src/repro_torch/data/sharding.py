"""Client shard construction: IID (the paper's equal split) and Dirichlet
non-IID, the padded ``(K, n_max, ...)`` stacking of ragged shards, and its
inverse ``compact_stack``, with which the segmented fused engine drops
blocked clients between segments, and ``shard_compact_plan``, its layout
when the clients are sharded over ranks.  A numpy copy of those functions of
``repro/data/sharding.py``; the same seed gives the same shards."""

from __future__ import annotations

import numpy as np


def iid_shards(x: np.ndarray, y: np.ndarray, num_clients: int, seed: int = 0):
    """Equal random split — the paper's setting."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    parts = np.array_split(idx, num_clients)
    return [(x[p], y[p]) for p in parts]


def dirichlet_shards(
    x: np.ndarray, y: np.ndarray, num_clients: int, alpha: float = 0.5, seed: int = 0
):
    """Label-skewed split: per-class Dirichlet(alpha) allocation over clients."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    buckets: list[list[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for b, part in zip(buckets, np.split(idx, cuts)):
            b.extend(part.tolist())
    out = []
    for b in buckets:
        b = np.asarray(b if b else [int(rng.integers(0, len(x)))])
        rng.shuffle(b)
        out.append((x[b], y[b]))
    return out


def _stack_dtype(a: np.ndarray):
    """Stacked dtype of a shard: integer features (token ids) stay int32,
    everything else is float32."""
    return np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32


def padded_stack(shards):
    """Ragged client shards -> ``(x (K, n_max, *feat), y (K, n_max, *lab),
    lengths (K,) int32)``; shard k occupies rows ``[0, lengths[k])``, the
    tail is zero."""
    K = len(shards)
    n_max = max(len(x) for x, _ in shards)
    x0 = np.asarray(shards[0][0])
    y0 = np.asarray(shards[0][1])
    x_pad = np.zeros((K, n_max) + x0.shape[1:], _stack_dtype(x0))
    y_pad = np.zeros((K, n_max) + y0.shape[1:], np.int32)
    lengths = np.zeros((K,), np.int32)
    for k, (x, y) in enumerate(shards):
        n = len(x)
        x_pad[k, :n] = x
        y_pad[k, :n] = y
        lengths[k] = n
    return x_pad, y_pad, lengths


def compact_stack(x_pad, y_pad, lengths, keep, pad_to: int | None = None):
    """Inverse of :func:`padded_stack` restricted to the kept client rows.

    Gathers rows ``keep`` (the still-live client ids, ascending) of the
    padded stacks into a ``(len(keep), n_max, ...)`` layout, re-padded to
    ``pad_to`` rows when given.  Pad rows, and ``-1`` entries of ``keep``,
    carry zero shards of length 1: the device batch draw needs a non-empty
    range, and a pad row is blocked, so it is masked out of every aggregate.
    Raises ``ValueError`` when ``pad_to`` is smaller than ``len(keep)``."""
    keep = np.asarray(keep, np.int64)
    if pad_to is not None and pad_to < len(keep):
        raise ValueError(
            f"pad_to={pad_to} is smaller than the {len(keep)} kept client "
            f"rows; refusing to truncate live clients"
        )
    live = keep >= 0

    def _gather(stack):
        row = live.reshape((-1,) + (1,) * (stack.ndim - 1))
        return np.where(row, stack[np.maximum(keep, 0)], 0).astype(stack.dtype)

    x_c = _gather(x_pad)
    y_c = _gather(y_pad)
    len_c = np.where(live, np.asarray(lengths)[np.maximum(keep, 0)], 1).astype(
        np.asarray(lengths).dtype
    )
    if pad_to is not None and pad_to > len(keep):
        extra = pad_to - len(keep)
        x_c = np.concatenate([x_c, np.zeros((extra,) + x_c.shape[1:], x_c.dtype)])
        y_c = np.concatenate([y_c, np.zeros((extra,) + y_c.shape[1:], y_c.dtype)])
        len_c = np.concatenate([len_c, np.ones((extra,), len_c.dtype)])
    return x_c, y_c, len_c


def shard_compact_plan(live_ids, num_shards: int, cap_per_shard: int):
    """Per-shard compaction layout of the client-sharded fused engine.

    Spreads the live client ids contiguously over ``num_shards`` equal
    blocks of ``rows = pow2_bucket(ceil(n_live / num_shards),
    cap_per_shard)`` rows, each block's tail padded with ``-1``.  Returns
    ``(keep (num_shards * rows,) int64 with -1 pads, rows)``: every shard
    holds the same row count, a power of two, so a run sees O(log K) layouts
    a shard."""
    live_ids = np.asarray(live_ids, np.int64)
    n_live = len(live_ids)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    rows = pow2_bucket(-(-max(n_live, 1) // num_shards), cap_per_shard)
    if rows * num_shards < n_live:
        raise ValueError(
            f"{n_live} live clients do not fit {num_shards} shards of "
            f"cap {cap_per_shard} rows"
        )
    keep = np.full((num_shards * rows,), -1, np.int64)
    for s in range(num_shards):
        chunk = live_ids[s * rows : (s + 1) * rows]
        keep[s * rows : s * rows + len(chunk)] = chunk
    return keep, rows


def pow2_bucket(n_live: int, cap: int) -> int:
    """Smallest power of two >= ``n_live``, clamped to ``[1, cap]``: the
    segmented fused engine's client-axis size, so a run captures O(log K)
    round graphs, not one per blocking event."""
    b = 1
    while b < n_live:
        b *= 2
    return max(1, min(b, cap))
