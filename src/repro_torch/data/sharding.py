"""Client shard construction: IID (the paper's equal split) and Dirichlet
non-IID.  A numpy copy of the shard builders of ``repro/data/sharding.py``;
the same seed gives the same shards."""

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
