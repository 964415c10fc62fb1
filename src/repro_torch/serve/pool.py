"""Client-side cohort trainer for the serve tier.

Counterpart of ``repro/serve/pool.py``.  In a deployment clients compute
their own updates; in the simulation the pool plays every client.  For each
params version it runs the fused engine's proposal phase once for the whole
cohort (``fed.engine.make_packed_propose_fn``: participation masks, the
keyed minibatch draw, local training and the update-level attacks, with the
streams keyed by round and original client id), copies the ``(K, D)`` buffer
to the host and serves single rows from a small per-version cache.

A client that fetches the model at version ``v`` therefore receives the row
the synchronous engine would aggregate at round ``v``: this makes the
buffer = K replay bit-identical, and a straggler's row stays the version-``v``
computation, never retrained against newer params.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.fed.engine import make_packed_propose_fn


class ProposalPool:
    """Per-version packed proposal buffers, computed on demand and kept in an
    LRU of host buffers.

    ``rows(version, params, blocked)`` must be called with the params and
    blocked set current at that version (the traffic driver fetches when it
    schedules a submission, so this holds by construction); within one
    version both are constant, so the cache keys on the version alone."""

    def __init__(self, inputs, seed: int, *, cache_size: int = 4):
        # ``inputs`` is a repro_torch.fed.simulator.FusedInputs
        self._inputs = inputs
        K = int(inputs.data.n_k.shape[0])
        dev = inputs.data.n_k.device
        self.num_clients = K
        self.device = dev
        self._propose = make_packed_propose_fn(
            inputs.workload, inputs.engine_cfg, K, inputs.batch_s, inputs.batch_b,
        )
        self._seed = torch.full((), int(seed), dtype=torch.int64, device=dev)
        self._bad = torch.from_numpy(np.asarray(inputs.bad_mask, bool)).to(dev)
        self._ids = torch.arange(K, dtype=torch.int64, device=dev)
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_size = int(cache_size)

    @property
    def bad_mask(self) -> np.ndarray:
        return np.asarray(self._inputs.bad_mask)

    def rows(self, version: int, params, blocked) -> np.ndarray:
        """The full ``(K, D)`` packed proposal buffer at ``version``."""
        version = int(version)
        if version not in self._cache:
            buf = self._propose(
                params, torch.from_numpy(np.asarray(blocked, bool).copy()).to(self.device),
                torch.full((), version, dtype=torch.int64, device=self.device),
                self._seed, self._inputs.data, self._bad, self._ids,
            )
            self._cache[version] = buf.cpu().numpy()
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(version)
        return self._cache[version]

    def row(self, client_id: int, version: int, params, blocked) -> np.ndarray:
        """One client's packed proposal row at ``version`` (a copy: the caller
        may hold it across rounds, as a straggler does)."""
        return self.rows(version, params, blocked)[int(client_id)].copy()
