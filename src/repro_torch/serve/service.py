"""The asynchronous aggregation service: FedBuff-style buffered rounds on the
pure ``server_step`` core, with the paper's blocking as admission control.

Counterpart of ``repro/serve/service.py``.  Clients submit packed proposal
rows at arbitrary logical times; the server aggregates when the round's
buffer fills or its deadline passes.

* **Ingress blocking.**  A blocked client id is rejected before its payload
  is validated or staged: blocking costs the server an id lookup.
* **Staleness-aware reputation.**  An update trained against the parameters
  of round ``t - tau`` enters the Beta posterior with weight
  ``staleness_decay ** tau`` (``fed.server.server_step_versioned``).
* **Sync bit-identity.**  With ``buffer_size = K``, ``deadline = inf`` and
  no decay, one submission per live client per round replays the fused
  engine's trajectory bit for bit (``repro_torch.serve.replay``).

Time is an input (``now`` arguments, logical units): the service reads no
clock, so a driver's schedule replays exactly.  Host state is O(K) but for
the ``(K, D)`` staging buffer, pinned on the card, from which a fired round
makes one copy into a preallocated device buffer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.fed.engine import FusedData
from repro_torch.fed.server import (
    ServerConfig,
    init_server_state,
    make_rule_options,
    server_step_versioned,
)
from repro_torch.utils.trees import pack_stack, tree_map, unpack_stack

# ingress decisions, in the order the checks run (cheapest first: the two
# id-only checks never touch the payload)
ACCEPTED = "accepted"
REJECTED_BLOCKED = "rejected_blocked"      # the paper's blocking, as admission
REJECTED_DUPLICATE = "rejected_duplicate"  # id already in the open round
REJECTED_STALE = "rejected_stale"          # tau > max_staleness
REJECTED_INVALID = "rejected_invalid"      # codec validation failed
DECISIONS = (
    ACCEPTED, REJECTED_BLOCKED, REJECTED_DUPLICATE, REJECTED_STALE, REJECTED_INVALID,
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Buffer, deadline and staleness policy of the asynchronous tier.

    ``buffer_size = 0`` means the full client count (the synchronous case);
    a round closes at ``min(buffer_size, live clients)`` accepted rows, so a
    shrinking cohort never deadlocks the buffer.  ``deadline`` is in the
    driver's logical time units, ``inf`` for none.  ``max_staleness = None``
    admits any staleness (the decay still weighs it); an integer drops
    submissions with ``tau > max_staleness`` at ingress, reputation
    untouched."""

    buffer_size: int = 0
    deadline: float = math.inf
    max_staleness: Optional[int] = None
    staleness_decay: float = 1.0

    def __post_init__(self):
        if self.buffer_size < 0:
            raise ValueError(f"buffer_size={self.buffer_size} < 0")
        if not self.deadline > 0:
            raise ValueError(f"deadline={self.deadline} must be positive")
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError(f"max_staleness={self.max_staleness} < 0")
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError(f"staleness_decay={self.staleness_decay} outside (0, 1]")


@dataclasses.dataclass
class RoundRecord:
    """Host-side log entry of one fired aggregation round."""

    index: int             # server round counter when the round fired
    opened_at: float       # logical time the round opened
    fired_at: float        # logical time it aggregated
    trigger: str           # "buffer" | "deadline" | "flush"
    n_accepted: int        # buffered submissions aggregated
    all_blocked: bool      # empty participation: the params were kept
    test_error: float      # workload eval after the round (fraction)
    good_mask: np.ndarray  # (K,) the rule's kept set
    n_blocked: int         # blocked clients after the round

    @property
    def latency(self) -> float:
        return self.fired_at - self.opened_at


class SubmitResult(NamedTuple):
    decision: str
    fired: Optional[RoundRecord]  # set when this submission closed the round


@functools.lru_cache(maxsize=32)
def _make_agg_step(workload, rule, opts, delta_block, staleness_decay):
    """The aggregation of one round: the tail of the fused round body
    (``fed.engine._round_body``) on the staged buffer, so the synchronous
    replay reproduces the fused trajectory bit for bit.  Rows not accepted
    hold the packed current proposal point w_t, as the fused body's masked
    rows do; with no live row the aggregate keeps w_t (a ``torch.where``)."""

    def step(params, state, rows, n_k, mask0, versions, x_test, y_test):
        pspec = workload.delta_spec(params)
        w_prev = workload.codec.proposal_of(params)
        w_row = pack_stack(tree_map(lambda l: l[None], w_prev), pspec)[0]
        buffer = torch.where(mask0[:, None], rows, w_row[None, :])
        state, res = server_step_versioned(
            state, buffer, n_k, mask0, versions, rule=rule, opts=opts,
            delta_block=delta_block, layout="matrix", staleness_decay=staleness_decay,
        )
        aggregate = tree_map(lambda prev, new: torch.where(res.all_blocked, prev, new),
                             w_prev, unpack_stack(res.aggregate, pspec))
        params = workload.codec.apply(params, aggregate)
        err = workload.eval_metric(params, x_test, y_test)
        return params, state, res.good_mask, res.all_blocked, err

    return step


class AggregationService:
    """The stateful asynchronous server: ingress admission and buffered
    aggregation.

    Drive it with :meth:`submit` (one packed proposal row a call) and
    :meth:`poll` (advance logical time, so that deadline rounds fire).  The
    aggregation is one cached step (:func:`_make_agg_step`) on
    ``server_step_versioned``, on the device of ``data``; the host holds the
    ``(K, D)`` staging buffer and O(K) bookkeeping."""

    def __init__(self, workload, server_cfg: ServerConfig, serve_cfg: ServeConfig, params0,
                 data: FusedData):
        K = server_cfg.num_clients
        dev = data.n_k.device
        self.workload = workload
        self.server_cfg = server_cfg
        self.cfg = serve_cfg
        self.device = dev
        self._data = data
        self._pspec = workload.delta_spec(params0)
        self._params = params0
        self._state = init_server_state(K, server_cfg.alpha0, server_cfg.beta0, device=dev)
        self._step = _make_agg_step(
            workload, server_cfg.rule, make_rule_options(server_cfg, K),
            float(server_cfg.delta_block), float(serve_cfg.staleness_decay),
        )
        # staging: a pinned host buffer on the card, copied into a device
        # buffer when a round fires; on the CPU the host buffer is the operand
        cuda = dev.type == "cuda"
        shape = (K, self._pspec.dim)
        self._rows_host = torch.zeros(shape, dtype=self._pspec.dtype, pin_memory=cuda)
        self._rows_dev = (torch.empty(shape, dtype=self._pspec.dtype, device=dev) if cuda
                          else self._rows_host)
        self._rows = self._rows_host.numpy()
        self._mask = np.zeros(K, bool)
        self._versions = np.zeros(K, np.int32)
        self._blocked = np.zeros(K, bool)
        self._round = 0
        self._opened_at = 0.0
        self.rounds: list[RoundRecord] = []
        self.decisions: dict[str, int] = {d: 0 for d in DECISIONS}
        # (time, client, decision) ingress log: drivers and tests replay it
        self.log: list[tuple[float, int, str]] = []

    # -- views ---------------------------------------------------------------
    @property
    def num_clients(self) -> int:
        return self.server_cfg.num_clients

    @property
    def round(self) -> int:
        """Server round counter: the version stamp of the current params."""
        return self._round

    @property
    def params(self):
        return self._params

    @property
    def state(self):
        return self._state

    @property
    def blocked(self) -> np.ndarray:
        return self._blocked

    @property
    def accepted_count(self) -> int:
        return int(self._mask.sum())

    def _fill_target(self) -> int:
        """Accepted rows that close the round: min(buffer_size, live
        clients); blocking shrinks it, so a decimated cohort still rounds."""
        live = self.num_clients - int(self._blocked.sum())
        size = self.cfg.buffer_size or self.num_clients
        return max(min(size, live), 1)

    # -- ingress -------------------------------------------------------------
    def submit(self, client_id: int, payload, version: int, now: float) -> SubmitResult:
        """Admit or reject one client submission at logical time ``now``.

        The checks run cheapest first, and the first two never touch the
        payload: **blocked** (the paper's blocking as admission control),
        **duplicate** (the id is already in the open round), **stale**
        (``tau = round - version`` exceeds ``max_staleness``; a stamp from
        the future is invalid), **invalid** (the workload's
        ``validate_submission`` refuses the row).  An accepted row is staged;
        if it fills the round's target the round aggregates at once, and the
        result carries the fired :class:`RoundRecord`."""
        fired = None
        cid = int(client_id)
        if not 0 <= cid < self.num_clients:
            raise ValueError(f"client id {cid} outside 0..{self.num_clients - 1}")
        if self._blocked[cid]:
            decision = REJECTED_BLOCKED
        elif self._mask[cid]:
            decision = REJECTED_DUPLICATE
        else:
            version = int(version)
            tau = self._round - version
            if tau < 0:
                decision = REJECTED_INVALID  # from the future: a corrupt stamp
            elif self.cfg.max_staleness is not None and tau > self.cfg.max_staleness:
                decision = REJECTED_STALE
            else:
                try:
                    row = self.workload.validate_submission(self._params, payload)
                except ValueError:
                    decision = REJECTED_INVALID
                else:
                    self._rows[cid] = row
                    self._versions[cid] = version
                    self._mask[cid] = True
                    decision = ACCEPTED
                    if self.accepted_count >= self._fill_target():
                        fired = self._fire("buffer", float(now))
        self.decisions[decision] += 1
        self.log.append((float(now), cid, decision))
        return SubmitResult(decision, fired)

    # -- round firing --------------------------------------------------------
    def poll(self, now: float) -> list[RoundRecord]:
        """Advance logical time: fire every deadline round due by ``now``,
        empty ones too (no arrival keeps the params through the all-blocked
        guard)."""
        fired = []
        while math.isfinite(self.cfg.deadline) and now - self._opened_at >= self.cfg.deadline:
            fired.append(self._fire("deadline", self._opened_at + self.cfg.deadline))
        return fired

    def flush(self, now: float) -> RoundRecord:
        """Aggregate the open round with whatever it holds."""
        return self._fire("flush", float(now))

    def _fire(self, trigger: str, at: float) -> RoundRecord:
        dev = self.device
        if self._rows_dev is not self._rows_host:
            # the step's host reads below finish the copy before any later
            # submission overwrites the pinned rows
            self._rows_dev.copy_(self._rows_host, non_blocking=True)
        params, state, good_mask, all_blocked, err = self._step(
            self._params, self._state, self._rows_dev, self._data.n_k,
            torch.from_numpy(self._mask.copy()).to(dev),
            torch.from_numpy(self._versions.copy()).to(dev),
            self._data.x_test, self._data.y_test,
        )
        self._params, self._state = params, state
        self._blocked = state.reputation.blocked.cpu().numpy().copy()
        record = RoundRecord(
            index=self._round,
            opened_at=self._opened_at,
            fired_at=at,
            trigger=trigger,
            n_accepted=self.accepted_count,
            all_blocked=bool(all_blocked),
            test_error=float(err),
            good_mask=good_mask.cpu().numpy().copy(),
            n_blocked=int(self._blocked.sum()),
        )
        self.rounds.append(record)
        self._round += 1
        self._mask[:] = False
        self._opened_at = at
        return record

    # -- summaries -----------------------------------------------------------
    @property
    def rounds_blocked(self) -> np.ndarray:
        return self._state.rounds_blocked.cpu().numpy().copy()

    def reject_fraction(self, client_ids, *, after: float = -math.inf) -> float:
        """Fraction of the given clients' submissions from time ``after`` on
        that ingress rejected as blocked."""
        ids = set(int(c) for c in np.atleast_1d(np.asarray(client_ids)))
        total = hits = 0
        for t, cid, decision in self.log:
            if cid in ids and t >= after:
                total += 1
                hits += decision == REJECTED_BLOCKED
        return hits / total if total else float("nan")
