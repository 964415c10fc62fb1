"""Deterministic async traffic generator for the serve tier.

Counterpart of ``repro/serve/traffic.py``, host numpy, copied so that the
event sequence is the reference's.  A logical-clock discrete-event
simulation: every client runs a fetch -> train -> submit loop with
exponential think/train gaps drawn from its OWN seeded substream
(``np.random.default_rng([seed, client_id])``), so the event sequence —
arrival order, straggler delays, burst waves, blocked clients hammering the
ingress — is a pure function of the traffic config.
NO wall clock anywhere in the logic; a caller that wants wall time measures
it from outside.

Ties in the event heap break on insertion order (a monotone sequence
number), so replays are exact even when two events share a timestamp.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.serve.service import REJECTED_BLOCKED, AggregationService


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Arrival-process knobs (all times in logical units)."""

    seed: int = 0
    mean_gap: float = 1.0          # exponential think time between rounds
    mean_train: float = 0.5        # exponential local-training latency
    straggler_frac: float = 0.0    # fraction of clients training slower ...
    straggler_slowdown: float = 8.0  # ... by this factor
    burst_every: float = 0.0       # > 0: wake every idle client at n*this
    blocked_retry_gap: float = 2.0  # blocked clients re-hammer at this cadence
    resubmit_blocked: bool = True  # blocked clients resubmit their last row
    max_events: int = 200_000      # hard stop against runaway schedules

    def __post_init__(self):
        if self.mean_gap <= 0 or self.mean_train <= 0:
            raise ValueError("mean_gap and mean_train must be positive")


@dataclasses.dataclass
class TrafficReport:
    """What a traffic run produced, for tests and the benchmark."""

    rounds: list            # RoundRecords fired during the run
    n_events: int           # events processed
    end_time: float         # logical time of the last event
    decisions: dict         # ingress decision -> count (service totals)
    byz_submissions_after_block: int  # byzantine submits once blocked ...
    byz_rejected_at_ingress: int      # ... of which ingress turned away

    @property
    def byz_reject_fraction(self) -> float:
        if self.byz_submissions_after_block == 0:
            return float("nan")
        return self.byz_rejected_at_ingress / self.byz_submissions_after_block


def run_traffic(
    service: AggregationService,
    pool,
    cfg: TrafficConfig,
    *,
    target_rounds: int,
    bad_mask: Optional[np.ndarray] = None,
) -> TrafficReport:
    """Drive ``service`` with Poisson-ish async traffic until it has fired
    ``target_rounds`` rounds (or the event budget runs out).

    Each client cycles fetch -> (train latency) -> submit -> (think gap) ->
    fetch.  A blocked client keeps reconnecting: it resubmits its LAST
    computed row every ``blocked_retry_gap`` — the adversarial reconnect the
    ingress check exists for.  Stragglers train ``straggler_slowdown`` times
    slower, so their submissions arrive stale; bursts wake every idle live
    client at once, overfilling the buffer window.
    """
    K = service.num_clients
    bad = (
        np.asarray(bad_mask, bool)
        if bad_mask is not None
        else getattr(pool, "bad_mask", np.zeros(K, bool))
    )
    rngs = [np.random.default_rng([cfg.seed, k]) for k in range(K)]
    straggler = (
        np.random.default_rng([cfg.seed, K]).random(K) < cfg.straggler_frac
    )

    heap: list = []
    seq = 0  # tie-break: heap order == insertion order at equal times

    def push(t: float, kind: str, k: int, payload=None, version: int = -1):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, k, payload, version))
        seq += 1

    def gap(k: int) -> float:
        return rngs[k].exponential(cfg.mean_gap)

    def train_time(k: int) -> float:
        t = rngs[k].exponential(cfg.mean_train)
        return t * cfg.straggler_slowdown if straggler[k] else t

    for k in range(K):
        push(gap(k), "fetch", k)
    if cfg.burst_every > 0:
        push(cfg.burst_every, "burst", -1)

    idle = np.ones(K, bool)        # no pending fetch->submit in flight
    last_row = [None] * K          # most recent computed (payload, version)
    blocked_at: dict[int, float] = {}
    rounds_before = len(service.rounds)
    byz_after = byz_rejected = 0
    n_events = 0
    now = 0.0

    def note_blocked(t: float):
        for k in np.flatnonzero(service.blocked):
            blocked_at.setdefault(int(k), t)

    while heap and n_events < cfg.max_events:
        if len(service.rounds) - rounds_before >= target_rounds:
            break
        t, _, kind, k, payload, version = heapq.heappop(heap)
        now = max(now, t)
        n_events += 1
        if service.poll(t):
            note_blocked(t)

        if kind == "burst":
            for j in range(K):
                if idle[j] and not service.blocked[j]:
                    idle[j] = False
                    push(t, "fetch", j)
            push(t + cfg.burst_every, "burst", -1)
        elif kind == "fetch":
            idle[k] = False
            if service.blocked[k]:
                # reconnecting blocked client: replay its last row into the
                # ingress (no fresh training — the server won't serve params)
                if cfg.resubmit_blocked and last_row[k] is not None:
                    row, ver = last_row[k]
                    push(t + cfg.blocked_retry_gap, "submit", k, row, ver)
                else:
                    idle[k] = True
            else:
                ver = service.round
                row = pool.row(k, ver, service.params, service.blocked)
                push(t + train_time(k), "submit", k, row, ver)
        elif kind == "submit":
            was_blocked = bool(service.blocked[k])
            out = service.submit(k, payload, version, now=t)
            if out.fired is not None:
                note_blocked(t)
            if bad[k] and was_blocked:
                byz_after += 1
                byz_rejected += out.decision == REJECTED_BLOCKED
            if out.decision != REJECTED_BLOCKED:
                last_row[k] = (payload, version)
            idle[k] = True
            push(t + gap(k), "fetch", k)

    return TrafficReport(
        rounds=service.rounds[rounds_before:],
        n_events=n_events,
        end_time=now,
        decisions=dict(service.decisions),
        byz_submissions_after_block=byz_after,
        byz_rejected_at_ingress=byz_rejected,
    )
