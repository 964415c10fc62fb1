"""Synchronous replay of a classification experiment through the serve tier.

Counterpart of ``repro/serve/replay.py``.  ``run_serve_replay`` drives the
:class:`~repro_torch.serve.service.AggregationService` in lockstep: every
live client fetches and submits once a round, in id order.  With the default
``ServeConfig`` (buffer = K, deadline = inf, no staleness decay) this
reproduces the fused engine's trajectory bit for bit: the rows come from the
fused proposal phase (:class:`~repro_torch.serve.pool.ProposalPool`) and the
aggregation step is the fused round body's tail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import SyntheticClassification
from repro_torch.fed.server import ServerConfig
from repro_torch.fed.simulator import SimConfig, detection_stats, fused_inputs
from repro_torch.serve.pool import ProposalPool
from repro_torch.serve.service import AggregationService, ServeConfig


@dataclasses.dataclass
class ServeResult:
    """The serve tier's counterpart of ``SimResult`` (the same conventions:
    errors in percent, blocked rounds 1-indexed)."""

    test_error: list
    blocked_round: np.ndarray
    bad_clients: np.ndarray
    good_mask_history: list
    detection_rate: float
    mean_rounds_to_block: float
    rounds: list                # the service's RoundRecords
    decisions: dict             # ingress decision -> count


def run_serve_replay(
    data: SyntheticClassification,
    sim: SimConfig,
    server_cfg: ServerConfig | None = None,
    serve_cfg: ServeConfig | None = None,
    *,
    eval_every: int = 1,
    workload=None,
    device="cuda",
) -> ServeResult:
    """Run ``sim.rounds`` rounds of the experiment through the serve path on
    ``device`` (the card unless ``device="cpu"``; raises without CUDA).

    One submission per live client a round, in ascending id, each stamped
    with the params version it trained against.  When every client is
    blocked the round is flushed empty, and the all-blocked guard keeps the
    params, as the fused engine does.  With another ``serve_cfg`` (a smaller
    buffer, a finite deadline, staleness decay) the same driver runs buffered
    rounds: a round can fire mid-loop and the remaining submissions land in
    the next, one round stale."""
    if server_cfg is None:
        server_cfg = ServerConfig(num_clients=sim.num_clients)
    if serve_cfg is None:
        serve_cfg = ServeConfig()
    inputs = fused_inputs(data, sim, workload=workload, device=device)
    service = AggregationService(inputs.workload, server_cfg, serve_cfg, inputs.params0,
                                 inputs.data)
    pool = ProposalPool(inputs, sim.seed)

    for rnd in range(sim.rounds):
        t = float(rnd)
        blocked = service.blocked.copy()
        version = service.round
        rows = None
        fired = False
        for k in range(sim.num_clients):
            if blocked[k]:
                continue
            if rows is None:  # one cohort computation per version
                rows = pool.rows(version, service.params, blocked)
            out = service.submit(k, rows[k], version, now=t)
            fired = fired or out.fired is not None
        if not fired:
            # every client blocked, or a partial buffer open at the round's
            # end: aggregate what there is
            service.flush(now=t)

    errs = [r.test_error * 100.0 for r in service.rounds]
    test_error = [errs[r] for r in range(len(errs))
                  if r % eval_every == 0 or r == len(errs) - 1]
    bad = np.flatnonzero(inputs.bad_mask)
    rate, mean_rounds = detection_stats(service.rounds_blocked, bad)
    return ServeResult(
        test_error=test_error,
        blocked_round=service.rounds_blocked,
        bad_clients=bad,
        good_mask_history=[r.good_mask for r in service.rounds],
        detection_rate=rate,
        mean_rounds_to_block=mean_rounds,
        rounds=list(service.rounds),
        decisions=dict(service.decisions),
    )
