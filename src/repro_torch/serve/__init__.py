"""repro_torch.serve: the streaming aggregation tier.

Counterpart of ``repro/serve``.  Asynchronous FedBuff-style rounds on the
pure ``server_step`` core: clients submit at arbitrary logical times, the
server aggregates when the buffer fills or the deadline expires, blocked ids
are rejected at ingress before any payload work, and stale updates enter
the reputation posterior with weight ``staleness_decay ** tau``.  The
synchronous fused engine is the ``buffer = K, deadline = inf, decay = 1``
case, bit for bit.
"""

from repro_torch.serve.pool import ProposalPool
from repro_torch.serve.replay import ServeResult, run_serve_replay
from repro_torch.serve.service import (
    ACCEPTED,
    DECISIONS,
    REJECTED_BLOCKED,
    REJECTED_DUPLICATE,
    REJECTED_INVALID,
    REJECTED_STALE,
    AggregationService,
    RoundRecord,
    ServeConfig,
    SubmitResult,
)
from repro_torch.serve.traffic import TrafficConfig, TrafficReport, run_traffic

__all__ = [
    "ACCEPTED",
    "DECISIONS",
    "REJECTED_BLOCKED",
    "REJECTED_DUPLICATE",
    "REJECTED_INVALID",
    "REJECTED_STALE",
    "AggregationService",
    "ProposalPool",
    "RoundRecord",
    "ServeConfig",
    "ServeResult",
    "SubmitResult",
    "TrafficConfig",
    "TrafficReport",
    "run_serve_replay",
    "run_traffic",
]
