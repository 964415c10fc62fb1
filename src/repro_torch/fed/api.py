"""repro_torch.fed.api — the front door of the port's federated experiments.

Counterpart of ``repro/fed/api.py``, classification route only:

    from repro_torch.fed.api import run
    result = run(None, sim, server, data=data)              # on the card
    result = run(None, sim, server, data=data, device="cpu")

``workload`` is ``None`` (the paper DNN sized from ``sim.hidden`` and the
dataset) or a ``DnnWorkload``.  Seed sweeps and the LLM/LoRA route are not
ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from repro_torch.fed.server import ServerConfig
from repro_torch.fed.simulator import SimConfig, SimResult, simulate
from repro_torch.fed.workload import DnnWorkload


def run(
    workload,
    sim: SimConfig,
    server: Optional[ServerConfig] = None,
    *,
    data: Any = None,
    seeds: Optional[Iterable[int]] = None,
    eval_every: int = 1,
    device="cuda",
) -> SimResult:
    """Run a federated classification simulation on ``device``.

    ``device="cuda"`` (the default) raises when CUDA is missing; pass
    ``device="cpu"`` to run on the CPU."""
    if seeds is not None:
        raise NotImplementedError(
            "seed sweeps need the fused engine, which is not ported to "
            "repro_torch yet (ROADMAP queue A); loop over sim.seed instead"
        )
    if workload is not None and not isinstance(workload, DnnWorkload):
        raise NotImplementedError(
            f"workload {workload!r}: only the paper DNN (None or DnnWorkload) "
            "is ported to repro_torch so far (ROADMAP queue A: the LLM path)"
        )
    if data is None:
        raise ValueError(
            "the classification route needs `data` (a SyntheticClassification); "
            "build one with repro_torch.data"
        )
    if server is None:
        server = ServerConfig(num_clients=sim.num_clients)
    return simulate(data, sim, server, eval_every=eval_every, workload=workload,
                    device=device)
