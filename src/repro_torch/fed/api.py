"""repro_torch.fed.api — the front door of the port's federated experiments.

Counterpart of ``repro/fed/api.py``:

    from repro_torch.fed.api import run

    # the paper's classification experiments (workload=None -> the paper DNN)
    result = run(None, sim, server, data=data)              # on the card
    result = run(None, sim, server, data=data, device="cpu")

    # federated LoRA fine-tuning (any non-classification ClientWorkload)
    out = run(get_workload("lora", arch="smollm-135m"), sim, server, seq=256)

``workload`` is ``None``, a ``ClientWorkload`` or a registry name
(``"dnn"`` / ``"lora"``, built by ``get_workload`` with ``workload_kwargs``).
``None`` / ``DnnWorkload`` go to the classification simulator, on the
engine ``sim.engine`` names (``batched``; ``looped``, one client at a time;
or ``fused`` / ``fused_eager``, the round captured once as a CUDA graph and
replayed, with ``segment_rounds`` and ``compact``), or with ``seeds=`` to
``sweep`` (the fused engine once per seed, one captured round for all);
any other workload to ``simulate_llm`` (the fused engine, whatever
``sim.engine`` says), with extra keyword arguments (``local_steps``,
``samples_per_client``, ``seq``, ``n_test``, ``eager``, ...) passed through.
The LLM route takes no ``seeds``, as in the JAX package.

With ``sim.client_shards = S > 0`` (``engine="fused"``) ``run`` is one rank's
call inside an initialized ``torch.distributed`` group of S ranks, and
raises without one; ``repro_torch.launch.shards.run_sharded`` starts the
ranks and returns rank 0's result.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Union

from repro_torch.fed.server import ServerConfig
from repro_torch.fed.simulator import SimConfig, SimResult, SweepResult, simulate, sweep
from repro_torch.fed.workload import ClientWorkload, DnnWorkload, get_workload, simulate_llm

WorkloadLike = Union[None, str, ClientWorkload]


def _resolve_workload(workload: WorkloadLike, workload_kwargs: dict | None):
    if isinstance(workload, str):
        return get_workload(workload, **(workload_kwargs or {}))
    if workload_kwargs:
        raise ValueError("workload_kwargs only applies when `workload` is a registry name")
    return workload


def run(
    workload: WorkloadLike,
    sim: SimConfig,
    server: Optional[ServerConfig] = None,
    *,
    data: Any = None,
    seeds: Optional[Iterable[int]] = None,
    eval_every: int = 1,
    workload_kwargs: Optional[dict] = None,
    device="cuda",
    **extra,
) -> Union[SimResult, SweepResult, dict]:
    """Run a federated experiment on ``device``.

    ``device="cuda"`` (the default) raises when CUDA is missing; pass
    ``device="cpu"`` to run on the CPU.  On the LLM route the ``SimConfig``
    maps as in the JAX package (``num_clients`` -> clients, byzantine =
    round(``bad_frac`` K), ``local_epochs`` -> local steps, ``batch_size`` ->
    batch, ``rounds``, ``seed``, ``lr``, ``scenario``); the server's ``rule``,
    ``afa_variant`` and ``kernel_plan`` pick the aggregation route.  Returns a
    ``SimResult``, a ``SweepResult`` (``seeds``) or the LLM route's result
    dict."""
    workload = _resolve_workload(workload, workload_kwargs)
    if server is None:
        server = ServerConfig(num_clients=sim.num_clients)

    if workload is None or isinstance(workload, DnnWorkload):
        if extra:
            raise TypeError(
                f"unexpected keyword arguments for the classification route: {sorted(extra)}"
            )
        if data is None:
            raise ValueError(
                "the classification route needs `data` (a SyntheticClassification); "
                "build one with repro_torch.data"
            )
        if seeds is not None:
            return sweep(data, sim, server, seeds, workload=workload, device=device)
        return simulate(data, sim, server, eval_every=eval_every, workload=workload,
                        device=device)

    if seeds is not None:
        raise ValueError("seed sweeps are not wired for the LLM route; loop over sim.seed "
                         "instead")
    llm_kwargs = dict(
        clients=sim.num_clients,
        byzantine=int(round(sim.bad_frac * sim.num_clients)),
        rounds=sim.rounds,
        local_steps=sim.local_epochs,
        batch=sim.batch_size,
        seed=sim.seed,
        lr=sim.lr,
        scenario=sim.scenario,
        rule=server.rule,
        afa_variant=server.afa_variant,
        kernel_plan=server.kernel_plan,
        data=data,
        device=device,
    )
    llm_kwargs.update(extra)  # samples_per_client / seq / n_test / overrides
    return simulate_llm(workload, **llm_kwargs)
