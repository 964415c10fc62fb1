"""Start the ranks of a client mesh: one process a client shard.

The JAX package runs its client-sharded engine from one controller
(``shard_map`` over a ``(client,)`` mesh); the port runs one process a
shard, so it needs a launcher, and this module is it:

* ``spawn(fn, num_shards, *, backend, device, args)`` starts
  ``num_shards`` processes with ``torch.multiprocessing`` (the ``spawn``
  start method), joins them into a default process group through a
  ``file://`` store in a temporary directory (so two launches on one host
  never race for a TCP port), calls ``fn(*args)`` on every rank and returns
  rank 0's value.  A rank that raises makes the call raise, and the other
  ranks are stopped.  Under ``backend="nccl"`` rank r first selects
  ``cuda:r``.  ``fn`` must be importable by name (a module-level function)
  and rank 0's value picklable;
* ``run_sharded(workload, sim, server, *, data, device, backend)``: the
  one-call counterpart of the JAX package's ``run(..., SimConfig(
  client_shards=S))``: ``sim.client_shards`` ranks, each calling
  ``repro_torch.fed.api.run``, and rank 0's ``SimResult``.

The backend defaults to ``"nccl"`` on ``cuda`` and ``"gloo"`` on the CPU;
S ranks sharing one card need ``backend="gloo"``, passed by the caller.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def _rank_main(rank: int, fn, num_shards: int, backend: str, init_method: str,
               args_path: str, out: str) -> None:
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    # the ranks share the host's cores (one rank keeps torch's default)
    torch.set_num_threads(max(1, torch.get_num_threads() // num_shards))
    dist.init_process_group(backend, init_method=init_method, world_size=num_shards,
                            rank=rank)
    try:
        value = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(value, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, num_shards: int, *, backend: str, device, args: tuple = ()):
    """Run ``fn(*args)`` on ``num_shards`` ranks of a new process group on
    ``device`` and return rank 0's value (see the module docstring)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve_device(device)
    if backend == "nccl" and (dev.type != "cuda" or num_shards > torch.cuda.device_count()):
        raise ValueError(f"nccl runs one rank a card: {num_shards} ranks on {dev} with "
                         f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} cards")
    with tempfile.TemporaryDirectory(prefix="repro_torch_shards_") as tmp:
        # the arguments go through a file: a process's own arguments pass
        # through a pipe that its child reads only while it imports, so
        # large ones would start the ranks one after the other
        args_path, out = os.path.join(tmp, "args.pkl"), os.path.join(tmp, "rank0.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, num_shards, backend, f"file://{os.path.join(tmp, 'store')}",
                              args_path, out),
            nprocs=num_shards, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


def _run_rank(workload, sim, server, data, device, eval_every):
    from repro_torch.fed.api import run

    return run(workload, sim, server, data=data, eval_every=eval_every, device=device)


def run_sharded(workload, sim, server=None, *, data, device="cuda", backend: str | None = None,
                eval_every: int = 1):
    """``repro_torch.fed.api.run(workload, sim, server, data=data,
    device=device)`` on ``sim.client_shards`` ranks; returns rank 0's
    ``SimResult``."""
    if sim.client_shards < 1:
        raise ValueError(f"run_sharded needs SimConfig.client_shards >= 1, got "
                         f"{sim.client_shards}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    return spawn(_run_rank, sim.client_shards, backend=backend, device=device,
                 args=(workload, sim, server, data, str(device), eval_every))
