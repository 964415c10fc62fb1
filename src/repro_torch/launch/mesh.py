"""The client mesh: the ranks of a ``torch.distributed`` group over which the
client-sharded fused engine splits its clients.

Counterpart of ``make_client_mesh`` and ``client_axis`` in
``repro/launch/mesh.py``.  The JAX package runs one controller over a
``(client,)`` device mesh and ``shard_map``; the port runs one process a
shard.  Each of the S ranks holds K / S client rows (their shards, server
state and proposals), the model parameters are replicated, and the ranks
meet only in ``all_reduce(SUM)``:

* ``ClientMesh.psum(t)``: the sum of ``t`` over the ranks;
* ``ClientMesh.gather_rows(local, total)``: the ``(total, ...)`` stack of
  every rank's row block, as the sum of blocks that are zero outside their
  rank's rows.  That is exact (x + 0 = x), so every rank receives the same
  bits, whatever order the backend adds in.

The group is the caller's: ``make_client_mesh`` reads the initialized
default group and never picks a backend or a device on its own.  Under
NCCL rank r works on ``cuda:r``; under gloo every rank works on the device
it is given, so S gloo ranks can share one card (the collectives then pass
through the host).  ``repro_torch.launch.shards`` starts such groups.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ALL_REDUCE_RANGE = "client_mesh.all_reduce"   # profiler range around each collective


class ClientMesh:
    """The ranks of the default process group as the client axis.

    ``all_reduces`` counts the collectives this rank has issued through the
    mesh, so a caller can check how many a step takes."""

    def __init__(self, group, rank: int, num_shards: int, device: torch.device, backend: str):
        self.group = group
        self.rank = rank
        self.num_shards = num_shards
        self.device = device
        self.backend = backend
        self.all_reduces = 0

    def __repr__(self) -> str:
        return (f"ClientMesh(rank={self.rank}, num_shards={self.num_shards}, "
                f"device={self.device}, backend={self.backend!r})")

    def _all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        self.all_reduces += 1
        with torch.profiler.record_function(ALL_REDUCE_RANGE):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor; ``t`` is kept)."""
        return self._all_reduce_(t.clone())

    def row_block(self, rows: int) -> slice:
        """This rank's rows of a client axis of ``rows * num_shards`` rows."""
        return slice(self.rank * rows, (self.rank + 1) * rows)

    def gather_rows(self, local: torch.Tensor, total: int) -> torch.Tensor:
        """``(total, ...)``: every rank's ``(total / num_shards, ...)`` block
        ``local`` in rank order, on every rank."""
        rows = local.shape[0]
        if rows * self.num_shards != total:
            raise ValueError(f"gather_rows: {rows} rows a rank x {self.num_shards} ranks "
                             f"!= {total}")
        full = torch.zeros((total,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[self.row_block(rows)] = local
        return self._all_reduce_(full)


def make_client_mesh(num_shards: int, device) -> ClientMesh:
    """The client mesh of the initialized default process group, whose
    world size must be ``num_shards``.  The mesh runs on the group's own
    backend: under NCCL rank r takes ``cuda:r`` (``device`` must be CUDA);
    under gloo every rank takes ``device``, so S gloo ranks can share one
    card."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a client mesh of {num_shards} shards needs an initialized default process "
            "group of that size (repro_torch.launch.shards.spawn starts one)")
    device = torch.device(device)
    world = dist.get_world_size()
    if world != num_shards:
        raise ValueError(f"client mesh wants {num_shards} shards but the process group has "
                         f"{world} ranks")
    backend = dist.get_backend()
    rank = dist.get_rank()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
        device = torch.device("cuda", rank)
    return ClientMesh(dist.group.WORLD, rank, num_shards, device, backend)

