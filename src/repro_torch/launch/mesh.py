"""Meshes of ``torch.distributed`` ranks: the client mesh of the
client-sharded fused engine, and the grid of whole-model training and
serving (data x model, with a client axis before them or without).

Counterpart of ``repro/launch/mesh.py``.  The JAX package runs one
controller over a device mesh; the port runs one process a device, and the
ranks meet only in ``all_reduce``.

The client mesh (``make_client_mesh``, ``ClientMesh``).  Each of the S
ranks holds K / S client rows (their shards, server state and proposals),
the model parameters are replicated, and the ranks meet in
``all_reduce(SUM)``:

* ``ClientMesh.psum(t)``: the sum of ``t`` over the ranks;
* ``ClientMesh.gather_rows(local, total)``: the ``(total, ...)`` stack of
  every rank's row block, as the sum of blocks that are zero outside their
  rank's rows.  That is exact (x + 0 = x), so every rank receives the same
  bits, whatever order the backend adds in.

The grid (``MeshShape``, ``GridMesh``).  ``make_production_mesh`` and
``make_test_mesh`` give the reference's axis names and sizes as a
``MeshShape``: a shape only, like ``jax.sharding.Mesh.shape``, so specs
(``launch.sharding``) are computed with no process group.  ``client_axis``,
``data_axes``, ``client_row_axes`` and ``num_client_rows`` read any mesh
with ``axis_names`` and ``shape``, as the reference's do.  ``make_grid_mesh``
lays a shape over the initialized default group
(``torch.distributed.device_mesh.init_device_mesh``, rank = the row-major
index of its coordinate) and gives each axis's process group and this
rank's coordinate, and the groups of the several axes the rounds reduce
over (the data axes, and the data axes with ``model``), each group's rank
checked to be the rank's coordinate over its axes.  On a ``(client, data,
model)`` grid the client axis is a group of its own: the rounds sum and
gather over it (the client rows), the model's collectives never touch it.
Its collectives are ``all_reduce`` over the group of some axes: ``psum``, ``pmax`` (``ReduceOp.MAX``, exact) and
``gather_rows`` / ``gather_last`` (sums of zero-padded blocks, so every rank
gets the same bits).  A floating tensor travels as float32: a bf16 partial
product is summed in float32 and rounded once, and a gather is exact in any
dtype.  The model's tensor parallelism differentiates through four
``torch.autograd.Function``s over an axis (``copy_to``: identity forward,
all-reduce backward, entering a column-parallel product; ``reduce_from``:
all-reduce forward, identity backward, leaving a row-parallel product;
``gather_from``: a gather of feature blocks whose backward takes this
rank's block; ``max_over``: an exact max, not differentiated), each with a
``vmap`` staticmethod: the collective is elementwise in the batch, so under
``torch.func.vmap`` it acts on the batched tensor whole.

FSDP (the ``scan`` and ``remat`` rounds) adds ``fsdp_gather``: the ranks'
blocks of dim 0 gathered whole over the data axes (``GridMesh.all_gather``:
``all_gather`` in the leaf's own dtype, exact), whose backward sums the
gradient over those axes and keeps this rank's block
(``GridMesh.reduce_scatter``: in float32, rounded once; ``reduce_scatter``
under NCCL, ``all_reduce(SUM)`` then this rank's slice under gloo; for two
ranks both add the same two numbers, so they give the same bits).  A
reduce-scatter runs in chunks of at most ``SCATTER_CHUNK`` elements, so its
float32 copy of a large gradient (nemotron's embedding) stays small.
``all_gathers`` and
``reduce_scatters`` count these by axes, as ``all_reduces`` counts the
others.  ``gather_dim`` is the same pair along any dim, or with the
gradient's block taken as it is where every rank holds the same gradient;
with a ``vmap`` rule, so a vmap round's clients gather their leaves
together (the ``fsdp_activations`` lever, ``models/layers.py``) and a
block's rows or heads come back whole (``models/blocks.py``).

While ``recording()`` is on, both meshes log each collective this rank
sends as a ``CollectiveCall``: its kind (``psum``, ``pmax``, ``gather``
for ``gather_rows`` / ``gather_last``, ``all_gather``, ``reduce_scatter``),
its axes (``("client",)`` on the client mesh), the elements and bytes of
what goes on the wire, and the ``repro_torch.utils.regions`` spans open
at the call (``repro_torch.analysis.collectives`` reads the screening
passes from them).  The counters above stay as they are.

``MetaGrid`` is one rank's view of a grid with no group behind it: its
collectives only shape and log their results, for the dry run's per-rank
counts on ``meta``.

Both meshes are over the caller's group: they read the initialized default
group and never pick a backend or a device on their own.  Under NCCL rank r
works on ``cuda:r``; under gloo every rank works on the device it is given,
so several gloo ranks can share one card (the collectives then pass through
the host).  ``repro_torch.launch.shards`` starts such groups.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from collections import OrderedDict
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.utils.regions import current_regions

ALL_REDUCE_RANGE = "client_mesh.all_reduce"   # profiler range around each collective
GRID_ALL_REDUCE_RANGE = "grid_mesh.all_reduce"
GRID_ALL_GATHER_RANGE = "grid_mesh.all_gather"
GRID_REDUCE_SCATTER_RANGE = "grid_mesh.reduce_scatter"
CLIENT_AXIS = "client"
SCATTER_CHUNK = 1 << 26   # elements of one reduce-scatter call (256 MB in float32)


class CollectiveCall(NamedTuple):
    """One collective sent through a mesh (see the module docstring)."""

    kind: str
    axes: tuple
    elements: int
    bytes: int
    regions: tuple


_RECORDINGS: list = []


@contextlib.contextmanager
def recording():
    """Log every collective sent through a ``ClientMesh`` or ``GridMesh``
    inside the block: yields a list that receives one ``CollectiveCall``
    each."""
    log: list = []
    _RECORDINGS.append(log)
    try:
        yield log
    finally:
        _RECORDINGS[:] = [other for other in _RECORDINGS if other is not log]


def _record(kind: str, axes: tuple, wire: torch.Tensor, dtype=None) -> None:
    """Log a collective of ``wire``'s elements, sent as ``dtype`` (``wire``'s
    own when None)."""
    if not _RECORDINGS:
        return
    size = (wire.dtype if dtype is None else dtype).itemsize
    call = CollectiveCall(kind, tuple(axes), wire.numel(), wire.numel() * size,
                          current_regions())
    for log in _RECORDINGS:
        log.append(call)


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
        _record("psum", (CLIENT_AXIS,), t)
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
        _record("gather", (CLIENT_AXIS,), full)
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



# ---------------------------------------------------------------------------
# the grid: (client,) (pod,) data, model
# ---------------------------------------------------------------------------


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class MeshShape:
    """Axis names and sizes, like ``jax.sharding.Mesh.shape``; ``coords``
    (axis -> coordinate) places one rank on it, for ``index``."""

    def __init__(self, axis_names, sizes, coords: dict | None = None):
        if len(axis_names) != len(sizes) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a mesh needs distinct names, one a size: {axis_names}, {sizes}")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict((a, int(n)) for a, n in zip(axis_names, sizes))
        self.coords = None if coords is None else {a: int(coords[a]) for a in self.axis_names}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({dict(self.shape)}, coords={self.coords})"

    @property
    def devices(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def at(self, coords: dict) -> "MeshShape":
        """The same shape with this rank at ``coords``."""
        return MeshShape(self.axis_names, tuple(self.shape.values()), coords)

    def index(self, axes) -> int:
        """This rank's block of a dim split over ``axes``: its coordinate
        over them, row-major, the first axis major (a PartitionSpec
        entry's order)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
    data=16, model=16) = 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, client: int = 0) -> MeshShape:
    """A small mesh: the non-zero axes in the order (client, pod, data,
    model)."""
    named = [(CLIENT_AXIS, client), ("pod", pod), ("data", data), ("model", model)]
    named = [(a, n) for a, n in named if n]
    if not named:
        raise ValueError("make_test_mesh needs at least one non-zero axis")
    return MeshShape(*zip(*named))


def client_axis(mesh) -> str | None:
    """The mesh's client axis name, or None when it has no client axis."""
    return CLIENT_AXIS if CLIENT_AXIS in mesh.axis_names else None


def data_axes(mesh) -> tuple:
    """The batch-parallel axes of a mesh: ('pod','data') when present."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def client_row_axes(mesh) -> tuple:
    """Mesh axes a leading client dimension shards over: the dedicated
    client axis when the mesh has one, else the data axes."""
    ca = client_axis(mesh)
    return (ca,) if ca is not None else data_axes(mesh)


def num_client_rows(mesh) -> int:
    """Number of client rows the mesh spreads a leading client dimension
    over: the client axis size when the mesh has one, else the product of
    the data-like axis sizes."""
    ca = client_axis(mesh)
    if ca is not None:
        return int(mesh.shape[ca])
    return int(math.prod(mesh.shape[a] for a in data_axes(mesh)))


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor is all-reduced in: floats as float32 (float64
    kept), others as they are."""
    return torch.float32 if dtype.is_floating_point and dtype != torch.float64 else dtype


class GridMesh(MeshShape):
    """A ``MeshShape`` over the ranks of the default process group, this
    rank at ``coords``.  ``all_reduces``, ``all_gathers`` and
    ``reduce_scatters`` count the collectives this rank has issued, by the
    axes they ran over (``"model"``, ``"data"``, ``"data+model"``,
    ``"client"``, ...)."""

    def __init__(self, shape: MeshShape, device_mesh, groups: dict, rank: int,
                 device: torch.device, backend: str):
        coords = dict(zip(shape.axis_names, device_mesh.get_coordinate()))
        super().__init__(shape.axis_names, tuple(shape.shape.values()), coords)
        self.device_mesh = device_mesh
        self.groups = groups
        self.rank = rank
        self.device = device
        self.backend = backend
        self.all_reduces: dict = {}
        self.all_gathers: dict = {}
        self.reduce_scatters: dict = {}

    def clear_counts(self) -> None:
        for counts in (self.all_reduces, self.all_gathers, self.reduce_scatters):
            counts.clear()

    def __repr__(self) -> str:
        return (f"GridMesh({dict(self.shape)}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend!r})")

    @staticmethod
    def _count(counts: dict, axes: tuple) -> None:
        label = "+".join(axes)
        counts[label] = counts.get(label, 0) + 1

    def _all_reduce_(self, t: torch.Tensor, axes: tuple, op) -> torch.Tensor:
        self._count(self.all_reduces, axes)
        with torch.profiler.record_function(GRID_ALL_REDUCE_RANGE):
            dist.all_reduce(t, op=op, group=self.groups[axes])
        return t

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        axes = _axes(axes)
        if self.size(axes) == 1:
            return t.clone()
        wire = t.to(_wire(t.dtype), copy=True, memory_format=torch.contiguous_format)
        _record("pmax" if op == dist.ReduceOp.MAX else "psum", axes, wire)
        return self._all_reduce_(wire, axes, op).to(t.dtype)

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes`` (a new tensor)."""
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks of ``axes``."""
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def _gather(self, local: torch.Tensor, axes, dim: int) -> torch.Tensor:
        axes = _axes(axes)
        n = self.size(axes)
        if n == 1:
            return local.clone()
        dim = dim % local.ndim
        w = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = w * n
        full = torch.zeros(shape, dtype=_wire(local.dtype), device=local.device)
        full.narrow(dim, self.index(axes) * w, w).copy_(local)
        _record("gather", axes, full)
        return self._all_reduce_(full, axes, dist.ReduceOp.SUM).to(local.dtype)

    def gather_rows(self, local: torch.Tensor, total: int, axes) -> torch.Tensor:
        """``(total, ...)``: every rank's ``(total / n, ...)`` row block of
        ``local`` in the order of ``axes``' coordinates, on every rank."""
        if local.shape[0] * self.size(axes) != total:
            raise ValueError(f"gather_rows: {local.shape[0]} rows a rank x {self.size(axes)} "
                             f"ranks != {total}")
        return self._gather(local, axes, 0)

    def gather_last(self, local: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's block of the last dim, concatenated in order."""
        return self._gather(local, axes, -1)

    def block(self, n: int, axes) -> slice:
        """This rank's slice of a dim of ``n`` split over ``axes``."""
        w = n // self.size(axes)
        return slice(self.index(axes) * w, (self.index(axes) + 1) * w)

    def all_gather(self, local: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every rank's block of dim ``dim`` over ``axes``, concatenated in
        the order of their coordinates (``all_gather`` in ``local``'s dtype:
        exact); contiguous (another dim than 0 is gathered as dim 0 and
        copied back into place, so that what reads it is not strided)."""
        if dim % local.ndim:
            return self.all_gather(local.movedim(dim, 0), axes).movedim(0, dim).contiguous()
        axes = _axes(axes)
        n = self.size(axes)
        x = local.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        self._count(self.all_gathers, axes)
        _record("all_gather", axes, out)
        with torch.profiler.record_function(GRID_ALL_GATHER_RANGE):
            self._gather_into(out, x, axes)
        return out

    def _gather_into(self, out: torch.Tensor, x: torch.Tensor, axes: tuple) -> None:
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.groups[axes])
        else:   # gloo: into the n row blocks of out
            dist.all_gather(list(out.chunk(self.size(axes))), x, group=self.groups[axes])

    def reduce_scatter(self, full: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """This rank's block of dim ``dim`` of the sum of ``full`` over
        ``axes``, summed in float32 and rounded once to ``full``'s dtype;
        ``SCATTER_CHUNK`` elements a call (see the module docstring);
        contiguous, as ``all_gather``'s."""
        if dim % full.ndim:
            return self.reduce_scatter(full.movedim(dim, 0), axes).movedim(0, dim).contiguous()
        axes = _axes(axes)
        n, i = self.size(axes), self.index(axes)
        w = full.shape[0] // n
        g = full.reshape(n, -1)
        out = torch.empty((g.shape[1],), dtype=full.dtype, device=full.device)
        cols = max(1, SCATTER_CHUNK // n)
        self._count(self.reduce_scatters, axes)
        _record("reduce_scatter", axes, g, torch.float32)
        with torch.profiler.record_function(GRID_REDUCE_SCATTER_RANGE):
            for c0 in range(0, g.shape[1], cols):
                out[c0:c0 + cols] = self._scatter_part(g[:, c0:c0 + cols].float().contiguous(),
                                                       axes, i)[0]
        return out.reshape((w,) + tuple(full.shape[1:]))

    def _scatter_part(self, part: torch.Tensor, axes: tuple, i: int) -> torch.Tensor:
        """Row ``i`` of the sum over ``axes`` of ``part``'s n rows."""
        if self.backend == "nccl":
            mine = torch.empty((1, part.shape[1]), dtype=part.dtype, device=part.device)
            dist.reduce_scatter_tensor(mine, part, group=self.groups[axes])
            return mine
        dist.all_reduce(part, group=self.groups[axes])   # gloo: the whole sum, then row i
        return part[i:i + 1]


class MetaGrid(GridMesh):
    """One rank's view of a grid with no process group, for counting a
    call on ``meta``: this rank at ``coords`` (default the first), its
    collectives shape-correct and unreduced (an all-reduce gives its
    operand back, an all-gather and a reduce-scatter new tensors of the
    gathered and the block's shape, nothing exchanged), each counted and
    logged (``recording``) as a ``GridMesh`` logs its own.  Their values
    are not the grid's: it serves the dry run's per-rank counts
    (``launch.dryrun``), where tensors hold no values."""

    def __init__(self, shape: MeshShape, coords: dict | None = None):
        MeshShape.__init__(self, shape.axis_names, tuple(shape.shape.values()),
                           coords or {a: 0 for a in shape.axis_names})
        self.device_mesh, self.groups, self.rank = None, {}, 0
        self.device, self.backend = torch.device("meta"), "meta"
        self.all_reduces, self.all_gathers, self.reduce_scatters = {}, {}, {}

    def __repr__(self) -> str:
        return f"MetaGrid({dict(self.shape)}, coords={self.coords})"

    def _all_reduce_(self, t: torch.Tensor, axes: tuple, op) -> torch.Tensor:
        self._count(self.all_reduces, axes)
        return t

    def _gather_into(self, out: torch.Tensor, x: torch.Tensor, axes: tuple) -> None:
        pass

    def _scatter_part(self, part: torch.Tensor, axes: tuple, i: int) -> torch.Tensor:
        return part[i:i + 1]


def _subgroup(shape: MeshShape, axes: tuple, rank: int, backend: str):
    """The process group of the ranks that differ from ``rank`` only on
    ``axes`` (several axes: ``init_device_mesh`` makes one a single axis).
    Every rank creates every such group, in the same order."""
    names = shape.axis_names
    sizes = tuple(shape.shape.values())
    others = [a for a in names if a not in axes]
    mine = None
    for fixed in itertools.product(*(range(shape.shape[a]) for a in others)):
        pin = dict(zip(others, fixed))
        ranks = []
        for free in itertools.product(*(range(shape.shape[a]) for a in axes)):
            coord = dict(pin, **dict(zip(axes, free)))
            r = 0
            for a, n in zip(names, sizes):
                r = r * n + coord[a]
            ranks.append(r)
        group = dist.new_group(ranks=ranks, backend=backend)
        if rank in ranks:
            mine = group
    return mine


def make_grid_mesh(shape: MeshShape, device) -> GridMesh:
    """``shape`` laid over the initialized default process group, whose
    world size must be ``shape.devices``.  Under NCCL rank r takes
    ``cuda:r`` (``device`` must be CUDA); under gloo every rank takes
    ``device``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a grid of {dict(shape.shape)} needs an initialized default process group of "
            f"{shape.devices} ranks (repro_torch.launch.shards.spawn starts one)")
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    world = dist.get_world_size()
    if world != shape.devices:
        raise ValueError(f"a grid of {dict(shape.shape)} wants {shape.devices} ranks but the "
                         f"process group has {world}")
    backend = dist.get_backend()
    rank = dist.get_rank()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
        device = torch.device("cuda", rank)
    if device.type == "cuda":
        # before init_device_mesh, which otherwise picks rank % cards
        torch.cuda.set_device(device)
    device_mesh = init_device_mesh(
        device.type, tuple(shape.shape.values()), mesh_dim_names=shape.axis_names,
        backend_override={a: backend for a in shape.axis_names})
    groups = {(a,): device_mesh.get_group(a) for a in shape.axis_names}
    # the groups of several axes: the client rows (one axis on a grid with a
    # client axis, else the data axes), the data axes, and the data axes with
    # model (an FSDP leaf split over both), in mesh order
    both = tuple(a for a in shape.axis_names if a in data_axes(shape) or a == "model")
    for axes in sorted({client_row_axes(shape), data_axes(shape), both}):
        if len(axes) > 1:
            groups[axes] = _subgroup(shape, axes, rank, backend)
    grid = GridMesh(shape, device_mesh, groups, rank, device, backend)
    for axes, group in groups.items():
        # the gathers place a block by its group rank: it must be the
        # rank's coordinate over the axes
        if axes and dist.get_rank(group) != grid.index(axes):
            raise RuntimeError(f"group {axes}: rank {rank} is group rank "
                               f"{dist.get_rank(group)}, not its coordinate {grid.index(axes)}")
    return grid


# ---------------------------------------------------------------------------
# differentiable collectives over one axis of a grid
# ---------------------------------------------------------------------------


class _Collective(torch.autograd.Function):
    """Base of the grid's differentiable collectives: ``apply(x, mesh,
    axes)``; under ``torch.func.vmap`` the batched tensor is moved to dim 0
    and the collective runs on it whole."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes = inputs[1], inputs[2]

    @classmethod
    def _vmap(cls, info, in_dims, x, mesh, axes):
        bdim = in_dims[0]
        if bdim is None:
            return cls.apply(x, mesh, axes), None
        return cls.apply(x.movedim(bdim, 0), mesh, axes), 0


class _CopyTo(_Collective):
    """Identity forward, sum over the axes backward."""

    @staticmethod
    def forward(x, mesh, axes):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes):
        return _CopyTo._vmap(info, in_dims, x, mesh, axes)


class _ReduceFrom(_Collective):
    """Sum over the axes forward, identity backward."""

    @staticmethod
    def forward(x, mesh, axes):
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes):
        return _ReduceFrom._vmap(info, in_dims, x, mesh, axes)


class _GatherFrom(_Collective):
    """The ranks' blocks of the last dim concatenated forward; this rank's
    block of the gradient backward."""

    @staticmethod
    def forward(x, mesh, axes):
        return mesh.gather_last(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.mesh.block(g.shape[-1], ctx.axes)], None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes):
        return _GatherFrom._vmap(info, in_dims, x, mesh, axes)


class _MaxOver(_Collective):
    """The elementwise max over the axes; not differentiated (the shift of
    a log-sum-exp)."""

    @staticmethod
    def forward(x, mesh, axes):
        return mesh.pmax(x, axes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes):
        return _MaxOver._vmap(info, in_dims, x, mesh, axes)


def copy_to(x: torch.Tensor, mesh: GridMesh, axes) -> torch.Tensor:
    """``x`` entering a column-parallel product over ``axes``."""
    return _CopyTo.apply(x, mesh, _axes(axes))


def reduce_from(x: torch.Tensor, mesh: GridMesh, axes) -> torch.Tensor:
    """The sum of the ranks' partial products over ``axes``."""
    return _ReduceFrom.apply(x, mesh, _axes(axes))


def gather_from(x: torch.Tensor, mesh: GridMesh, axes) -> torch.Tensor:
    """The ranks' blocks of the last dim over ``axes``, concatenated."""
    return _GatherFrom.apply(x, mesh, _axes(axes))


def max_over(x: torch.Tensor, mesh: GridMesh, axes) -> torch.Tensor:
    """The elementwise max over ``axes`` (no gradient)."""
    return _MaxOver.apply(x, mesh, _axes(axes))


class _GatherDim(torch.autograd.Function):
    """Every rank's block of dim ``dim`` over the axes gathered forward
    (``GridMesh.all_gather``); backward this rank's block of the gradient,
    summed over the axes first where ``summed`` (a reduce-scatter: each
    rank's gradient is a part of the whole), else taken as it is (the
    gradient is the same on every rank).  Under ``torch.func.vmap`` the
    batched tensor is moved to dim 0 and gathered along ``dim`` + 1."""

    @staticmethod
    def forward(x, mesh, axes, dim, summed):
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes, ctx.dim, ctx.summed = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim)
        else:
            w = g.shape[ctx.dim] // ctx.mesh.size(ctx.axes)
            g = g.narrow(ctx.dim, ctx.mesh.index(ctx.axes) * w, w)
        return g, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, dim, summed):
        bdim = in_dims[0]
        if bdim is None:
            return _GatherDim.apply(x, mesh, axes, dim, summed), None
        return _GatherDim.apply(x.movedim(bdim, 0), mesh, axes, dim % (x.ndim - 1) + 1,
                                summed), 0


def gather_dim(x: torch.Tensor, mesh: GridMesh, axes, dim: int, *,
               summed: bool) -> torch.Tensor:
    """The ranks' blocks of dim ``dim`` of ``x`` over ``axes``,
    concatenated; backward this rank's block of the gradient, summed over
    the axes where ``summed`` (see ``_GatherDim``)."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    return _GatherDim.apply(x, mesh, axes, dim, summed)


def fsdp_gather(x: torch.Tensor, mesh: GridMesh, axes) -> torch.Tensor:
    """The ranks' blocks of dim 0 of ``x`` over ``axes`` gathered whole;
    the gradient reduce-scattered back to this rank's block."""
    return gather_dim(x, mesh, axes, 0, summed=True)
