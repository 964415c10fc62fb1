"""Shared neural-net layers: norms, rotary embeddings, MLPs, initializers.

Counterpart of ``repro/models/layers.py`` on plain dicts of tensors.  Layer
stacks carry a leading L axis (``models/model.py`` builds them layer by
layer and stacks them).

Under a grid, a model holds this rank's blocks of the leaves
``launch.sharding`` splits (``ModelAxis``: the grid's placement of each
leaf) and computes on them with the grid's collectives (``launch.mesh``).
Over a ``model`` axis of more than one rank a split MLP is column-parallel
in ``gate`` and ``up`` and row-parallel in ``down``.  Under FSDP
(``fsdp=True`` specs, the ``scan`` and ``remat`` rounds) a leaf's dim split
over the data axes is gathered just before the leaf's use
(``ModelAxis.use_tree``: ``launch.mesh.fsdp_gather``, whose backward
reduce-scatters the gradient) and dropped after it; the batch's rows split
over the same axes, so a leaf no data axis splits enters through
``copy_to``, its gradient summed over them.  A block's leaves travel
together: those of one dtype in one flat all-gather of up to
``FSDP_BUCKET`` gathered elements (a larger leaf alone), and its unsplit
leaves in one ``copy_to``, so a local step issues a few collectives a layer,
not one a leaf.

The reference's ``fsdp_activations`` lever pins the residual stream's batch
to ``model`` (``repro/models/model.py:94``), so that per-layer gathers of
the weights replace the tensor-parallel all-reduces of the activations.
Here the batch's rows then split over ``model`` too (``batch_axes`` holds
it, beside the data axes under FSDP): ``use_tree`` gathers each leaf's
``model``-split dim with its data-split dim in one bucketed all-gather over
both (a leaf split over one of them enters through ``copy_to`` over the
other first), and ``size`` is 1, so each block computes as on one card, on
this rank's rows.  Each client's whole leaves would then stay saved for
the backward, a whole model of them a client; so, as FSDP frees its
gathered weights after the forward, the loss runs under ``regathered()``:
a tensor autograd saves that lies in a gathered leaf is kept as the rank's
block of that leaf, gathered again when the backward reads it.  The
model's other levers act in ``models/blocks.py`` and ``models/ssm.py``.
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import copy_to, fsdp_gather, reduce_from

FSDP_BUCKET = 1 << 28   # gathered elements of one all-gather of several leaves
# fsdp_activations' gathered leaves alive: storage address -> [_Gathered]
_GATHERED: dict = {}


def _entry_axes(entry) -> tuple:
    """The axes of one spec entry (``None``, a name or a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class ModelAxis(NamedTuple):
    """A grid's placement of a model's leaves: ``specs`` maps a path
    relative to a block (``"attn/wq"``, ``"moe/up"``) or the model
    (``"embed"``, ``"head"``) to its spec, a layer's without the L axis;
    ``batch_axes`` are the axes a batch's rows split over (the data axes
    under FSDP, ``model`` under ``fsdp_activations``), ``()`` where every
    rank takes the whole batch."""

    mesh: object
    specs: dict
    batch_axes: tuple = ()

    @property
    def size(self) -> int:
        """The ranks of the ``model`` axis that split a block's work: 1
        where the rows split over ``model`` (each leaf gathered whole)."""
        return 1 if "model" in self.batch_axes else self.mesh.shape.get("model", 1)

    def has(self, path: str) -> bool:
        """Whether a ``model`` axis of more than one rank splits the leaf's
        work (its block computes tensor-parallel)."""
        return self.size > 1 and any(e == "model" for e in self.specs.get(path, ()))

    def _splits(self, path: str) -> list:
        """(dim, axes) of each dim of the leaf split over the batch's axes:
        the dims gathered at its use."""
        out = []
        for dim, e in enumerate(self.specs[path]):
            axes = _entry_axes(e)
            if axes and set(axes) <= set(self.batch_axes):
                out.append((dim, axes))
        return out

    def regathered(self):
        """The context a loss runs in: under ``fsdp_activations`` (``model``
        among ``batch_axes``) the gathered leaves are saved for the backward
        as this rank's blocks and gathered again there (the module
        docstring); else nothing."""
        if "model" not in self.batch_axes:
            return contextlib.nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)

    def use(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """``use_tree`` of one model-level leaf."""
        return self.use_tree({path: leaf})[path]

    def use_tree(self, tree: dict, prefix: str = "") -> dict:
        """The leaves of a dict of dicts (a block's, paths after
        ``prefix``) as a forward uses them: each dim split over the batch's
        axes gathered (backward: this rank's block of the gradient summed
        over them); over the batch's other axes a leaf enters through
        ``copy_to`` (backward: its gradient summed over them)."""
        if not self.batch_axes:
            return tree
        flat = _flatten(tree, prefix, {})
        groups: dict = {}   # (dtype, gathered axes, copied axes) -> buckets of paths
        for path, leaf in flat.items():
            used = {a for _, axes in self._splits(path) for a in axes}
            gathered = tuple(a for a in self.mesh.axis_names if a in used)
            copied = tuple(a for a in self.batch_axes if a not in used)
            buckets = groups.setdefault((leaf.dtype, gathered, copied), [[]])
            bucket = buckets[-1]
            if gathered and bucket and self._gathered(flat, bucket + [path],
                                                      gathered) > FSDP_BUCKET:
                buckets.append(bucket := [])
            bucket.append(path)
        used = {}
        for (_, gathered, copied), buckets in groups.items():
            for paths in buckets:
                if gathered:
                    used.update(self._gather(flat, paths, gathered, copied))
                    continue
                parts = copy_to(torch.cat([flat[p].reshape(-1) for p in paths]), self.mesh,
                                copied).split([flat[p].numel() for p in paths])
                used.update({p: part.view_as(flat[p]) for p, part in zip(paths, parts)})
        return _rebuild(tree, prefix, used)

    def _gathered(self, flat: dict, paths: list, axes: tuple) -> int:
        return sum(flat[p].numel() for p in paths) * self.mesh.size(axes)

    def _gather(self, flat: dict, paths: list, axes: tuple, copied: tuple) -> dict:
        """One all-gather over ``axes`` of the leaves ``paths`` (one dtype,
        split over the same axes): their blocks, the split dims first,
        flattened into one vector, which enters through ``copy_to`` over
        ``copied``; each leaf cut back out of every rank's vector and its
        dims put back."""
        n = self.mesh.size(axes)
        blocks = []
        for p in paths:
            dims = [d for d, _ in self._splits(p)]
            blocks.append(flat[p].movedim(dims, list(range(len(dims)))))
        vec = torch.cat([b.reshape(-1) for b in blocks]) if len(blocks) > 1 else \
            blocks[0].reshape(-1)
        if copied:
            vec = copy_to(vec, self.mesh, copied)
        full = fsdp_gather(vec, self.mesh, axes).view(n, -1)
        sizes = tuple(self.mesh.shape[a] for a in axes)
        out = {}
        for p, b, part in zip(paths, blocks, full.split([b.numel() for b in blocks], dim=1)):
            splits = self._splits(p)
            k = len(splits)
            # (the gathered axes..., the block's dims): each split dim's axes
            # before it, then merged into it
            t = part.reshape(sizes + tuple(b.shape))
            order = [i for j, (_, on) in enumerate(splits)
                     for i in [axes.index(a) for a in on] + [len(axes) + j]]
            order += list(range(len(axes) + k, t.ndim))
            shape = [self.mesh.size(on) * b.shape[j] for j, (_, on) in enumerate(splits)]
            w = t.permute(order).reshape(shape + list(b.shape[k:]))
            out[p] = w.movedim(list(range(k)), [d for d, _ in splits]).contiguous()
            if "model" in self.batch_axes and torch.is_grad_enabled():
                _Gathered.keep(out[p], flat[p], functools.partial(self._regather, p, axes))
        return out

    def _regather(self, path: str, axes: tuple, block: torch.Tensor) -> torch.Tensor:
        """The leaf ``path`` gathered whole over ``axes`` from this rank's
        ``block`` of it, as ``_gather`` gathers it (the backward's copy)."""
        return self._gather({path: block}, [path], axes, ())[path]


def _physical(t: torch.Tensor) -> tuple:
    """(the tensor under ``t``'s vmap level, its batch dim), or (t, None)
    outside vmap (the port vmaps over the clients alone)."""
    f = torch._C._functorch
    return (f.get_unwrapped(t), f.maybe_get_bdim(t)) if f.is_batchedtensor(t) else (t, None)


class _Gathered:
    """A gathered leaf's place in its storage (physical, under vmap) and
    how to gather it again from this rank's block: what ``_pack`` keeps in
    place of a saved tensor that lies in it."""

    def __init__(self, phys, bdim, block, regather):
        self.size, self.stride, self.offset = phys.shape, phys.stride(), phys.storage_offset()
        self.span = (self.offset, self.offset + _extent(phys))
        self.key = phys.untyped_storage().data_ptr()
        self.bdim, (self.block, self.block_bdim) = bdim, _physical(block)
        self.regather = regather

    @staticmethod
    def keep(leaf, block, regather) -> None:
        """Register ``leaf`` for as long as its tensor lives, where it fills
        its span of storage (a leaf cut from a bucket's gathered vector
        under vmap may not: it stays saved whole)."""
        phys, bdim = _physical(leaf)
        if phys.device.type == "meta" or not _dense(phys):
            return
        entry = _Gathered(phys, bdim, block, regather)
        _GATHERED.setdefault(entry.key, []).append(entry)
        weakref.finalize(phys, _forget, entry)

    def rebuild(self, size, stride, offset) -> torch.Tensor:
        """The saved view (``size``, ``stride``, ``offset`` in the leaf's
        storage) of the leaf gathered again."""
        with torch.no_grad():
            if self.bdim is None:
                whole = self.regather(self.block)
            else:
                whole = torch.func.vmap(self.regather, in_dims=self.block_bdim,
                                        out_dims=self.bdim)(self.block)
            if whole.stride() != tuple(self.stride) or whole.storage_offset():
                whole = torch.empty_strided(self.size, self.stride, dtype=whole.dtype,
                                            device=whole.device).copy_(whole)
        return whole.as_strided(size, stride, offset - self.offset)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t`` fills its span of storage once: its dims, by stride,
    each as far apart as the elements of the smaller ones."""
    step = 1
    for n, s in sorted(((n, s) for n, s in zip(t.shape, t.stride()) if n != 1),
                       key=lambda ns: ns[1]):
        if s != step:
            return False
        step *= n
    return True


def _extent(t: torch.Tensor) -> int:
    """The elements of storage from ``t``'s first to one past its last."""
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())) if t.numel() else 0


def _forget(entry: _Gathered) -> None:
    entries = _GATHERED.get(entry.key, [])
    if entry in entries:
        entries.remove(entry)
    if not entries:
        _GATHERED.pop(entry.key, None)


def _pack(t: torch.Tensor):
    """A saved tensor that lies in a gathered leaf: the leaf's entry and the
    view's geometry; any other tensor: itself."""
    if t.device.type == "meta" or not _GATHERED:
        return t
    start = t.storage_offset()
    for entry in _GATHERED.get(t.untyped_storage().data_ptr(), ()):
        if entry.span[0] <= start and start + _extent(t) <= entry.span[1]:
            return entry, t.shape, t.stride(), start
    return t


def _unpack(saved):
    return saved if isinstance(saved, torch.Tensor) else saved[0].rebuild(*saved[1:])


def _flatten(tree: dict, prefix: str, out: dict) -> dict:
    """path -> leaf of a dict of dicts, the paths after ``prefix``.  (A
    module-level function: a nested one that calls itself is a reference
    cycle through its closure, which would keep the gathered leaves of
    ``use_tree`` alive until the cyclic collector runs.)"""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = v
    return out


def _rebuild(tree: dict, prefix: str, leaves: dict) -> dict:
    """``tree``'s structure with each leaf taken from ``leaves`` by path."""
    return {k: _rebuild(v, f"{prefix}{k}/", leaves) if isinstance(v, dict) else leaves[prefix + k]
            for k, v in tree.items()}


def dense_init(generator: torch.Generator, shape, dtype, *, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times ``scale``
    (default 1/sqrt(fan_in), fan_in = ``shape[0]``), cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=t.device)  # the shape alone
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (s * t).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + weight`` gain, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary position embedding, half-split rotation with f32 angles.
    x: (..., L, H, D); positions: (..., L)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[..., None] * freqs  # (..., L, half)
    cos = torch.cos(ang)[..., None, :]  # (..., L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, activation: str, dtype, *,
             device=None) -> dict:
    kw = dict(device=device)
    if activation in ("swiglu", "geglu"):
        return {
            "gate": dense_init(generator, (d_model, d_ff), dtype, **kw),
            "down": dense_init(generator, (d_ff, d_model), dtype, **kw),
            "up": dense_init(generator, (d_model, d_ff), dtype, **kw),
        }
    return {
        "up": dense_init(generator, (d_model, d_ff), dtype, **kw),
        "down": dense_init(generator, (d_ff, d_model), dtype, **kw),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _mlp_hidden(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(x @ p["gate"]) * (x @ p["up"])
    if activation == "geglu":
        return gelu(x @ p["gate"]) * (x @ p["up"])
    if activation == "squared_relu":
        return torch.square(F.relu(x @ p["up"]))
    return gelu(x @ p["up"])


def apply_mlp(p: dict, x: torch.Tensor, activation: str, tp: ModelAxis | None = None):
    """The MLP; under ``tp`` with the ff dim split (``gate``, ``up`` and
    ``down`` split alike, by ``d_ff % model``), the partial products of
    ``down`` are summed over the axis."""
    if tp is not None and tp.has("mlp/down"):
        x = copy_to(x, tp.mesh, "model")
        return reduce_from(_mlp_hidden(p, x, activation) @ p["down"], tp.mesh, "model")
    return _mlp_hidden(p, x, activation) @ p["down"]


def mlp_param_count(d_model: int, d_ff: int, activation: str) -> int:
    return d_model * d_ff * (3 if activation in ("swiglu", "geglu") else 2)
