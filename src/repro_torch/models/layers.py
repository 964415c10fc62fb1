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
not one a leaf.  The reference's mesh levers
(``with_sharding_constraint`` under ``activation_sharding`` and
``fsdp_activations``) steer XLA's partitioner; the explicit split has no
partitioner to steer, so they have no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import copy_to, fsdp_gather, reduce_from

FSDP_BUCKET = 1 << 28   # gathered elements of one all-gather of several leaves


class ModelAxis(NamedTuple):
    """A grid's placement of a model's leaves: ``specs`` maps a path
    relative to a block (``"attn/wq"``, ``"moe/up"``) or the model
    (``"embed"``, ``"head"``) to its spec, a layer's without the L axis;
    ``batch_axes`` are the data axes a batch's rows split over under FSDP,
    ``()`` where every rank takes the whole batch."""

    mesh: object
    specs: dict
    batch_axes: tuple = ()

    @property
    def size(self) -> int:
        """The ranks of the ``model`` axis."""
        return self.mesh.shape.get("model", 1)

    def has(self, path: str) -> bool:
        """Whether a ``model`` axis of more than one rank splits the leaf."""
        return self.size > 1 and any(e == "model" for e in self.specs.get(path, ()))

    def _data_dim(self, path: str):
        """The dim of the leaf the data axes split, or None."""
        for dim, e in enumerate(self.specs[path]):
            if e is not None and e != "model":
                return dim
        return None

    def use(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """``use_tree`` of one model-level leaf."""
        return self.use_tree({path: leaf})[path]

    def use_tree(self, tree: dict, prefix: str = "") -> dict:
        """The leaves of a dict of dicts (a block's, paths after
        ``prefix``) as a forward uses them: each dim split over the data
        axes gathered (backward: this rank's block of the gradient summed
        over them); under a split batch a leaf no data axis splits enters
        through ``copy_to`` (backward: its gradient summed over them)."""
        if not self.batch_axes:
            return tree
        flat = _flatten(tree, prefix, {})
        split, whole = {}, {}
        for path, leaf in flat.items():
            dim = self._data_dim(path)
            if dim is None:
                whole.setdefault(leaf.dtype, []).append(path)
            else:
                split.setdefault(leaf.dtype, [[]])
                bucket = split[leaf.dtype][-1]
                if bucket and self._gathered(flat, bucket + [path]) > FSDP_BUCKET:
                    split[leaf.dtype].append(bucket := [])
                bucket.append(path)
        used = {}
        for buckets in split.values():
            for bucket in buckets:
                used.update(self._gather(flat, bucket))
        for paths in whole.values():
            parts = copy_to(torch.cat([flat[p].reshape(-1) for p in paths]), self.mesh,
                            self.batch_axes).split([flat[p].numel() for p in paths])
            used.update({p: part.view_as(flat[p]) for p, part in zip(paths, parts)})
        return _rebuild(tree, prefix, used)

    def _gathered(self, flat: dict, paths: list) -> int:
        return sum(flat[p].numel() for p in paths) * self.mesh.size(self.batch_axes)

    def _gather(self, flat: dict, paths: list) -> dict:
        """One all-gather of the leaves ``paths`` (one dtype): their blocks,
        the split dim first, flattened into one vector; each leaf cut back
        out of every rank's vector and its dim put back."""
        n = self.mesh.size(self.batch_axes)
        blocks = [flat[p].movedim(self._data_dim(p), 0) for p in paths]
        vec = torch.cat([b.reshape(-1) for b in blocks]) if len(blocks) > 1 else \
            blocks[0].reshape(-1)
        full = fsdp_gather(vec, self.mesh, self.batch_axes).view(n, -1)
        out = {}
        for p, b, part in zip(paths, blocks, full.split([b.numel() for b in blocks], dim=1)):
            d = self._data_dim(p)
            w = part.reshape((n * b.shape[0],) + tuple(b.shape[1:])).movedim(0, d)
            out[p] = w.contiguous() if d else w
        return out


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
