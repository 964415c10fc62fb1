"""Shared neural-net layers: norms, rotary embeddings, MLPs, initializers.

Counterpart of ``repro/models/layers.py`` on plain dicts of tensors.  Layer
stacks carry a leading L axis (``models/model.py`` builds them layer by
layer and stacks them).

Under a grid whose ``model`` axis has more than one rank, a model holds
this rank's blocks of the leaves ``launch.sharding`` splits over it
(``ModelAxis``) and computes on them with the grid's collectives
(``launch.mesh``): a split MLP is column-parallel in ``gate`` and ``up``
and row-parallel in ``down``.  The reference's mesh levers
(``with_sharding_constraint`` under ``activation_sharding`` and
``fsdp_activations``) steer XLA's partitioner; the explicit split has no
partitioner to steer, so they have no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import copy_to, reduce_from


class ModelAxis(NamedTuple):
    """A grid's ``model`` axis of more than one rank, and the leaves split
    over it: paths relative to a block (``"attn/wq"``, ``"mlp/down"``) or
    the model (``"embed"``, ``"head"``)."""

    mesh: object
    sharded: frozenset

    @property
    def size(self) -> int:
        return self.mesh.shape["model"]

    def has(self, path: str) -> bool:
        return path in self.sharded


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
