"""Shared neural-net layers: norms, rotary embeddings, MLPs, initializers.

Counterpart of ``repro/models/layers.py`` on plain dicts of tensors.  Layer
stacks carry a leading L axis (``models/model.py`` builds them layer by
layer and stacks them).  The JAX package's mesh helpers have no counterpart
on one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape, dtype, *, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times ``scale``
    (default 1/sqrt(fan_in), fan_in = ``shape[0]``), cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.device.type != "meta":
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


def apply_mlp(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    elif activation == "geglu":
        h = gelu(x @ p["gate"]) * (x @ p["up"])
    elif activation == "squared_relu":
        h = torch.square(F.relu(x @ p["up"]))
    else:  # gelu
        h = gelu(x @ p["up"])
    return h @ p["down"]


def mlp_param_count(d_model: int, d_ff: int, activation: str) -> int:
    return d_model * d_ff * (3 if activation in ("swiglu", "geglu") else 2)
