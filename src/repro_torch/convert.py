"""Carry state from the JAX package into the port, through numpy.

``params_from_numpy`` takes the JAX package's DNN parameters as numpy
arrays (``{"w0": ..., "b0": ..., ...}``, e.g. ``jax.tree.map(np.asarray,
params)``) and returns the port's parameters; ``model_params_from_numpy``
and ``lora_params_from_numpy`` do the same for a transformer's parameter
tree and a LoRA workload's ``{"base", "adapters"}``; ``cache_from_numpy``
for a KV cache of ``repro.models`` (``prefill``'s, ``init_cache``'s);
``server_state_from_numpy`` does it for a server state whose leaves were
turned into numpy.  The module takes numpy and imports nothing of JAX.

A bfloat16 leaf arrives as numpy's ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects: it goes through float32 (exact) and is cast
to ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import ReputationState
from repro_torch.fed.server import ServerState


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: widen exactly, then narrow in torch
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=dtype or torch.bfloat16)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, *, device="cuda") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``
    (the card unless ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    return _tensor(tree, device)


def model_params_from_numpy(tree, *, device="cuda") -> dict:
    """A transformer's parameter tree (``repro.models.build_model(cfg).init``,
    leaves as numpy) -> the port's tree for ``repro_torch.models``, leaf for
    leaf: the layer stack keeps its leading L axis, bf16 stays bf16, and an
    MoE layer's f32 router stays f32 beside its experts' dtype."""
    return params_from_numpy(tree, device=device)


def cache_from_numpy(cache, *, device="cuda") -> dict:
    """A KV cache of ``repro.models`` (``{"layers": (k, v), "pos"}``, k and v
    each ``(L, B, S, Hkv, D)``, leaves as numpy) -> the port's cache on
    ``device``, which ``decode_step`` writes in place."""
    device = resolve_device(device)
    k, v = cache["layers"]
    return {"layers": (_tensor(k, device), _tensor(v, device)),
            "pos": _tensor(cache["pos"], device, torch.int32)}


def lora_params_from_numpy(tree, *, device="cuda") -> dict:
    """A LoRA workload's ``{"base": model params, "adapters": adapter tree}``
    (leaves as numpy) -> the port's, on ``device``."""
    return {"base": model_params_from_numpy(tree["base"], device=device),
            "adapters": params_from_numpy(tree["adapters"], device=device)}


def server_state_from_numpy(state, *, device="cuda") -> ServerState:
    """An object shaped like the JAX ``ServerState`` (``.reputation.alpha /
    .beta / .blocked``, ``.rounds_blocked``, ``.round``) with numpy leaves ->
    the port's ``ServerState`` on ``device`` (the card unless
    ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    rep = state.reputation
    return ServerState(
        reputation=ReputationState(
            alpha=_tensor(rep.alpha, device, torch.float32),
            beta=_tensor(rep.beta, device, torch.float32),
            blocked=_tensor(rep.blocked, device, torch.bool),
        ),
        rounds_blocked=_tensor(state.rounds_blocked, device, torch.int32),
        round=int(np.asarray(state.round)),
    )
