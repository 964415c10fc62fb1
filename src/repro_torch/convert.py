"""Carry state from the JAX package into the port, through numpy.

``params_from_numpy`` takes the JAX package's DNN parameters as numpy
arrays (``{"w0": ..., "b0": ..., ...}``, e.g. ``jax.tree.map(np.asarray,
params)``) and returns the port's parameters; ``server_state_from_numpy``
does the same for a server state whose leaves were turned into numpy.  The
module takes numpy and imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import ReputationState
from repro_torch.fed.server import ServerState


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, *, device="cuda") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``
    (the card unless ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    return _tensor(tree, device)


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
