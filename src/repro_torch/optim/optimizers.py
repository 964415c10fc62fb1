"""SGD with momentum, the paper's client optimizer.

Counterpart of ``sgd_momentum`` in ``repro/optim/optimizers.py``:
``mu = momentum * mu + g`` and the update ``-lr * mu`` (the caller adds it).
Works on dicts of tensors; stacked client axes need nothing special.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


class OptState(NamedTuple):
    step: int
    mu: dict


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return OptState(step=0, mu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state, params=None):
        mu = {k: momentum * state.mu[k] + g for k, g in grads.items()}
        return {k: -lr * m for k, m in mu.items()}, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update)
