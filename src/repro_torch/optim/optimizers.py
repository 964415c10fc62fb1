"""SGD with momentum (the paper's client optimizer), AdamW and lr schedules.

Counterpart of ``repro/optim/optimizers.py``, on flat dicts of tensors
(stacked client axes need nothing special): ``opt = sgd_momentum(lr)``,
``state = opt.init(params)``, ``updates, state = opt.update(grads, state,
params)``; the updates carry the negative sign and the caller adds them.

``step`` is a host int: every client call runs ``opt.init``, so a captured
round replays the same steps.  A schedule (a callable ``lr``) takes the step
and returns a Python float holding the float32 value the reference computes
(``linear_warmup``, ``cosine_schedule``); the bias corrections of ``adamw``
are float32 too.  A float ``lr`` with no decay keeps ``sgd_momentum`` at two
device ops a leaf, ``mu = momentum * mu + g`` and ``-lr * mu``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


class OptState(NamedTuple):
    step: int
    mu: dict
    nu: dict | None = None


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def sgd_momentum(lr, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return OptState(step=0, mu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state, params=None):
        step = state.step + 1
        if weight_decay and params is not None:
            grads = {k: g + weight_decay * params[k].to(g.dtype) for k, g in grads.items()}
        mu = {k: momentum * state.mu[k] + g for k, g in grads.items()}
        lr_t = lr_fn(step)
        return {k: -lr_t * m for k, m in mu.items()}, OptState(step=step, mu=mu)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with float32 moments; the update is cast to each parameter's
    dtype.  The bias corrections ``1 - b**step`` are float32 0-d tensors on
    the moments' device, so the divisions are true divisions there."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return OptState(
            step=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        )

    def update(grads, state, params=None):
        step = state.step + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float() for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        dev = next(iter(mu.values())).device
        bc1 = (1 - _f32(b1) ** _f32(step)).to(dev)
        bc2 = (1 - _f32(b2) ** _f32(step)).to(dev)
        lr_t = lr_fn(step)

        def upd_leaf(k):
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * params[k].float()
            return (-lr_t * u).to(params[k].dtype)

        return {k: upd_leaf(k) for k in mu}, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step) -> float:
        s = _f32(int(step))
        return float(peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0))

    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    def fn(step) -> float:
        s = _f32(int(step))
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return float(peak_lr * warm * cos)

    return fn
