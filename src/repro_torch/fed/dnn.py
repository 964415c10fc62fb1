"""The paper's fully-connected DNNs on dicts of tensors.

Counterpart of ``repro/fed/dnn.py``.  MNIST: 784 x 512 x 256 x 10, Spambase:
54 x 100 x 50 x 1; LeakyReLU(0.1) on hidden layers, softmax (or, with one
output unit, sigmoid) cross-entropy, inverted dropout p = 0.5 on hidden
activations when keep-masks are given.

Every function takes either one model (``w{i}`` of shape (fan_in, fan_out),
inputs (N, d)) or K stacked client models (``w{i}`` of shape (K, fan_in,
fan_out), inputs (K, N, d)); the stacked form is the batched client layer,
one ``baddbmm`` per layer for all clients.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import resolve_device


def init_dnn(generator: torch.Generator, sizes: Sequence[int], *, device="cuda"):
    """He-normal weights, zero biases, on ``device`` (the card unless
    ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((fan_in, fan_out), generator=generator, dtype=torch.float32,
                        device=generator.device)
        params[f"w{i}"] = (w * math.sqrt(2.0 / fan_in)).to(device)
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=torch.float32, device=device)
    return params


def num_layers(params) -> int:
    return sum(1 for k in params if k.startswith("w"))


def dnn_logits(params, x, *, dropout_keep=None, dropout_p: float = 0.5):
    """Logits; ``dropout_keep`` is a list of bool keep-masks, one per hidden
    layer, shaped like that layer's activations."""
    n = num_layers(params)
    h = x
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if w.ndim == 3:
            h = torch.baddbmm(b.unsqueeze(1), h, w)
        else:
            h = torch.addmm(b, h, w)
        if i < n - 1:
            h = F.leaky_relu(h, 0.1)
            if dropout_keep is not None:
                h = torch.where(dropout_keep[i], h / (1.0 - dropout_p), 0.0)
    return h


def dnn_loss(params, batch, *, dropout_keep=None, dropout_p: float = 0.5):
    """Mean cross-entropy over the batch axis: a scalar for one model, (K,)
    for stacked client models."""
    logits = dnn_logits(params, batch["x"], dropout_keep=dropout_keep, dropout_p=dropout_p)
    y = batch["y"]
    if logits.shape[-1] == 1:
        z = logits[..., 0]
        yf = y.float()
        per = torch.clamp(z, min=0) - z * yf + torch.log1p(torch.exp(-z.abs()))
        return per.mean(dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long().unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean(dim=-1)


def dnn_error(params, x, y) -> torch.Tensor:
    """Misclassification rate of one model."""
    with torch.no_grad():
        logits = dnn_logits(params, x)
        if logits.shape[-1] == 1:
            pred = (logits[..., 0] > 0).to(y.dtype)
        else:
            pred = torch.argmax(logits, dim=-1).to(y.dtype)
        return (pred != y).float().mean()
