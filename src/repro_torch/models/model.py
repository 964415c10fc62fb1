"""Model assembly of the dense family: init / forward / loss.

Counterpart of ``repro/models/model.py`` on a dict of tensors whose layer
stack has a leading L axis, as the JAX package's ``vmap``-stacked params, so
a JAX parameter tree converts leaf for leaf (``repro_torch.convert``).  The
layers run in a Python loop over that axis.  The head is untied from the
embedding, as in the JAX package.  ``prefill``, ``decode_step`` and
``init_cache`` wait for the serving slice, and the other families for their
own (ROADMAP queue A): they raise ``NotImplementedError``.

Batch convention: ``{"tokens": (B, L) int, "labels": (B, L) int}``; labels
below 0 are masked out of the loss.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models.blocks import apply_block, init_block
from repro_torch.models.config import ModelConfig, validate
from repro_torch.models.layers import dense_init, rms_norm


class Model(NamedTuple):
    config: ModelConfig
    init: Any           # (generator, device) -> params
    loss_fn: Any        # (params, batch) -> (loss, metrics)
    forward: Any        # (params, batch, use_window=False) -> logits (B, L, V) f32
    prefill: Any        # not ported (serving slice)
    decode_step: Any    # not ported (serving slice)
    init_cache: Any     # not ported (serving slice)


def _serving_not_ported(*_args, **_kw):
    raise NotImplementedError(
        "prefill, decode_step and init_cache are not ported to repro_torch yet "
        "(ROADMAP queue A: the serving slice)"
    )


def layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def stack_layers(trees: list) -> dict:
    """Per-layer trees -> one tree with a leading L axis on every leaf."""
    first = trees[0]
    return {k: stack_layers([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def build_model(cfg: ModelConfig) -> Model:
    validate(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch yet "
            "(ROADMAP queue A: the MoE, SSM, hybrid, VLM and audio families)"
        )
    L = cfg.num_layers

    def init(generator: torch.Generator | None, device="cuda") -> dict:
        """Random params on ``device`` (the card unless ``device="cpu"``;
        raises without CUDA), drawn from ``generator``, which must live on
        that device.  ``device="meta"`` gives the shapes and draws nothing."""
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        return {
            "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                scale=0.02, device=device),
            "layers": stack_layers([init_block(generator, cfg, device=device)
                                    for _ in range(L)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
            "head": dense_init(generator, (cfg.d_model, cfg.vocab_size), cfg.pdtype,
                               scale=0.02, device=device),
        }

    def _hidden(params, tokens, use_window):
        h = params["embed"][tokens.long()].to(cfg.cdtype)
        b, l = h.shape[:2]
        positions = torch.arange(l, device=h.device).expand(b, l)
        for i in range(L):
            h = apply_block(layer(params["layers"], i), cfg, h, positions=positions,
                            use_window=use_window)
        return rms_norm(h, params["final_norm"])

    def forward(params, batch, use_window: bool = False) -> torch.Tensor:
        h = _hidden(params, batch["tokens"], use_window)
        return (h @ params["head"]).float()

    def loss_fn(params, batch, use_window: bool = False):
        h = _hidden(params, batch["tokens"], use_window)
        logits = (h @ params["head"]).float()
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
        # dense blocks have no router: the auxiliary terms are zero, the loss is ce
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        return ce, {"ce": ce, "lb_loss": zero, "z_loss": zero}

    return Model(cfg, init, loss_fn, forward, _serving_not_ported, _serving_not_ported,
                 _serving_not_ported)
