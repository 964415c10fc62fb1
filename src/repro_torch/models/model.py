"""Model assembly of the dense and MoE families: init / forward / loss /
prefill / decode.

Counterpart of ``repro/models/model.py`` (without the hybrid branches) on a
dict of tensors whose layer stack has a leading L axis, as the JAX
package's ``vmap``-stacked params, so a JAX parameter tree converts leaf
for leaf (``repro_torch.convert``).  The layers run in a Python loop over
that axis.  The head is untied from the embedding, as in the JAX package.
The SSM, hybrid, VLM and audio families wait for their slices (ROADMAP
A.5): ``build_model`` raises ``NotImplementedError`` for them.

Batch convention: ``{"tokens": (B, L) int, "labels": (B, L) int}``; labels
below 0 are masked out of the loss.

Serving.  The cache keeps the reference's tree, ``{"layers": (k, v), "pos":
(B,) int32}`` with k and v each ``(L, B, S, Hkv, D)``.  ``prefill`` returns
a new cache; ``decode_step`` writes the step's key and value into it in
place (one ``index_put_`` per layer and tensor), advances ``cache["pos"]``
in place and returns the same dict: it reads nothing from the host, so a
CUDA graph can replay it over static buffers (``repro_torch.launch.serve``).
A caller that keeps an earlier cache clones it first.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models.blocks import (
    apply_block,
    decode_block,
    init_block,
    init_block_cache,
    prefill_block,
)
from repro_torch.models.config import ModelConfig, validate
from repro_torch.models.layers import dense_init, rms_norm


class Model(NamedTuple):
    config: ModelConfig
    init: Any           # (generator, device) -> params
    loss_fn: Any        # (params, batch) -> (loss, metrics)
    forward: Any        # (params, batch, use_window=False) -> logits (B, L, V) f32
    prefill: Any        # (params, batch, cache_size, use_window=False) -> (logits_last, cache)
    decode_step: Any    # (params, cache, tokens (B,), pos=None, ring=False) -> (logits, cache)
    init_cache: Any     # (batch, cache_size, dtype=None, device="cuda") -> cache


def layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def stack_layers(trees: list) -> dict:
    """Per-layer trees -> one tree with a leading L axis on every leaf.  The
    leaves are popped out of ``trees`` as they are stacked, so only one
    leaf's layers are held twice (a model as large as the card's memory
    allows, e.g. olmoe-1b-7b in f32, is built without a second copy)."""
    first = trees[0]
    return {k: stack_layers([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t.pop(k) for t in trees]) for k in list(first)}


def build_model(cfg: ModelConfig) -> Model:
    validate(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch yet "
            "(ROADMAP A.5: the SSM, hybrid, VLM and audio families)"
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

    def _positions(tokens):
        b, l = tokens.shape
        return torch.arange(l, device=tokens.device).expand(b, l)

    def _embed(params, tokens):
        return params["embed"][tokens.long()].to(cfg.cdtype)

    def _hidden(params, tokens, use_window):
        """The final-normed hidden states and the layers' summed (lb, z),
        None for a dense model."""
        h = _embed(params, tokens)
        positions = _positions(tokens)
        aux = None
        for i in range(L):
            h, block_aux = apply_block(layer(params["layers"], i), cfg, h,
                                       positions=positions, use_window=use_window)
            if block_aux is not None:
                aux = torch.stack(block_aux) if aux is None else aux + torch.stack(block_aux)
        return rms_norm(h, params["final_norm"]), aux

    def forward(params, batch, use_window: bool = False) -> torch.Tensor:
        h, _ = _hidden(params, batch["tokens"], use_window)
        return (h @ params["head"]).float()

    def loss_fn(params, batch, use_window: bool = False):
        h, aux = _hidden(params, batch["tokens"], use_window)
        logits = (h @ params["head"]).float()
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if aux is None:  # dense blocks have no router: the aux terms are zero
            zero = torch.zeros((), dtype=torch.float32, device=logits.device)
            return ce, {"ce": ce, "lb_loss": zero, "z_loss": zero}
        loss = ce + cfg.router_aux_weight * aux[0] + cfg.router_z_weight * aux[1]
        return loss, {"ce": ce, "lb_loss": aux[0], "z_loss": aux[1]}

    def init_cache(batch_size: int, cache_size: int, dtype=None, device="cuda") -> dict:
        """An empty cache on ``device`` (the card unless ``device="cpu"``)."""
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        k, v = init_block_cache(cfg, batch_size, cache_size, dtype or cfg.cdtype,
                                device=device)
        return {"layers": (k.expand(L, *k.shape).clone(), v.expand(L, *v.shape).clone()),
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def prefill(params, batch, cache_size: int, use_window: bool = False):
        """The prompt through every layer -> (logits of its last token (B, V)
        f32, a new cache holding it).  ``use_window`` takes the sliding
        window and the ring layout of ``cache_size`` slots."""
        tokens = batch["tokens"]
        h = _embed(params, tokens)
        positions = _positions(tokens)
        ks, vs = [], []
        for i in range(L):
            h, (k, v) = prefill_block(layer(params["layers"], i), cfg, h, positions=positions,
                                      cache_size=cache_size, use_window=use_window)
            ks.append(k)
            vs.append(v)
        b, l = tokens.shape
        cache = {"layers": (torch.stack(ks), torch.stack(vs)),
                 "pos": torch.full((b,), l, dtype=torch.int32, device=h.device)}
        h = rms_norm(h, params["final_norm"])
        return (h[:, -1] @ params["head"]).float(), cache

    def decode_step(params, cache, tokens, pos=None, *, ring: bool = False):
        """tokens (B,) int at positions ``pos`` (default ``cache["pos"]``) ->
        (logits (B, V) f32, cache): the cache is written in place and its
        ``pos`` becomes ``pos + 1``."""
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        pos = cache["pos"] if pos is None else pos
        h1 = _embed(params, tokens)
        k_all, v_all = cache["layers"]
        for i in range(L):
            h1 = decode_block(layer(params["layers"], i), cfg, h1, (k_all[i], v_all[i]), pos,
                              ring=ring)
        cache["pos"].copy_(pos + 1)
        h1 = rms_norm(h1, params["final_norm"])
        return (h1 @ params["head"]).float(), cache

    return Model(cfg, init, loss_fn, forward, prefill, decode_step, init_cache)
