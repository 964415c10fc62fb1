"""Model assembly of every family: init / forward / loss / prefill / decode.

Counterpart of ``repro/models/model.py`` on a dict of tensors whose layer
stack has a leading L axis, as the JAX package's ``vmap``-stacked params,
so a JAX parameter tree converts leaf for leaf (``repro_torch.convert``).
The layers run in a Python loop over that axis.  The head is untied from
the embedding, as in the JAX package.

Hybrid (zamba2-style) models run uniform segments of ``shared_attn_every``
Mamba-2 layers and apply the one ``params["shared"]`` attention block after
each full segment, with its own KV cache for each application point; a
remainder segment (``num_layers % shared_attn_every`` layers) has no shared
block after it.

Batch conventions:
  LM families: ``{"tokens": (B, L) int, "labels": (B, L) int}``, labels
               below 0 masked out of the loss;
  vlm:         + ``{"patch_embeds": (B, prefix_len, frontend_dim)}``, projected
               and put before the token embeddings; the loss is on the text;
  audio:       ``{"frame_embeds": (B, L, frontend_dim), "labels": (B, L)}``
               (an encoder: no decode step).

Serving.  The cache keeps the reference's tree: ``{"layers": ..., "pos": (B,)
int32}``, the layers' caches stacked on a leading L axis (``(k, v)`` each
``(L, B, S, Hkv, D)``, or an SSM stack's ``{"state": (L, B, H, N, P) f32,
"conv": (L, B, cw - 1, d_inner + 2N)}``), and a hybrid model's shared
blocks' ``(k, v)`` under ``"shared"``, stacked on the segment axis.
``prefill`` returns a new cache; ``decode_step`` writes every cache in place
(one ``index_put_`` per attention layer and tensor, the SSM state and conv
window updated in place), advances ``cache["pos"]`` in place and returns the
same dict: it reads nothing from the host, so a CUDA graph can replay it
over static buffers (``repro_torch.launch.serve``).  A caller that keeps an
earlier cache clones it first.

Under a grid.  ``build_model(cfg, grid=)`` on a grid of more than
one rank (every family) gives a model whose
``init`` draws the one-card weights leaf by leaf from the same stream and
keeps this rank's block of each (``launch.sharding.shard_params_tree``, with
FSDP under the ``scan`` and ``remat`` modes of ``cfg.fed_mode``, as the
reference's ``launch/specs.py`` chooses), never holding a whole split leaf
past its draw, and whose ``loss_fn`` and ``forward`` compute on such blocks
(``layers.ModelAxis``, the placement of each leaf).  Over a ``model`` axis
of more than one rank: the embedding's vocab rows split (tokens outside the
local rows read zeros, then a sum over the axis), the blocks
tensor-parallel (``models/blocks.py``) and an MoE block's experts split
(``models/moe.py``), a Mamba-2 block's projections split and its
projection's output gathered (``models/ssm.py``), a hybrid model's shared
block placed by its own ``shared/...`` specs, a frontend's projection split
by columns and its output gathered, and the head's logits split over the
vocabulary:
``loss_fn``'s log-sum-exp takes the max over the axis, then the sum of the
exponentials, and the gold logit comes from the rank that holds it;
``forward`` gathers the logits whole.  Under FSDP each leaf's dim split
over the data axes is gathered at its use (``ModelAxis.use``), and every
rank is given the whole batch and keeps its block of the rows (the batch's
first dim), which must split over the data axes (else ``ValueError``); the
cross-entropy divides the sum over every rank's unmasked labels by their
global count (one ``reduce_from`` over the data axes), so the loss and its
gradient are the one-card ones however the masks fall; ``forward`` gathers
the rows back (not differentiated).  With no grid, or nothing split (one
rank; or ``model`` = 1 without FSDP), the model is the one-card one.

The ``fsdp_activations`` lever (the reference pins the residual stream's
batch to ``model``, ``repro/models/model.py:94``): where the rows of a
forward's or loss's batch divide over the batch's axes and ``model``
(``_axes``), every rank takes its block of them over both, each leaf is
gathered whole at its use, embedding, head and MoE experts and the
hybrid's shared block alike (``layers.ModelAxis`` with ``model`` among its
``batch_axes``), the blocks compute as on one card on those rows, and the
cross-entropy's global count runs over every rank's rows; a layer's forward
then issues no all-reduce over ``model``, only its bucketed gathers (their
reduce-scatters backward).  Where the rows do not divide, nothing changes.
The other two levers act in the blocks (``models/blocks.py``,
``models/ssm.py``).  Serving takes no lever.

Serving under a grid (every decoder family).  A rank holds its blocks of
the weights and of the cache, as the reference's specs lay them out
(``launch.sharding.cache_tree_pspecs``: the rows over the data axes where
they split, the kv heads over ``model`` where they divide it, else the
slots where they do; an SSM state's N over ``model``, its conv window
whole; a hybrid model's shared caches by kv head).  ``prefill`` takes the
whole batch and keeps this rank's rows wherever ``batch_pspec`` splits
them, under every ``fed_mode``;
``init_cache`` makes this rank's block; ``decode_step`` takes this rank's
block of the cache and its rows of the tokens and positions (or the whole
batch, whose rows it keeps).  Each returns its rows' logits over the whole
vocabulary (the vocab-split head's blocks gathered over ``model``).  The
blocks compute tensor-parallel (``models/blocks.py``: each rank's heads, or
every head gathered and the cache split by slot, the softmax merged over
``model``).  A slot-split cache's block does not say how many slots the
whole cache has when ``model`` does not divide the block's: ``decode_step``
then needs ``cache_size``, which ``launch.serve`` and ``launch.steps`` pass.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.launch.mesh import copy_to, data_axes, gather_from, max_over, reduce_from
from repro_torch.models.blocks import (
    apply_block,
    decode_block,
    init_block,
    init_block_cache,
    prefill_block,
)
from repro_torch.models.config import ModelConfig, validate
from repro_torch.models.layers import ModelAxis, dense_init, rms_norm
from repro_torch.models.ssm import state_split
from repro_torch.utils.trees import tree_leaves, tree_structure


class Model(NamedTuple):
    config: ModelConfig
    init: Any           # (generator, device) -> params
    loss_fn: Any        # (params, batch) -> (loss, metrics)
    forward: Any        # (params, batch, use_window=False) -> logits (B, L, V) f32
    prefill: Any        # (params, batch, cache_size, use_window=False) -> (logits_last, cache)
    decode_step: Any    # (params, cache, tokens (B,), pos=None, ring=False) -> (logits, cache)
    init_cache: Any     # (batch, cache_size, dtype=None, device="cuda") -> cache
    grid: Any = None    # the grid whose axes split the leaves, if any
    fsdp: bool = False  # the leaves split over the grid's data axes too (FSDP)


def tree_apply(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts and
    tuples of tensors: parameters, caches), the same structure back."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_apply(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(tree_apply(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_paths(tree: dict, fn, prefix: str = "") -> dict:
    """``fn(path, leaf)`` over a dict of dicts of tensors, ``path`` the
    ``/``-joined keys after ``prefix``."""
    return {k: tree_paths(v, fn, f"{prefix}{k}/") if isinstance(v, dict) else fn(prefix + k, v)
            for k, v in tree.items()}


def layer(tree, i: int):
    """Entry ``i`` of a stacked tree (views, no copies)."""
    return tree_apply(lambda t: t[i], tree)


def stack_layers(trees: list) -> dict:
    """Per-layer trees -> one tree with a leading L axis on every leaf.  The
    leaves are popped out of ``trees`` as they are stacked, so only one
    leaf's layers are held twice (a model as large as the card's memory
    allows, e.g. olmoe-1b-7b in f32, is built without a second copy)."""
    first = trees[0]
    return {k: stack_layers([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t.pop(k) for t in trees]) for k in list(first)}


def hybrid_segments(cfg: ModelConfig):
    """(segments, layers a segment, tail layers): uniform segments of
    ``shared_attn_every`` layers, the shared block after each, and a
    trailing remainder with none after it."""
    every = cfg.shared_attn_every
    nseg, tail = divmod(cfg.num_layers, every)
    return nseg, every, tail


def build_model(cfg: ModelConfig, grid=None) -> Model:
    """The model of ``cfg``; under ``grid``, on this rank's blocks, the
    leaves split by the reference's specs, FSDP under ``cfg.fed_mode``
    ``scan`` and ``remat``, and the mesh levers ``cfg`` sets (see the
    module docstring)."""
    validate(cfg)
    L = cfg.num_layers
    is_hybrid = cfg.family == "hybrid" and cfg.shared_attn_every > 0
    attn_cfg = cfg.with_(family="dense") if is_hybrid else cfg  # the shared block
    if is_hybrid:
        nseg, every, tail = hybrid_segments(cfg)
        # (first layer, end, shared application point after it or None)
        segments = [(s * every, (s + 1) * every, s) for s in range(nseg)]
        segments += [(nseg * every, L, None)] if tail else []
    else:
        nseg, segments = 0, [(0, L, None)]

    def _device(device):
        device = torch.device(device)
        return device if device.type == "meta" else resolve_device(device)

    def _init(generator, device, cut) -> dict:
        """The parameters, each leaf passed through ``cut(path, leaf)`` as
        it is drawn."""
        params = {}
        if cfg.frontend == "none" or cfg.family == "vlm":
            params["embed"] = cut("embed", dense_init(
                generator, (cfg.vocab_size, cfg.d_model), cfg.pdtype, scale=0.02, device=device))
        if cfg.frontend != "none":
            params["frontend_proj"] = cut("frontend_proj", dense_init(
                generator, (cfg.frontend_dim, cfg.d_model), cfg.pdtype, device=device))
        params["layers"] = stack_layers([
            tree_paths(init_block(generator, cfg, device=device), cut, "layers/")
            for _ in range(L)])
        if is_hybrid:
            params["shared"] = tree_paths(init_block(generator, attn_cfg, device=device), cut,
                                          "shared/")
        params["final_norm"] = cut("final_norm", torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                                             device=device))
        params["head"] = cut("head", dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                                cfg.pdtype, scale=0.02, device=device))
        return params

    def _whole(path, leaf):
        return leaf

    tp = shared_tp = rows_tp = rows_shared = None
    fsdp = cfg.fed_mode in ("scan", "remat")
    if grid is not None and grid.devices > 1:
        from repro_torch.launch.sharding import shard_params_tree, take_shard, uses_axis

        specs = shard_params_tree(_init(None, torch.device("meta"), _whole), grid, fsdp=fsdp)
        specs = {"/".join(p): s for p, s in zip(tree_structure(specs), tree_leaves(specs))}
        daxes = data_axes(grid)
        batch_axes = daxes if fsdp and grid.size(daxes) > 1 else ()
        split = grid.shape.get("model", 1) > 1 and any(uses_axis(s, "model")
                                                        for s in specs.values())
        if split or batch_axes:
            tp = ModelAxis(grid, {path.removeprefix("layers/"):
                                  spec[1:] if path.startswith("layers/") else spec
                                  for path, spec in specs.items()
                                  if not path.startswith("shared/")}, batch_axes)
            if is_hybrid:   # the shared block's own placement
                shared_tp = ModelAxis(grid, {path.removeprefix("shared/"): spec
                                             for path, spec in specs.items()
                                             if path.startswith("shared/")}, batch_axes)
            if cfg.family in ("ssm", "hybrid"):
                state_split(cfg, tp)   # raises for a serving layout the port does not run
            if cfg.fsdp_activations and grid.shape.get("model", 1) > 1:
                # the rows over model too, every leaf gathered whole at its use
                rows_tp = tp._replace(batch_axes=batch_axes + ("model",))
                if shared_tp is not None:
                    rows_shared = shared_tp._replace(batch_axes=batch_axes + ("model",))

        def _block(path, leaf):
            # a layer's leaf is drawn alone: its stacked spec without the L axis
            spec = specs[path][1:] if path.startswith("layers/") else specs[path]
            return take_shard(leaf, spec, grid)

    def init(generator: torch.Generator | None, device="cuda") -> dict:
        """Random params on ``device`` (the card unless ``device="cpu"``;
        raises without CUDA), drawn from ``generator``, which must live on
        that device.  ``device="meta"`` gives the shapes and draws nothing.
        Under a grid: this rank's blocks of the same draws."""
        return _init(generator, _device(device), _whole if tp is None else _block)

    def _axes(batch):
        """(the layers' placement, the shared block's) that a forward or a
        loss of ``batch`` computes on: under ``fsdp_activations`` the rows
        split over ``model`` too where they divide over it (the
        reference's ``maybe_shard_axis(h, 0)``), else ``tp``."""
        if rows_tp is not None:
            b = next(iter(batch.values())).shape[0]
            if b % grid.size(rows_tp.batch_axes) == 0:
                return rows_tp, rows_shared
        return tp, shared_tp

    def _leaf(params, path, ax):
        """A model-level leaf as the forward uses it (FSDP's gather)."""
        return params[path] if ax is None else ax.use(path, params[path])

    def _rows(batch, ax):
        """This rank's rows of the batch where they split, else the batch."""
        if ax is None or not ax.batch_axes:
            return batch
        n = grid.size(ax.batch_axes)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not split over the data axes "
                             f"{ax.batch_axes} ({n} ranks): under FSDP each rank takes its block "
                             "of a client's rows")
        return {k: v[grid.block(b, ax.batch_axes)] for k, v in batch.items()}

    def _embed(params, tokens, ax):
        # F.embedding, not params["embed"][tokens]: its backward sums each
        # row's gradients in a fixed order, where the indexing backward's
        # float scatter-add on the CPU adds in parallel in no fixed order; a
        # client retrained from the same start must give the same bits
        if ax is not None and ax.has("embed"):
            table = _leaf(params, "embed", ax)
            rows = table.shape[0]
            local = tokens.long() - grid.index("model") * rows
            inside = (local >= 0) & (local < rows)
            e = F.embedding(local.clamp(0, rows - 1), table) * inside[..., None].to(table.dtype)
            return reduce_from(e, grid, "model").to(cfg.cdtype)
        return F.embedding(tokens.long(), _leaf(params, "embed", ax)).to(cfg.cdtype)

    def _frontend(params, embeds, ax):
        """Frames or patches (B, L, frontend_dim) through ``frontend_proj``:
        under a column split over ``model`` this rank's columns, gathered
        (the embeddings are data: no gradient to sum into them)."""
        out = embeds.to(cfg.cdtype) @ _leaf(params, "frontend_proj", ax)
        if ax is not None and ax.has("frontend_proj"):
            out = gather_from(out, grid, "model")
        return out.to(cfg.cdtype)

    def _embed_inputs(params, batch, ax):
        """The input sequence (B, L, d_model): token embeddings, projected
        frames (audio), or projected patches before the tokens (vlm)."""
        if cfg.family == "audio":
            return _frontend(params, batch["frame_embeds"], ax)
        h = _embed(params, batch["tokens"], ax)
        if cfg.family == "vlm":
            h = torch.cat([_frontend(params, batch["patch_embeds"], ax), h], dim=1)
        return h

    def _positions(h):
        b, l = h.shape[:2]
        return torch.arange(l, device=h.device).expand(b, l)

    def _hidden(params, batch, use_window, ax, shared_ax):
        """The final-normed hidden states and the layers' summed (lb, z),
        None for a model without a router."""
        h = _embed_inputs(params, batch, ax)
        positions = _positions(h)
        aux = None
        for lo, hi, shared in segments:
            for i in range(lo, hi):
                h, block_aux = apply_block(layer(params["layers"], i), cfg, h,
                                           positions=positions, use_window=use_window, tp=ax)
                if block_aux is not None:
                    aux = torch.stack(block_aux) if aux is None else aux + torch.stack(block_aux)
            if shared is not None:
                h, _ = apply_block(params["shared"], attn_cfg, h, positions=positions,
                                   use_window=use_window, tp=shared_ax)
        return rms_norm(h, _leaf(params, "final_norm", ax)), aux

    def _vocab_split(ax) -> bool:
        return ax is not None and ax.has("head")

    def _logits(params, h, ax):
        """(.., V) f32 logits, or this rank's block of the vocabulary."""
        if _vocab_split(ax):
            h = copy_to(h, grid, "model")
        return (h @ _leaf(params, "head", ax)).float()

    def forward(params, batch, use_window: bool = False) -> torch.Tensor:
        whole = next(iter(batch.values())).shape[0]
        ax, shared_ax = _axes(batch)
        h, _ = _hidden(params, _rows(batch, ax), use_window, ax, shared_ax)
        logits = _logits(params, h, ax)
        if _vocab_split(ax):
            logits = gather_from(logits, grid, "model")
        if ax is not None and ax.batch_axes:
            logits = grid.gather_rows(logits, whole, ax.batch_axes)
        return logits

    def _logz_gold(logits, labels):
        """log-sum-exp and the gold logit of vocab-split logits."""
        rows = logits.shape[-1]
        m = max_over(logits.detach().amax(-1), grid, "model")
        local = labels - grid.index("model") * rows
        inside = (local >= 0) & (local < rows)
        gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
        parts = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                             torch.where(inside, gold, 0.0)])
        total, gold = reduce_from(parts, grid, "model").unbind(0)
        return m + torch.log(total), gold

    def loss_fn(params, batch, use_window: bool = False):
        ax, shared_ax = _axes(batch)
        batch = _rows(batch, ax)
        with contextlib.nullcontext() if ax is None else ax.regathered():
            h, aux = _hidden(params, batch, use_window, ax, shared_ax)
            if cfg.family == "vlm":
                h = h[:, cfg.prefix_len:]  # the loss on the text tokens only
            logits = _logits(params, h, ax)
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
        if _vocab_split(ax):
            logz, gold = _logz_gold(logits, labels)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        total, count = torch.sum((logz - gold) * mask), torch.sum(mask)
        if ax is not None and ax.batch_axes:  # over every rank's rows
            total, count = reduce_from(torch.stack([total, count]), grid,
                                       ax.batch_axes).unbind(0)
        ce = total / torch.clamp(count, min=1.0)
        if aux is None:  # no router: the aux terms are zero
            zero = torch.zeros((), dtype=torch.float32, device=logits.device)
            return ce, {"ce": ce, "lb_loss": zero, "z_loss": zero}
        loss = ce + cfg.router_aux_weight * aux[0] + cfg.router_z_weight * aux[1]
        return loss, {"ce": ce, "lb_loss": aux[0], "z_loss": aux[1]}

    def _serve_axes(rows: int) -> tuple:
        """The data axes a serving batch of ``rows`` rows splits over
        (``batch_pspec``), or ``()``."""
        daxes = data_axes(grid) if tp is not None else ()
        n = grid.size(daxes) if daxes else 1
        return daxes if n > 1 and rows % n == 0 else ()

    def _serve_rows(x: torch.Tensor, held: int | None = None) -> torch.Tensor:
        """This rank's rows of ``x`` where they split (``held``: the rows a
        rank's cache holds, which ``x`` may already be)."""
        if held is not None and x.shape[0] == held:
            return x
        axes = _serve_axes(x.shape[0])
        out = x[grid.block(x.shape[0], axes)] if axes else x
        if held is not None and out.shape[0] != held:
            raise ValueError(f"{x.shape[0]} rows are neither this rank's {held} rows of the "
                             "cache nor the whole batch")
        return out

    def _slots(cache, cache_size):
        """The slot count of the whole attention cache whose block
        ``cache`` holds (see the module docstring); None for a model
        without one (an SSM's)."""
        kv = cache["shared"] if is_hybrid else cache["layers"]
        if isinstance(kv, dict):   # an SSM stack's {"state", "conv"}
            return None
        held = kv[0].shape[2]   # (L or nseg, B, S, Hkv, D)
        m = tp.size if tp is not None else 1
        by_slot = m > 1 and cfg.num_kv_heads % m != 0
        if cache_size is None:
            if not by_slot:
                return held
            if held % m:
                raise ValueError(
                    f"a cache block of {held} slots on a model axis of {m}: whole ({held} "
                    f"slots) or split ({held * m}); pass decode_step's cache_size")
            return held * m
        if cache_size != held and not (by_slot and cache_size == held * m):
            raise ValueError(f"a cache block of {held} slots is not a block of {cache_size}")
        return cache_size

    def init_cache(batch_size: int, cache_size: int, dtype=None, device="cuda") -> dict:
        """An empty cache on ``device`` (the card unless ``device="cpu"``);
        under a grid this rank's block of it."""
        if tp is None:
            return _init_cache(batch_size, cache_size, dtype, device)
        from repro_torch.launch.sharding import block_shape, cache_tree_pspecs

        whole = _init_cache(batch_size, cache_size, dtype, "meta")
        device = _device(device)
        return tree_apply(lambda t, spec: torch.zeros(block_shape(tuple(t.shape), spec, grid),
                                                      dtype=t.dtype, device=device),
                          whole, cache_tree_pspecs(whole, grid))

    def _init_cache(batch_size: int, cache_size: int, dtype, device) -> dict:
        device = _device(device)
        dtype = dtype or cfg.cdtype

        def stacked(c, n):
            return tree_apply(lambda t: t.expand(n, *t.shape).clone(), c)

        cache = {"layers": stacked(init_block_cache(cfg, batch_size, cache_size, dtype,
                                                    device=device), L),
                 "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}
        if is_hybrid:
            cache["shared"] = stacked(init_block_cache(attn_cfg, batch_size, cache_size, dtype,
                                                       device=device), nseg)
        return cache

    def prefill(params, batch, cache_size: int, use_window: bool = False):
        """The prompt (and a VLM's patches before it) through every layer ->
        (logits of its last position (B, V) f32, a new cache holding it).
        ``use_window`` takes the sliding window and the ring layout of
        ``cache_size`` slots for the attention layers.  Under a grid: this
        rank's rows of the whole ``batch``, their logits and this rank's
        block of the cache."""
        if tp is not None:
            batch = {k: _serve_rows(v) for k, v in batch.items()}
        h = _embed_inputs(params, batch, tp)
        positions = _positions(h)
        kw = dict(positions=positions, cache_size=cache_size, use_window=use_window)
        caches, shared_caches = [], []
        for lo, hi, shared in segments:
            for i in range(lo, hi):
                h, c = prefill_block(layer(params["layers"], i), cfg, h, tp=tp, **kw)
                caches.append(c)
            if shared is not None:
                h, c = prefill_block(params["shared"], attn_cfg, h, tp=shared_tp, **kw)
                shared_caches.append(c)
        b, l = h.shape[:2]
        cache = {"layers": tree_apply(lambda *ts: torch.stack(ts), *caches),
                 "pos": torch.full((b,), l, dtype=torch.int32, device=h.device)}
        if is_hybrid:
            cache["shared"] = tree_apply(lambda *ts: torch.stack(ts), *shared_caches)
        h = rms_norm(h, _leaf(params, "final_norm", tp))
        return _whole_logits(params, h[:, -1]), cache

    def _whole_logits(params, h):
        """(B, V) f32 logits of final-normed hidden states (B, d), the whole
        vocabulary on every rank."""
        logits = _logits(params, h, tp)
        return gather_from(logits, grid, "model") if _vocab_split(tp) else logits

    def decode_step(params, cache, tokens, pos=None, *, ring: bool = False,
                    cache_size: int | None = None):
        """tokens (B,) int at positions ``pos`` (default ``cache["pos"]``) ->
        (logits (B, V) f32, cache): the cache is written in place and its
        ``pos`` becomes ``pos + 1``.  ``ring`` applies to the attention
        layers' caches (a hybrid model's shared blocks).  Under a grid
        ``cache`` is this rank's block and ``cache_size`` the whole cache's
        slots (see the module docstring)."""
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        slots = None
        if tp is not None:
            held = cache["pos"].shape[0]
            tokens = _serve_rows(tokens, held)
            pos = None if pos is None else _serve_rows(pos, held)
            slots = _slots(cache, cache_size)
        pos = cache["pos"] if pos is None else pos
        h1 = _embed(params, tokens, tp)
        for lo, hi, shared in segments:
            for i in range(lo, hi):
                h1 = decode_block(layer(params["layers"], i), cfg, h1,
                                  layer(cache["layers"], i), pos, ring=ring, tp=tp, slots=slots)
            if shared is not None:
                h1 = decode_block(params["shared"], attn_cfg, h1, layer(cache["shared"], shared),
                                  pos, ring=ring, tp=shared_tp, slots=slots)
        cache["pos"].copy_(pos + 1)
        return _whole_logits(params, rms_norm(h1, _leaf(params, "final_norm", tp))), cache

    return Model(cfg, init, loss_fn, forward, prefill, decode_step, init_cache,
                 grid if tp is not None else None, tp is not None and fsdp)
