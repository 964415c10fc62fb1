"""Input specs for every (arch x input shape) combo on one card.

Counterpart of ``repro/launch/specs.py``: the same four production shapes
(``INPUT_SHAPES``), the same step kinds, argument order, skips and cache
sizes.  The reference builds ``jax.ShapeDtypeStruct`` stand-ins with mesh
shardings; here the arguments are tensors made on ``device``:

* ``device="meta"`` (the default) allocates nothing and draws nothing: the
  shapes and dtypes alone, for the dry run;
* a real device (``"cuda"``, or ``"cpu"`` for tests) makes real tensors:
  the weights through ``model.init`` with a ``torch.Generator`` seeded 0,
  the tokens and embeddings from one seeded 1, a cache's float leaves
  normals from seed 2, one generator for each (leaf, layer, row) slab
  (``cache_slab``), so that any block of rows, heads or slots is drawn
  alone; a decode step's ``pos`` is ``seq - 1``, every earlier position in
  the cache.

Where the reference takes a mesh, ``client_rows`` is the number of its
client rows (``num_client_rows(mesh)``, ``repro/launch/mesh.py``): one card
gives 1, as the reference's one-device mesh does, and other values stand
for the rows of a larger mesh (the clients of a ``vmap`` round).  A mesh
(``launch.mesh.MeshShape`` or ``GridMesh``) may be passed in its place; the
``meta`` then also records its axes, and ``arg_specs`` gives every
argument's spec on it, as the reference's ``input_specs`` annotates them
(``launch.sharding``), and ``rank_bytes`` the bytes one rank holds.

A model built on a grid (``build_model(cfg, grid=)``, a ``GridMesh``, or
a ``MeshShape`` placed by ``at`` on ``meta``) gives this rank's blocks:
its weights (``model.init``), its block of a cache (its rows over the data
axes, its kv heads or slots, or an SSM state's N, over ``model``:
``cache_tree_pspecs``), each
slab drawn alone so that no whole leaf is held (llama3-8b's stacked k leaf
at ``decode_32k`` is 68.7 GB), holding the values of the same rows of a
one-card cache of the same seed, and its rows of a decode step's tokens
and positions.  A prefill's batch stays whole: the model keeps its rows
(``models/model.py``); so does a training round's on a grid without a
client axis.  On a grid with one (``(client, data, model)``) a training
round's batch is this rank's ``batch_pspec`` block: its client row's K /
rows clients, each with its whole ``b`` (``fed.distributed``).
``client_rows`` is then the model's grid or its shape.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.reputation import ReputationState
from repro_torch.launch.mesh import client_axis, num_client_rows
from repro_torch.launch.sharding import (
    batch_pspec,
    block_start,
    cache_tree_pspecs,
    replicated,
    shard_bytes,
    shard_params_tree,
    take_shard,
)
from repro_torch.models.model import tree_apply

INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="long_decode", seq=524_288, global_batch=1),
}

LOCAL_STEPS = 4  # client SGD steps per federated round


@dataclasses.dataclass
class SpecBundle:
    step_kind: str          # train | prefill | decode | forward | skip
    args: tuple             # tensors in call order
    meta: dict              # bookkeeping for the dry run and the analytic model
    skip_reason: str | None = None


def _device(device) -> torch.device:
    device = torch.device(device)
    return device if device.type == "meta" else resolve_device(device)


def _generator(device: torch.device, seed: int):
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _ints(shape, high: int, gen, device) -> torch.Tensor:
    if gen is None:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int32, device=device)


def _normals(shape, dtype, gen, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    return out if gen is None else out.normal_(generator=gen)


def _token_batch(cfg, *, lead: tuple, seq: int, gen, device) -> dict:
    """Tokens and labels (and a frontend's embeddings) of leading dims
    ``lead`` + (seq,), as the reference's ``_token_batch_specs``."""
    shp = lead + (seq,)
    out = {"tokens": _ints(shp, cfg.vocab_size, gen, device),
           "labels": _ints(shp, cfg.vocab_size, gen, device)}
    if cfg.family == "vlm":
        out["patch_embeds"] = _normals(lead + (cfg.prefix_len, cfg.frontend_dim), cfg.cdtype,
                                       gen, device)
    if cfg.family == "audio":
        out = {"frame_embeds": _normals(shp + (cfg.frontend_dim,), cfg.cdtype, gen, device),
               "labels": out["labels"]}
    return out


def client_row_count(client_rows) -> int:
    """``client_rows`` as a number: an int, or a mesh's client rows."""
    return client_rows if isinstance(client_rows, int) else num_client_rows(client_rows)


def fed_client_count(cfg, client_rows=1) -> int:
    return client_row_count(client_rows) if cfg.fed_mode == "vmap" else cfg.fed_clients


def param_specs(model, *, device="meta", seed: int = 0):
    """The model's parameters on ``device``, drawn from ``seed`` on a real
    one."""
    dev = _device(device)
    return model.init(_generator(dev, seed), dev)


def reputation_specs(K: int, device="meta") -> ReputationState:
    """The prior Beta(3, 3) of ``init_reputation`` for K clients, none
    blocked."""
    dev = _device(device)
    return ReputationState(
        alpha=torch.full((K,), 3.0, dtype=torch.float32, device=dev),
        beta=torch.full((K,), 3.0, dtype=torch.float32, device=dev),
        blocked=torch.zeros((K,), dtype=torch.bool, device=dev),
    )


def _slab_seed(seed: int, leaf: int, layer: int, row: int) -> int:
    """The seed of one (leaf, layer, row) slab of a seeded cache."""
    return (((seed * 1_000_003 + leaf) * 1_000_003 + layer) * 1_000_003 + row) % (1 << 63)


def cache_slab(shape: tuple, dtype, device, *, seed: int, leaf: int, layer: int,
               row: int) -> torch.Tensor:
    """Row ``row`` of layer ``layer`` of the ``leaf``-th float leaf of a
    seeded cache: normals of ``shape`` (the leaf's dims after its row) from
    their own generator."""
    gen = _generator(device, _slab_seed(seed, leaf, layer, row))
    return torch.empty(shape, dtype=dtype, device=device).normal_(generator=gen)


def _float_leaves(tree, path=()):
    """(path, leaf) of a cache tree's float leaves, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _float_leaves(v, path + (i,))
    elif tree.is_floating_point():
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def cache_specs(model, batch: int, cache_size: int, *, device="meta", seed: int = 2) -> dict:
    """``model.init_cache`` on ``device``; on a real device every float
    leaf (stacked: layer, row, ...) is filled with ``cache_slab``'s normals
    of ``seed``.  On a grid model: this rank's block, each slab drawn whole
    and cut to the block alone."""
    dev = _device(device)
    cache = model.init_cache(batch, cache_size, model.config.cdtype, device=dev)
    grid = model.grid
    if dev.type == "meta":
        return cache
    if grid is not None:
        from repro_torch.models import build_model

        whole = build_model(model.config).init_cache(batch, cache_size, model.config.cdtype,
                                                     device="meta")
        specs = cache_tree_pspecs(whole, grid)
    for n, (path, block) in enumerate(_float_leaves(cache)):
        full = tuple(block.shape) if grid is None else tuple(_at(whole, path).shape)
        spec = () if grid is None else _at(specs, path)
        # this rank's rows, and its slice of each later dim a spec splits
        r0 = 0 if grid is None else block_start(1, full, spec, grid)
        cut = tuple(slice(None) if grid is None else
                    slice(block_start(d, full, spec, grid),
                          block_start(d, full, spec, grid) + block.shape[d])
                    for d in range(2, len(full)))
        for layer in range(block.shape[0]):
            for r in range(block.shape[1]):
                block[layer, r].copy_(cache_slab(full[2:], block.dtype, dev, seed=seed, leaf=n,
                                                 layer=layer, row=r0 + r)[cut])
    return cache


def input_specs(model, shape_name: str, client_rows=1, *, local_steps: int | None = None,
                device="meta", global_batch: int | None = None) -> SpecBundle:
    """The full argument list of the step this (arch, shape) runs.
    ``global_batch`` cuts the shape's batch to what one card holds (the
    ``meta`` records the cut value).  ``client_rows``: an int or a mesh."""
    cfg = model.config
    steps_per_round = local_steps or LOCAL_STEPS
    info = INPUT_SHAPES[shape_name]
    seq, gb = info["seq"], global_batch or info["global_batch"]
    kind = info["kind"]

    if cfg.is_encoder and kind in ("decode", "long_decode"):
        return SpecBundle(
            step_kind="skip", args=(), meta={},
            skip_reason=f"{cfg.name} is encoder-only: no decode step (DESIGN.md)",
        )

    if model.grid is not None and (isinstance(client_rows, int)
                                   or dict(client_rows.shape) != dict(model.grid.shape)):
        raise ValueError(f"{cfg.name} is built on a grid of {dict(model.grid.shape)}: pass "
                         "that grid in place of client_rows")
    meta = dict(arch=cfg.name, shape=shape_name, seq=seq, global_batch=gb,
                client_rows=client_row_count(client_rows))
    if not isinstance(client_rows, int):
        meta["mesh"] = dict(client_rows.shape)
    if kind == "long_decode" and cfg.family != "ssm" and not cfg.sliding_window:
        return SpecBundle(
            "skip", (), meta,
            skip_reason=f"{cfg.name}: full attention at 500k is quadratic; "
            "no sliding-window variant configured (DESIGN.md)",
        )

    dev = _device(device)
    params = param_specs(model, device=dev, seed=0)
    gen = _generator(dev, 1)

    if kind == "train":
        K = fed_client_count(cfg, client_rows)
        b = max(gb // K, 1) if cfg.fed_mode == "vmap" else gb
        batch = _token_batch(cfg, lead=(K, steps_per_round, b), seq=seq, gen=gen, device=dev)
        if model.grid is not None and client_axis(model.grid) is not None:
            # this rank's client row's clients (batch_pspec's block)
            batch = {k: take_shard(v, batch_pspec(tuple(v.shape), model.grid, client_axis=True,
                                                  per_client_batch=True), model.grid)
                     for k, v in batch.items()}
        rep = reputation_specs(K, dev)
        n_k = torch.ones((K,), dtype=torch.float32, device=dev)
        meta.update(num_clients=K, local_steps=steps_per_round, per_client_batch=b,
                    fed_mode=cfg.fed_mode)
        return SpecBundle("train", (params, rep, n_k, batch), meta)

    if kind == "prefill":
        batch = _token_batch(cfg, lead=(gb,), seq=seq, gen=gen, device=dev)
        if cfg.is_encoder:
            return SpecBundle("forward", (params, batch), meta)
        # VLM prefill also caches the image-prefix positions
        meta.update(cache_size=seq + (cfg.prefix_len if cfg.family == "vlm" else 0))
        return SpecBundle("prefill", (params, batch), meta)

    # decode kinds
    if kind == "long_decode":
        # an SSM's cache ignores the sequence length
        cache_size, ring = (1, False) if cfg.family == "ssm" else (cfg.sliding_window, True)
    else:
        cache_size, ring = seq, False
    cache = cache_specs(model, gb, cache_size, device=dev, seed=2)
    tokens = _ints((gb,), cfg.vocab_size, gen, dev)
    rows = cache["pos"].shape[0]
    if rows != gb:   # a grid model: this rank's rows of the tokens
        tokens = take_shard(tokens, batch_pspec((gb,), model.grid, client_axis=False,
                                                per_client_batch=False), model.grid)
    pos = torch.full((rows,), seq - 1, dtype=torch.int32, device=dev)
    cache["pos"].copy_(pos)
    meta.update(cache_size=cache_size, ring=ring)
    return SpecBundle("decode", (params, cache, tokens, pos), meta)


def arg_specs(cfg, bundle: SpecBundle, mesh) -> tuple:
    """The spec of every argument of ``bundle`` on ``mesh``, as the
    reference's ``input_specs`` shards them: the parameters by
    ``shard_params_tree`` (FSDP under ``scan`` and ``remat``), a federated
    batch's client dim over the client rows, a plain batch and the tokens
    over the data axes, a cache by ``cache_pspec`` (its ``pos`` as a plain
    batch), the reputation and ``n_k`` replicated."""
    def batch(tree, client):
        return tree_apply(lambda t: batch_pspec(tuple(t.shape), mesh, client_axis=client,
                                                per_client_batch=True), tree)

    if bundle.step_kind == "skip":
        return ()
    params = shard_params_tree(bundle.args[0], mesh, fsdp=cfg.fed_mode in ("scan", "remat"))
    if bundle.step_kind == "train":
        _, rep, n_k, fed = bundle.args
        return (params, tuple(replicated(mesh) for _ in rep), replicated(mesh),
                batch(fed, True))
    if bundle.step_kind in ("prefill", "forward"):
        return params, batch(bundle.args[1], False)
    _, cache, tokens, pos = bundle.args
    return params, cache_tree_pspecs(cache, mesh), batch(tokens, False), batch(pos, False)


def rank_bytes(tree, specs, mesh) -> int:
    """The bytes one rank of ``mesh`` holds of ``tree`` under ``specs``
    (a tree of the same structure)."""
    if isinstance(tree, torch.Tensor):
        return shard_bytes(tuple(tree.shape), tree.element_size(), specs, mesh)
    if isinstance(tree, dict):
        return sum(rank_bytes(v, specs[k], mesh) for k, v in tree.items())
    return sum(rank_bytes(v, s, mesh) for v, s in zip(tree, specs))
