"""Sharding rules: tree path -> PartitionSpec, rule for rule the
reference's (``repro/launch/sharding.py``).

Parameter rules (name-based, applied per leaf):
  * vocab / head / embedding rows    -> *model*
  * attention q/k/v out-features     -> *model*   (head-sharded)
  * attention o in-features          -> *model*
  * MLP ff dim (gate/up out, down in)-> *model*
  * MoE expert dim                   -> *model*   (expert parallelism)
  * mamba in/out projection features -> *model*
  * 1-D params (norms, biases, A_log)-> replicated
  * vmap-mode stacked client axis    -> client rows = the dedicated
    'client' axis when the mesh has one, else ('pod','data')
    (``client_row_axes``)
  * FSDP (scan/remat modes): the largest remaining unsharded dim
    additionally -> ('pod','data')

Cache rules (``cache_pspec``, ``cache_tree_pspecs``): a serving cache's
stacked leaves (L or nseg, B, ...) split their batch over the data axes,
and their last-but-one dim over *model* where it divides it, else dim 2
where that does: an attention cache's kv heads, else its slots; an SSM
state's (L, B, H, N, P) N, else its heads; an SSM conv window's (L, B, cw
- 1, D) rows where *model* divides cw - 1, else nothing (cw - 1 = 3 at
model 2 or 4: whole); its ``pos`` is a plain batch.
``block_shape`` and ``block_start`` give a rank's block of a leaf.

A dim is only sharded if its size divides the mesh-axis size; otherwise it
is replicated.

A spec is a tuple with one entry a dim: ``None`` (replicated), an axis name,
or a tuple of names (the dim split over their product, the first axis
major); a one-name tuple is written as the name, and ``()`` is the
replicated spec, as ``jax.sharding.PartitionSpec`` stores them.  A mesh is
anything with ``axis_names`` and ``shape`` (``launch.mesh.MeshShape``, a
``GridMesh``); ``shard_tree`` and ``unshard_tree`` need this rank's
coordinate, and ``unshard_tree`` a ``GridMesh``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import client_row_axes, data_axes


def P(*entries) -> tuple:
    """A spec, normalized as ``PartitionSpec`` stores it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _divisible(dim: int, mesh, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


# model-axis dim index per param name (AFTER stripping leading stack axes):
# name fragment -> which dim gets the *model* axis
_MODEL_DIM_RULES = [
    ("embed", 0),        # (V, d): shard vocab
    ("head", 1),         # (d, V): shard vocab
    ("frontend_proj", 1),
    ("wq", 1), ("wk", 1), ("wv", 1),   # (d, H*hd): shard heads
    ("wo", 0),                         # (H*hd, d)
    ("moe/gate", 0), ("moe/up", 0), ("moe/down", 0), ("router", None),
    ("gate", 1), ("up", 1),            # (d, ff)
    ("down", 0),                       # (ff, d)
    ("in_proj", 1),                    # (d, 2di+2n+h)
    ("out_proj", 0),                   # (di, d)
    ("conv_w", 1), ("conv_b", None),
    ("A_log", None), ("dt_bias", None), ("D", None),
]


def _model_dim_for(pstr: str):
    for frag, dim in _MODEL_DIM_RULES:
        if "/" in frag:
            if frag in pstr:
                return dim, frag
        elif pstr.endswith("/" + frag) or pstr == frag or pstr.endswith(frag):
            return dim, frag
    return None, None


def param_pspec(pstr: str, shape: tuple, mesh, *, num_stack_axes: int = 0,
                client_axis: bool = False, fsdp: bool = False) -> tuple:
    """The spec of one parameter leaf at path ``pstr`` (``"/"``-joined).

    num_stack_axes: leading axes added by layer-stacking (1 for the layer
    stack, 0 for shared/unstacked params).  client_axis: an additional
    leading client axis (vmap fed mode) sharded over the mesh's client rows.
    """
    daxes = data_axes(mesh)
    caxes = client_row_axes(mesh)
    spec: list = [None] * len(shape)
    off = 0
    if client_axis:
        if caxes and _divisible(shape[0], mesh, caxes):
            spec[0] = caxes
        off += 1
    off += num_stack_axes  # layer-stack axes stay unsharded

    body = shape[off:]
    is_moe = "moe/" in pstr
    mdim, _ = _model_dim_for(pstr)
    if is_moe and pstr.split("/")[-1] in ("gate", "up", "down"):
        mdim = 0  # expert dim leads the body for stacked moe weights
    # when clients live on their own dedicated axis the data axes stay free
    # for FSDP; the legacy clients-on-data-rows mapping consumes them
    used_data = client_axis and caxes == daxes
    if mdim is not None and len(body) > mdim and body[mdim] >= 2:
        if _divisible(body[mdim], mesh, "model"):
            spec[off + mdim] = "model"
    if fsdp and not used_data and len(body) >= 2:
        # shard the largest remaining dim over the data axes
        cands = [(body[i], i) for i in range(len(body)) if spec[off + i] is None]
        cands.sort(reverse=True)
        for size, i in cands:
            if size >= 2 and _divisible(size, mesh, daxes):
                spec[off + i] = daxes
                break
    return P(*spec)


def _walk(tree, fn, path=()):
    """``fn(pstr, leaf)`` over a tree of dicts and tuples, the tree back."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def shard_params_tree(shapes_tree, mesh, *, client_axis: bool = False,
                      fsdp: bool = False) -> dict:
    """A parameter tree (tensors, meta tensors or shapes) -> the tree of its
    leaves' specs.  ``layers/...`` leaves have one leading stack axis (the
    L axis); ``shared/...`` (hybrid) has none.  The client axis, when
    present, was prepended by the caller to every leaf."""

    def one(pstr, leaf):
        n_stack = 1 if pstr.startswith("layers/") else 0
        return param_pspec(pstr, _shape(leaf), mesh, num_stack_axes=n_stack,
                           client_axis=client_axis, fsdp=fsdp)

    return _walk(shapes_tree, one)


def batch_pspec(shape: tuple, mesh, *, client_axis: bool, per_client_batch: bool) -> tuple:
    """Fed batch leaves (K, S, b, ...) or plain batch (B, ...).  The leading
    client dim shards over the mesh's client rows (dedicated 'client' axis
    when present, else data axes); a plain batch shards over data axes."""
    del per_client_batch
    daxes = data_axes(mesh)
    spec: list = [None] * len(shape)
    if client_axis:
        caxes = client_row_axes(mesh)
        if caxes and _divisible(shape[0], mesh, caxes):
            spec[0] = caxes
    elif shape and daxes and _divisible(shape[0], mesh, daxes):
        spec[0] = daxes
    return P(*spec)


def cache_pspec(shape: tuple, mesh, *, batch_dim: int = 1) -> tuple:
    """KV/SSM cache leaves: (L, B, ...) stacked or (B, ...) unstacked.
    Shard batch over data axes; shard the last-but-one dim over model when
    divisible, else dim 2 (see the module docstring)."""
    daxes = data_axes(mesh)
    spec: list = [None] * len(shape)
    if (len(shape) > batch_dim and _divisible(shape[batch_dim], mesh, daxes)
            and shape[batch_dim] > 1):
        spec[batch_dim] = daxes
    # a model-sharding on the last-but-one dim (kv heads for attention
    # caches (L,B,S,H,hd); the state dim N for ssm (L,B,h,n,p): dim 3),
    # else dim 2 (the slots; the ssm heads)
    for cand in (len(shape) - 2, 2):
        if 0 <= cand < len(shape) and spec[cand] is None and cand != batch_dim:
            if shape[cand] >= 2 and _divisible(shape[cand], mesh, "model"):
                spec[cand] = "model"
                break
    return P(*spec)


def cache_tree_pspecs(cache: dict, mesh) -> dict:
    """The spec of every leaf of a serving cache (``model.init_cache``'s
    tree, whole shapes): its ``pos`` as a plain batch (``batch_pspec``), the
    stacked leaves (L or nseg, B, ...) by ``cache_pspec``, the batch at dim
    1, as the reference's ``cache_specs`` lays them out."""
    def one(pstr, leaf):
        if pstr == "pos":
            return batch_pspec(_shape(leaf), mesh, client_axis=False, per_client_batch=False)
        return cache_pspec(_shape(leaf), mesh, batch_dim=1)

    return _walk(cache, one)


def block_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n if e is None else n // _axis_size(mesh, e) for n, e in zip(shape, spec))


def block_start(dim: int, shape: tuple, spec: tuple, mesh) -> int:
    """Where this rank's block of dim ``dim`` starts (``mesh.coords``
    placing the rank): 0 where the spec does not split it."""
    e = spec[dim] if dim < len(spec) else None
    return 0 if e is None else mesh.index(e) * (shape[dim] // _axis_size(mesh, e))


def replicated(mesh) -> tuple:
    """The replicated spec."""
    del mesh
    return P()


def uses_axis(spec: tuple, axis: str) -> bool:
    """Whether any dim of ``spec`` is split over ``axis``."""
    return any(e == axis or (isinstance(e, tuple) and axis in e) for e in spec)


def shard_bytes(shape: tuple, itemsize: int, spec: tuple, mesh) -> int:
    """The bytes one rank holds of a leaf of ``shape`` under ``spec``."""
    n = math.prod(shape)
    for e in spec:
        if e is not None:
            n //= _axis_size(mesh, e)
    return n * itemsize


def take_shard(leaf: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec`` (``mesh.coords``
    placing the rank): a copy, so the whole leaf can be freed; a leaf the
    spec does not split comes back as it is."""
    out = leaf
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n = _axis_size(mesh, e)
        if leaf.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not split over {e} ({n})")
        w = leaf.shape[dim] // n
        out = out.narrow(dim, mesh.index(e) * w, w)
    return out if out is leaf else out.clone()


def shard_tree(tree, mesh, specs=None):
    """This rank's block of every leaf (``take_shard``); ``specs`` default
    to the tree's parameter specs (``shard_params_tree``); a serving cache
    takes ``cache_tree_pspecs``."""
    specs = shard_params_tree(tree, mesh) if specs is None else specs
    return _map2(tree, specs, lambda leaf, spec: take_shard(leaf, spec, mesh))


def unshard_tree(tree, mesh, specs):
    """Every leaf whole again, on every rank: each split dim gathered over
    its axes (sums of zero-padded blocks: exact).  ``mesh`` is a
    ``GridMesh``."""
    def one(leaf, spec):
        for dim, e in enumerate(spec):
            if e is not None:
                leaf = mesh._gather(leaf, e, dim)
        return leaf

    return _map2(tree, specs, one)


def _map2(tree, specs, fn):
    """``fn(leaf, spec)`` over a tree and its spec tree (dicts and tuples
    of tensors; a spec is a tuple of entries, a node of the tree a tuple of
    subtrees)."""
    if isinstance(tree, dict):
        return {k: _map2(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map2(v, s, fn) for v, s in zip(tree, specs))
    return fn(tree, specs)
