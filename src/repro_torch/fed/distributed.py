"""Federated round of whole-model proposals: the one-card modes, and the
vmap round on a data x model grid.

Counterpart of ``repro/fed/distributed.py``'s ``make_fed_round`` and
``compact_fed_batch``.  ``make_fed_round(model, cfg)`` returns
``fed_round(params, rep, n_k, batch) -> (params', rep', metrics)``: the K
clients each run S local SGD steps from ``params`` on their rows of
``batch`` (leaves ``(K, S, b, ...)``), AFA screens the K proposals, and the
Beta reputation absorbs the outcome.  Three client-memory modes
(``cfg.mode``):

* ``vmap``: the K clients train together.  The loss is ``torch.func.vmap``
  of ``model.loss_fn`` over the stacked parameters and the batches; the sum
  of the K losses is backpropagated, which gives each row exactly its own
  gradient.  Then AFA's tree form (``core.afa.afa_aggregate_tree``) on the
  K proposals held at once.
* ``scan``: the clients train one at a time and a blocked client does not
  train (its stored proposal is ``w_t``, which every masked aggregate
  ignores).  Proposals are stored in ``cfg.proposal_dtype``, or as ``int8``
  deltas ``w_k - w_t`` with one symmetric scale a client and leaf.
* ``remat``: no proposal is stored.  Three streaming passes retrain every
  client (blocked ones too, with weight 0): the plain weighted aggregate and
  each client's norm, then the dots, one screening pass of Algorithm 1 at
  ``xi0``, then the masked weighted sum.

Every mode runs eagerly: AFA's stopping loop reads one bool from the host a
pass, ``scan`` reads the blocked bits, and the reputation update tests
``betainc`` on the host.

On a grid (``make_fed_round(model, cfg, grid=)``, a
``launch.mesh.GridMesh``), the model built over the same grid
(``build_model(cfg, grid=grid)``), each rank holds the parameters' blocks
that ``launch.sharding.shard_params_tree`` gives it and AFA's tree form runs
on the grid (``core.afa.TreeShards``); the round returns the aggregate as
this rank's blocks, and the reputation and metrics whole.  ``n_k`` and
``rep`` are whole.  A grid of one rank runs the one-card round.

* ``vmap``: the K clients ride the grid's client rows, ``cfg.client_axes``
  (the reference's ``spmd_axis_name``; by default, and necessarily,
  ``client_row_axes(grid)``: the client axis when the grid has one, else
  the data axes), K / rows a row; a rank holds its row's clients' batches
  ``(K / rows, S, b, ...)``.  Its clients train under ``torch.func.vmap``
  as on one card, the model's collectives over ``model`` inside the loss;
  each optimizer step runs a leaf at a time, dropping a leaf's gradient and
  old values once its new ones exist, since a rank's clients fill its card.
  On a grid with a client axis the data ranks of a client row hold the same
  clients with the whole ``b`` (the reference's specs split neither ``b``
  nor the leaves over ``data`` there), so they train alike.
* ``scan`` and ``remat``: FSDP, as the reference's specs choose for them
  (``fsdp=True``: the largest dim no other rule splits goes over the data
  axes; the model built from a config of that mode).  On a grid without a
  client axis the clients train one at a time over the whole grid: every
  rank is given the whole batch ``(K, S, b, ...)``.  On a grid with one
  (``(client, data, model)``) K rides the client rows, as the reference's
  train batch spec puts it (``batch_pspec``): a rank is given its row's
  clients ``(K / rows, S, b, ...)``, and each row trains its clients one at
  a time over its own data and model ranks.  Either way the model keeps its
  block of each client's ``b`` rows over the data axes, gathering each
  leaf's data-split dim at its use (``models/layers.py``), a step a leaf at
  a time.  A blocked client still skips its local SGD under ``scan`` (every
  rank reads the same blocked bits).  ``scan``'s store holds this rank's
  blocks of its row's proposals (the reference's "sharded over the full
  mesh"); its int8 scale is the whole leaf's ``max|w_k - w_t| / 127``, the
  blocks' maxima taken over the leaf's axes (one all-reduce a group of
  axes) before the blocks are quantized, and AFA reads the store a client
  at a time (``core.afa.Dequantized``), summing over the client rows.
  ``remat`` keeps its three passes and single screening pass; its norms,
  dots and float32 accumulators are over this rank's blocks, the scalars
  summed over each leaf's axes, the accumulators summed over the client
  rows and the norms and dots gathered over them, so that every rank
  screens the same K scalars.

A model whose config sets one of the reference's mesh levers
(``activation_sharding``, ``seq_par_attention``, ``fsdp_activations``)
runs it inside its loss on the grid's ``model`` axis, under every mode
(``models/model.py``); the round is otherwise the same, its specs and AFA's
collectives too.

Without a grid, ``client_axes`` has no effect, as the reference's names
none on one device.  Under ``scan`` with int8 storage the metrics also
hold each leaf's K scales (``"scales"``, by leaf path).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.afa import (
    EPS,
    AFAConfig,
    Dequantized,
    TreeShards,
    _leaf_sums,
    _mark_bad,
    _weights,
    afa_aggregate_tree,
)
from repro_torch.core.reputation import (
    ReputationState,
    gather_reputation,
    p_good,
    update_reputation,
)
from repro_torch.models.config import torch_dtype
from repro_torch.optim import OptState, sgd_momentum
from repro_torch.utils.trees import tree_dot, tree_leaves, tree_map, tree_structure, tree_unflatten


class FedRoundConfig(NamedTuple):
    num_clients: int
    local_steps: int = 4
    lr: float = 0.02
    momentum: float = 0.9
    afa: AFAConfig = AFAConfig()
    mode: str = "vmap"  # vmap | scan | remat
    proposal_dtype: str = "bfloat16"  # storage dtype in scan mode, or "int8"
    delta_block: float = 0.95
    microbatch: int = 1  # gradient-accumulation chunks per local step
    client_axes: tuple | None = None  # the grid axes the clients ride (vmap on a grid)


def _flat(tree) -> dict:
    """Leaf path -> leaf, in leaf order."""
    return dict(zip(tree_structure(tree), tree_leaves(tree)))


def _grads(loss, p: dict, mb: dict, axis: int, microbatch: int) -> dict:
    """The gradient of ``loss(tree, mb)`` at the flat parameters ``p``.  With
    ``microbatch`` M > 1 the minibatch's batch axis (``axis``) is cut into M
    chunks of consecutive rows, their float32 gradients summed, divided by M
    and cast to each parameter's dtype."""
    treedef = tuple(p)

    def grad_of(chunk):
        leaves = [p[path].detach().requires_grad_(True) for path in treedef]
        with torch.enable_grad():
            value = loss(tree_unflatten(treedef, leaves), chunk)
            return torch.autograd.grad(value, leaves)

    if microbatch <= 1:
        return dict(zip(treedef, grad_of(mb)))
    total = None
    for m in range(microbatch):
        chunk = {k: v.unflatten(axis, (microbatch, -1)).select(axis, m) for k, v in mb.items()}
        g = [gi.float() for gi in grad_of(chunk)]
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return {path: (t / microbatch).to(p[path].dtype) for path, t in zip(treedef, total)}


def _step_leafwise(opt, grads: dict, state: OptState, p: dict):
    """One optimizer step a leaf at a time: each leaf's gradient and old
    state are dropped once its new state exists, and its old value once its
    new one does (``grads``, ``state`` and ``p`` are emptied)."""
    new_p, mu, nu = {}, {}, None if state.nu is None else {}
    for path in list(p):
        one = OptState(state.step, {path: state.mu.pop(path)},
                       None if nu is None else {path: state.nu.pop(path)})
        upd, one = opt.update({path: grads.pop(path)}, one, {path: p[path]})
        w = p.pop(path)
        new_p[path] = w + upd.pop(path).to(w.dtype)
        del w
        mu[path] = one.mu[path]
        if nu is not None:
            nu[path] = one.nu[path]
    return new_p, OptState(state.step + 1, mu, nu)


def _train(loss, opt, p: dict, batches: dict, *, axis: int, microbatch: int,
           leafwise: bool = False) -> dict:
    """Local SGD from the flat parameters ``p``: one step for each entry of
    the batches' step axis ``axis`` (0 for one client's ``(S, b, ...)``, 1
    for K clients' ``(K, S, b, ...)``).  ``p`` is not written.
    ``leafwise``: each step a leaf at a time (``_step_leafwise``)."""
    state = opt.init(p)
    steps = next(iter(batches.values())).shape[axis]
    for t in range(steps):
        mb = {k: v.select(axis, t) for k, v in batches.items()}
        if leafwise:  # from the second step on, p is this call's own dict to empty
            p, state = _step_leafwise(opt, _grads(loss, p, mb, axis, microbatch), state,
                                      p if t else dict(p))
            continue
        upd, state = opt.update(_grads(loss, p, mb, axis, microbatch), state, p)
        p = {path: p[path] + upd[path].to(p[path].dtype) for path in p}
    return p


def _client_train(loss_fn, opt, params, cbatch, *, microbatch: int = 1,
                  leafwise: bool = False):
    """One client's local SGD: ``cbatch`` leaves ``(S, b, ...)``; returns the
    proposed tree."""
    p = _train(lambda q, mb: loss_fn(q, mb)[0], opt, _flat(params), cbatch, axis=0,
               microbatch=microbatch, leafwise=leafwise)
    return tree_unflatten(tree_structure(params), list(p.values()))


def _clients_train(loss_fn, opt, params, batch, *, microbatch: int = 1,
                   leafwise: bool = False):
    """The K clients' local SGD at once: ``batch`` leaves ``(K, S, b, ...)``;
    returns the stacked proposals, every leaf ``(K, ...)``."""
    K = next(iter(batch.values())).shape[0]
    losses = torch.func.vmap(lambda q, mb: loss_fn(q, mb)[0])
    stacked = {path: l.unsqueeze(0).expand((K,) + tuple(l.shape))
               for path, l in _flat(params).items()}
    p = _train(lambda q, mb: losses(q, mb).sum(), opt, stacked, batch, axis=1,
               microbatch=microbatch, leafwise=leafwise)
    return tree_unflatten(tree_structure(params), list(p.values()))


def client_train_calls(mode: str, num_clients: int) -> int:
    """The client-training calls one round of ``mode`` makes with no client
    blocked: ``vmap`` one ``_clients_train`` over the K clients, ``scan`` one
    ``_client_train`` a client, ``remat`` one a client in each of its three
    passes.  Each call runs the round's S local steps."""
    calls = {"vmap": 1, "scan": num_clients, "remat": 3 * num_clients}
    if mode not in calls:
        raise ValueError(f"unknown fed mode {mode}")
    return calls[mode]


def _metrics(good_mask, rounds, similarities) -> dict:
    return {"good_frac": good_mask.float().mean(), "afa_rounds": rounds,
            "similarities": similarities}


def _quantize(prop: dict, w: dict, shards: TreeShards | None = None) -> dict:
    """int8 storage of each leaf's delta ``prop - w``: ``(q, scale)``, one
    symmetric scale ``max|d| / 127`` a leaf, rounded half to even and
    clipped to +-127.  On a grid the max is the whole leaf's: the blocks'
    maxima taken over each leaf's axes (``shards.split``), one all-reduce a
    group of axes."""
    top = {path: (prop[path].float() - w[path].float()).abs().max() for path in prop}
    if shards is not None:
        paths = list(prop)
        for axes in sorted(set(shards.split) - {()}):
            these = [path for path, a in zip(paths, shards.split) if a == axes]
            top.update(zip(these, shards.grid.pmax(torch.stack([top[p] for p in these]), axes)))
    out = {}
    for path in prop:
        d = prop[path].float() - w[path].float()
        s = torch.clamp(top[path], min=EPS) / 127.0
        out[path] = torch.clamp(torch.round(d / s), -127, 127).to(torch.int8), s
    return out


def _leaf_axes(spec: tuple, grid) -> tuple:
    """The axes a leaf's spec splits it over, in the grid's order."""
    used = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
    return tuple(a for a in grid.axis_names if a in used)


def _grid_shards(model, cfg: FedRoundConfig, grid) -> TreeShards | None:
    """The round's place on ``grid`` (None: the one-card round); raises
    for what the grid round does not run."""
    if grid is None or grid.devices == 1:
        return None
    from repro_torch.launch.mesh import client_axis, client_row_axes
    from repro_torch.launch.sharding import shard_params_tree
    from repro_torch.models import build_model

    fsdp = cfg.mode in ("scan", "remat")
    built = getattr(model, "grid", None) is grid
    if fsdp:
        # K over the grid's own client axis, else every rank trains all K
        rows = () if client_axis(grid) is None else (client_axis(grid),)
        if cfg.client_axes is not None and tuple(cfg.client_axes) != rows:
            raise ValueError(f"client_axes={cfg.client_axes}: a {cfg.mode} round on a grid of "
                             f"{dict(grid.shape)} trains its clients one at a time over "
                             + (f"its client rows {rows}" if rows else "the whole grid"))
        if not (built and model.fsdp):
            raise ValueError(f"a {cfg.mode} round on a grid of {dict(grid.shape)} needs the "
                             "model built over it with FSDP: build_model(cfg.with_(fed_mode="
                             f"{cfg.mode!r}), grid=grid)")
    else:
        rows = client_row_axes(grid)
        if cfg.client_axes is not None and tuple(cfg.client_axes) != rows:
            raise ValueError(f"client_axes={cfg.client_axes}: on a grid of {dict(grid.shape)} "
                             f"the clients ride its client rows {rows}")
        if getattr(model, "fsdp", False):
            raise ValueError("a vmap round's specs split no leaf over the data axes, where "
                             "FSDP's do: build_model(cfg.with_(fed_mode='vmap'), grid=grid)")
        if grid.shape.get("model", 1) > 1 and not built:
            raise ValueError("a grid with a model axis needs the model built over it: "
                             "build_model(cfg, grid=grid)")
    if cfg.num_clients % grid.size(rows):
        raise ValueError(f"{cfg.num_clients} clients do not split over {grid.size(rows)} "
                         f"client rows")
    if grid.size(rows) > 1 and cfg.mode != "remat" and cfg.afa.variant == "gram":
        raise ValueError("the tree form's gram variant needs the Gram entries of every pair of "
                         f"clients, which lie on {grid.size(rows)} client rows; set "
                         "variant='iterative'")
    specs = shard_params_tree(build_model(model.config).init(None, "meta"), grid, fsdp=fsdp)
    return TreeShards(grid, rows, tuple(_leaf_axes(spec, grid) for spec in tree_leaves(specs)))


def _client_ids(shards: TreeShards | None, cfg: FedRoundConfig, batch) -> range:
    """The ids of the clients whose batches ``batch`` holds: all of them on
    one card, this rank's client row's block on a grid (raises where the
    batch holds another number of clients)."""
    got = next(iter(batch.values())).shape[0]
    if shards is None:
        return range(got)
    n = shards.grid.size(shards.rows)
    if got != cfg.num_clients // n:
        raise ValueError(f"a rank trains the {cfg.num_clients // n} clients of its client row; "
                         f"the batch has {got}")
    if n == 1:
        return range(got)
    block = shards.grid.block(cfg.num_clients, shards.rows)
    return range(block.start, block.stop)


def _gather_clients(shards: TreeShards | None, parts: list) -> list:
    """Each of ``parts`` (this rank's clients first, equal shapes) with every
    client row's block in row order: one gather over the client rows (exact)
    for all of them; the parts as they are where there is one row."""
    if shards is None or shards.grid.size(shards.rows) == 1:
        return parts
    n = shards.grid.size(shards.rows)
    local = torch.stack(parts, dim=1)
    return list(shards.grid.gather_rows(local, n * local.shape[0], shards.rows).unbind(1))


def make_fed_round(model, cfg: FedRoundConfig, grid=None):
    """Returns ``fed_round(params, rep_state, n_k, batch) -> (params',
    rep_state', metrics)``; ``batch`` leaves ``(K, S, b, ...)``, ``n_k`` the
    (K,) float32 sample counts on the parameters' device.  On ``grid`` (a
    ``GridMesh``) ``params`` and the aggregate are this rank's blocks, and
    ``batch`` holds its client row's clients, or under ``scan`` and
    ``remat`` on a grid without a client axis the whole batch (see the
    module docstring)."""
    opt = sgd_momentum(cfg.lr, cfg.momentum)
    loss_fn = model.loss_fn
    shards = _grid_shards(model, cfg, grid)

    if cfg.mode == "vmap":

        def fed_round(params, rep: ReputationState, n_k, batch):
            mask0 = ~rep.blocked
            _client_ids(shards, cfg, batch)
            proposals = _clients_train(loss_fn, opt, params, batch, microbatch=cfg.microbatch,
                                       leafwise=shards is not None)
            res = afa_aggregate_tree(proposals, n_k, p_good(rep), mask0=mask0, config=cfg.afa,
                                     shards=shards)
            rep2 = update_reputation(rep, res.good_mask, mask0, delta=cfg.delta_block)
            return res.aggregate, rep2, _metrics(res.good_mask, res.rounds, res.similarities)

    elif cfg.mode == "scan":
        int8 = cfg.proposal_dtype == "int8"
        pdt = torch.int8 if int8 else torch_dtype(cfg.proposal_dtype)

        def fed_round(params, rep: ReputationState, n_k, batch):
            mask0 = ~rep.blocked
            w = _flat(params)
            ids = _client_ids(shards, cfg, batch)
            K = len(ids)   # this rank's clients
            store = {path: torch.empty((K,) + tuple(l.shape), dtype=pdt, device=l.device)
                     for path, l in w.items()}
            scales = {path: torch.empty((K,), dtype=torch.float32, device=l.device)
                      for path, l in w.items()} if int8 else None
            blocked = rep.blocked.tolist()
            for i, k in enumerate(ids):
                # a blocked client's local SGD never runs: it proposes w_t
                prop = w if blocked[k] else _flat(_client_train(
                    loss_fn, opt, params, {n: v[i] for n, v in batch.items()},
                    microbatch=cfg.microbatch, leafwise=shards is not None))
                if int8:
                    for path, (q, sc) in _quantize(prop, w, shards).items():
                        store[path][i], scales[path][i] = q, sc
                else:
                    for path, leaf in prop.items():
                        store[path][i] = leaf
                del prop
            if shards is not None:   # the store read a client at a time
                stacked = [Dequantized(store[path], scales[path], w[path]) if int8
                           else store[path] for path in w]
            elif int8:
                stacked = [q.float() * scales[path].reshape((K,) + (1,) * (q.ndim - 1))
                           + w[path].float()[None] for path, q in store.items()]
            else:
                stacked = list(store.values())
            res = afa_aggregate_tree(tree_unflatten(tuple(w), stacked), n_k, p_good(rep),
                                     mask0=mask0, config=cfg.afa, shards=shards)
            del stacked, store
            agg = tree_map(lambda a, t: a.to(t.dtype), res.aggregate, params)
            rep2 = update_reputation(rep, res.good_mask, mask0, delta=cfg.delta_block)
            metrics = _metrics(res.good_mask, res.rounds, res.similarities)
            if int8:
                metrics["scales"] = dict(zip(("/".join(path) for path in scales),
                                             _gather_clients(shards, list(scales.values()))))
            return agg, rep2, metrics

    elif cfg.mode == "remat":

        def dot(a: dict, b: dict):
            """sum <a, b> over the leaves; on a grid the blocks' partial
            sums, summed over each leaf's axes."""
            if shards is None:
                return tree_dot(a, b)
            return _leaf_sums([(a[path].float() * b[path].float()).sum() for path in a],
                              shards.split, shards.grid)

        def fed_round(params, rep: ReputationState, n_k, batch):
            mask0 = ~rep.blocked
            p_k = p_good(rep)
            w = _flat(params)
            ids = _client_ids(shards, cfg, batch)

            def train(i):
                return _flat(_client_train(loss_fn, opt, params,
                                           {n: v[i] for n, v in batch.items()},
                                           microbatch=cfg.microbatch,
                                           leafwise=shards is not None))

            def weighted_sum(c, norms=None):
                """sum_k c_k u_k in f32 over the retrained clients (on a grid
                of client rows, each row's sum summed over the rows); each
                of this rank's clients' norm appended to ``norms`` if
                given."""
                acc = {path: torch.zeros(l.shape, dtype=torch.float32, device=l.device)
                       for path, l in w.items()}
                for i, k in enumerate(ids):
                    u = train(i)
                    for path in acc:
                        acc[path] += c[k] * u[path].float()
                    if norms is not None:
                        norms.append(torch.sqrt(torch.clamp(dot(u, u), min=EPS)))
                    del u
                if shards is not None and shards.grid.size(shards.rows) > 1:
                    for path in acc:
                        acc[path] = shards.grid.psum(acc[path], shards.rows)
                return acc

            # pass 1: the plain weighted aggregate and each client's norm
            norms = []
            w_agg = weighted_sum(_weights(mask0, p_k, n_k.float()), norms)
            norms = _gather_clients(shards, [torch.stack(norms)])[0]
            agg_norm = torch.sqrt(torch.clamp(dot(w_agg, w_agg), min=EPS))
            # pass 2: the similarities, the clients retrained
            dots = _gather_clients(shards, [torch.stack([dot(train(i), w_agg)
                                                         for i in range(len(ids))])])[0]
            sims = dots / (norms * agg_norm)
            del w_agg
            # one Algorithm-1 screening pass on the K scalars
            xi = torch.full((), cfg.afa.xi0, dtype=torch.float32, device=sims.device)
            mask = mask0 & ~_mark_bad(sims, mask0, xi, cfg.afa.ddof)
            # pass 3: the masked weighted sum, the clients retrained again
            acc = weighted_sum(_weights(mask, p_k, n_k.float()))
            agg = tree_unflatten(tuple(w), [acc.pop(path).to(l.dtype) for path, l in w.items()])
            rep2 = update_reputation(rep, mask, mask0, delta=cfg.delta_block)
            rounds = torch.ones((), dtype=torch.int32, device=sims.device)
            return agg, rep2, _metrics(mask, rounds, sims)

    else:
        raise ValueError(f"unknown fed mode {cfg.mode}")

    return fed_round


def compact_fed_batch(batch, n_k, rep: ReputationState, pad_to: int | None = None):
    """The live clients' rows of ``batch`` and ``n_k``, and the compacted
    reputation (``gather_reputation``): ``keep`` ascending original ids,
    ``pad_to - len(keep)`` pad rows of zeros, blocked with zero weight.
    Returns ``(batch_c, n_k_c, rep_c, keep)``; the caller scatters per-client
    outputs back through ``keep``.  Raises ``ValueError`` when ``pad_to`` is
    below the number of live clients, rather than drop one."""
    keep = np.nonzero(~rep.blocked.cpu().numpy())[0]
    if pad_to is not None and pad_to < len(keep):
        raise ValueError(
            f"pad_to={pad_to} is smaller than the {len(keep)} live client "
            f"rows; refusing to truncate live clients"
        )
    pad_to = len(keep) if pad_to is None else pad_to
    pad = pad_to - len(keep)

    def take_rows(l):
        out = l.index_select(0, torch.from_numpy(keep).to(l.device))
        if pad > 0:
            out = torch.cat([out, out.new_zeros((pad,) + tuple(out.shape[1:]))])
        return out

    batch_c = tree_map(take_rows, batch)
    n_k_c = take_rows(torch.as_tensor(n_k))
    rep_c = gather_reputation(rep, keep, pad_to)
    return batch_c, n_k_c, rep_c, keep
