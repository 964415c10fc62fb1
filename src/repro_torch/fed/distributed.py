"""Federated round of whole-model proposals: the one-card modes.

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
``betainc`` on the host.  ``FedRoundConfig.client_axes`` names mesh axes in
the reference and has no effect on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.afa import EPS, AFAConfig, _mark_bad, _weights, afa_aggregate_tree
from repro_torch.core.reputation import (
    ReputationState,
    gather_reputation,
    p_good,
    update_reputation,
)
from repro_torch.models.config import torch_dtype
from repro_torch.optim import sgd_momentum
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
    client_axes: tuple | None = None  # mesh axes of the reference: no effect on one card


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


def _train(loss, opt, p: dict, batches: dict, *, axis: int, microbatch: int) -> dict:
    """Local SGD from the flat parameters ``p``: one step for each entry of
    the batches' step axis ``axis`` (0 for one client's ``(S, b, ...)``, 1
    for K clients' ``(K, S, b, ...)``).  ``p`` is not written."""
    state = opt.init(p)
    steps = next(iter(batches.values())).shape[axis]
    for t in range(steps):
        mb = {k: v.select(axis, t) for k, v in batches.items()}
        upd, state = opt.update(_grads(loss, p, mb, axis, microbatch), state, p)
        p = {path: p[path] + upd[path].to(p[path].dtype) for path in p}
    return p


def _client_train(loss_fn, opt, params, cbatch, *, microbatch: int = 1):
    """One client's local SGD: ``cbatch`` leaves ``(S, b, ...)``; returns the
    proposed tree."""
    p = _train(lambda q, mb: loss_fn(q, mb)[0], opt, _flat(params), cbatch, axis=0,
               microbatch=microbatch)
    return tree_unflatten(tree_structure(params), list(p.values()))


def _clients_train(loss_fn, opt, params, batch, *, microbatch: int = 1):
    """The K clients' local SGD at once: ``batch`` leaves ``(K, S, b, ...)``;
    returns the stacked proposals, every leaf ``(K, ...)``."""
    K = next(iter(batch.values())).shape[0]
    losses = torch.func.vmap(lambda q, mb: loss_fn(q, mb)[0])
    stacked = {path: l.unsqueeze(0).expand((K,) + tuple(l.shape))
               for path, l in _flat(params).items()}
    p = _train(lambda q, mb: losses(q, mb).sum(), opt, stacked, batch, axis=1,
               microbatch=microbatch)
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


def _quantize(prop, w):
    """int8 storage of the delta ``prop - w``: one symmetric scale
    ``max|d| / 127``, rounded half to even and clipped to +-127."""
    d = prop.float() - w.float()
    s = torch.clamp(d.abs().max(), min=EPS) / 127.0
    return torch.clamp(torch.round(d / s), -127, 127).to(torch.int8), s


def make_fed_round(model, cfg: FedRoundConfig):
    """Returns ``fed_round(params, rep_state, n_k, batch) -> (params',
    rep_state', metrics)``; ``batch`` leaves ``(K, S, b, ...)``, ``n_k`` the
    (K,) float32 sample counts on the parameters' device."""
    opt = sgd_momentum(cfg.lr, cfg.momentum)
    loss_fn = model.loss_fn

    if cfg.mode == "vmap":

        def fed_round(params, rep: ReputationState, n_k, batch):
            mask0 = ~rep.blocked
            proposals = _clients_train(loss_fn, opt, params, batch, microbatch=cfg.microbatch)
            res = afa_aggregate_tree(proposals, n_k, p_good(rep), mask0=mask0, config=cfg.afa)
            rep2 = update_reputation(rep, res.good_mask, mask0, delta=cfg.delta_block)
            return res.aggregate, rep2, _metrics(res.good_mask, res.rounds, res.similarities)

    elif cfg.mode == "scan":
        int8 = cfg.proposal_dtype == "int8"
        pdt = torch.int8 if int8 else torch_dtype(cfg.proposal_dtype)

        def fed_round(params, rep: ReputationState, n_k, batch):
            mask0 = ~rep.blocked
            w = _flat(params)
            K = next(iter(batch.values())).shape[0]
            store = {path: torch.empty((K,) + tuple(l.shape), dtype=pdt, device=l.device)
                     for path, l in w.items()}
            scales = {path: torch.empty((K,), dtype=torch.float32, device=l.device)
                      for path, l in w.items()} if int8 else None
            for k, is_blocked in enumerate(rep.blocked.tolist()):
                # a blocked client's local SGD never runs: it proposes w_t
                prop = w if is_blocked else _flat(_client_train(
                    loss_fn, opt, params, {n: v[k] for n, v in batch.items()},
                    microbatch=cfg.microbatch))
                for path, leaf in prop.items():
                    if int8:
                        store[path][k], scales[path][k] = _quantize(leaf, w[path])
                    else:
                        store[path][k] = leaf
                del prop
            if int8:
                store = {path: q.float() * scales[path].reshape((K,) + (1,) * (q.ndim - 1))
                         + w[path].float()[None] for path, q in store.items()}
            res = afa_aggregate_tree(tree_unflatten(tuple(w), list(store.values())), n_k,
                                     p_good(rep), mask0=mask0, config=cfg.afa)
            agg = tree_map(lambda a, t: a.to(t.dtype), res.aggregate, params)
            rep2 = update_reputation(rep, res.good_mask, mask0, delta=cfg.delta_block)
            return agg, rep2, _metrics(res.good_mask, res.rounds, res.similarities)

    elif cfg.mode == "remat":

        def fed_round(params, rep: ReputationState, n_k, batch):
            mask0 = ~rep.blocked
            p_k = p_good(rep)
            w = _flat(params)
            K = next(iter(batch.values())).shape[0]

            def train(k):
                return _flat(_client_train(loss_fn, opt, params,
                                           {n: v[k] for n, v in batch.items()},
                                           microbatch=cfg.microbatch))

            def weighted_sum(c, norms=None):
                """sum_k c_k u_k in f32 over the retrained clients; each
                client's norm appended to ``norms`` if given."""
                acc = {path: torch.zeros(l.shape, dtype=torch.float32, device=l.device)
                       for path, l in w.items()}
                for k in range(K):
                    u = train(k)
                    for path in acc:
                        acc[path] += c[k] * u[path].float()
                    if norms is not None:
                        norms.append(torch.sqrt(torch.clamp(tree_dot(u, u), min=EPS)))
                return acc

            # pass 1: the plain weighted aggregate and each client's norm
            norms = []
            w_agg = weighted_sum(_weights(mask0, p_k, n_k.float()), norms)
            norms = torch.stack(norms)
            agg_norm = torch.sqrt(torch.clamp(tree_dot(w_agg, w_agg), min=EPS))
            # pass 2: the similarities, the clients retrained
            dots = torch.stack([tree_dot(train(k), w_agg) for k in range(K)])
            sims = dots / (norms * agg_norm)
            del w_agg
            # one Algorithm-1 screening pass on the K scalars
            xi = torch.full((), cfg.afa.xi0, dtype=torch.float32, device=sims.device)
            mask = mask0 & ~_mark_bad(sims, mask0, xi, cfg.afa.ddof)
            # pass 3: the masked weighted sum, the clients retrained again
            acc = weighted_sum(_weights(mask, p_k, n_k.float()))
            agg = tree_unflatten(tuple(w), [acc[path].to(l.dtype) for path, l in w.items()])
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
