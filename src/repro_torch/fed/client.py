"""Client-side local training: SGD with momentum over prebuilt minibatches.

Counterpart of ``repro/fed/client.py``.  ``local_sgd`` is written for K
clients at once: parameters stacked with a leading client axis, batches
``(K, S, b, ...)``.  Backpropagating the SUM over clients of each client's
mean loss gives every client exactly its own gradient, since no parameter is
shared between rows.  ``local_sgd_frozen`` trains ONE client's trainable
tree against a frozen one (the LoRA adapters on a frozen transformer base).
Momentum starts from zero every call (every round).
"""

from __future__ import annotations

import torch

from repro_torch.optim import sgd_momentum
from repro_torch.utils.trees import tree_leaves, tree_structure, tree_unflatten


def local_sgd(loss_fn, params, batches, *, lr: float = 0.1, momentum: float = 0.9,
              dropout_keep=None):
    """Run S SGD steps on stacked client params; returns the proposals.

    ``loss_fn(params, minibatch, dropout_keep=...)`` returns (K,) losses;
    ``batches`` is a dict of ``(K, S, b, ...)`` tensors; ``dropout_keep`` is
    None or a list (one per hidden layer) of ``(K, S, b, width)`` bool masks.
    """
    opt = sgd_momentum(lr, momentum)
    p = {k: v.detach().clone(memory_format=torch.contiguous_format)
         for k, v in params.items()}
    state = opt.init(p)
    names = sorted(p)
    steps = next(iter(batches.values())).shape[1]
    for t in range(steps):
        mb = {k: v[:, t] for k, v in batches.items()}
        keep = None if dropout_keep is None else [m[:, t] for m in dropout_keep]
        leaves = [p[k].requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = loss_fn(p, mb, dropout_keep=keep).sum()
            grads = torch.autograd.grad(loss, leaves)
        upd, state = opt.update(dict(zip(names, grads)), state, p)
        p = {k: (p[k].detach() + upd[k]) for k in names}
    return p


def local_sgd_frozen(loss_fn, frozen, params, batches, *, lr: float = 0.1,
                     momentum: float = 0.9):
    """Run S SGD steps of one client on the nested trainable tree ``params``
    while ``frozen`` gets no gradient; returns the proposed tree.

    ``loss_fn(frozen, params, minibatch)`` returns the scalar loss;
    ``batches`` is a dict of ``(S, b, ...)`` tensors.  The tree is flattened
    to its leaf paths for the optimizer, which works on flat dicts."""
    treedef = tree_structure(params)
    opt = sgd_momentum(lr, momentum)
    p = {path: l.detach().clone() for path, l in zip(treedef, tree_leaves(params))}
    state = opt.init(p)
    steps = next(iter(batches.values())).shape[0]
    for t in range(steps):
        mb = {k: v[t] for k, v in batches.items()}
        leaves = [p[path].requires_grad_(True) for path in treedef]
        with torch.enable_grad():
            loss = loss_fn(frozen, tree_unflatten(treedef, leaves), mb)
            grads = torch.autograd.grad(loss, leaves)
        upd, state = opt.update(dict(zip(treedef, grads)), state, p)
        p = {path: p[path].detach() + upd[path].to(p[path].dtype) for path in treedef}
    return tree_unflatten(treedef, [p[path] for path in treedef])


def local_sgd_frozen_clients(loss_fn, frozen, params, batches, *, lr: float = 0.1,
                             momentum: float = 0.9):
    """``local_sgd_frozen`` for K clients at once: the trainable tree
    ``params`` carries a leading client axis, ``frozen`` is shared and
    ``batches`` is a dict of ``(K, S, b, ...)`` tensors.

    The per-client loss is ``torch.func.vmap`` of ``loss_fn`` over the
    trainable rows and the batches, the frozen tree unbatched (the
    counterpart of the JAX package's ``vmap(train_one)``); backpropagating
    the sum of the K losses gives each row exactly its own gradient, since
    no trainable leaf is shared between rows."""
    treedef = tree_structure(params)
    opt = sgd_momentum(lr, momentum)
    p = {path: l.detach().clone(memory_format=torch.contiguous_format)
         for path, l in zip(treedef, tree_leaves(params))}
    state = opt.init(p)
    losses = torch.func.vmap(loss_fn, in_dims=(None, 0, 0))
    steps = next(iter(batches.values())).shape[1]
    for t in range(steps):
        mb = {k: v[:, t] for k, v in batches.items()}
        leaves = [p[path].requires_grad_(True) for path in treedef]
        with torch.enable_grad():
            loss = losses(frozen, tree_unflatten(treedef, leaves), mb).sum()
            grads = torch.autograd.grad(loss, leaves)
        upd, state = opt.update(dict(zip(treedef, grads)), state, p)
        p = {path: p[path].detach() + upd[path].to(p[path].dtype) for path in treedef}
    return tree_unflatten(treedef, [p[path] for path in treedef])
