"""Helpers over trees of tensors (nested dicts) and the packed (K, D) layout.

Counterpart of ``repro/utils/trees.py``: the vector-space ops of the tree
form (``tree_dot`` with a kept client axis, ``tree_norm``, ``tree_axpy`` and
the rest), the stacked-tree helpers and the packed layout.  A tree is a nested ``dict`` whose
non-dict values are the leaves.  Leaves are visited in SORTED key order at
every level, the order ``jax.tree_util`` gives dicts, so the paper DNN packs
as ``b0, b1, b2, w0, w1, w2`` and a packed ``(K, D)`` buffer lines up with the
JAX package's column for column.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], prefix + (key,))
    else:
        yield prefix


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def tree_structure(tree) -> tuple:
    """The tree's definition: the tuple of leaf paths in leaf order."""
    return tuple(_paths(tree))


def tree_leaves(tree) -> list:
    return [_get(tree, p) for p in _paths(tree)]


def tree_unflatten(treedef: tuple, leaves) -> Any:
    leaves = list(leaves)
    if treedef == ((),):
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(treedef, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    treedef = tree_structure(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(
        treedef, [fn(*ls) for ls in zip(tree_leaves(tree), *others)]
    )


def tree_dot(a, b, *, axes=None, dtype=torch.float32):
    """Sum of elementwise products over all leaves, accumulated leaf by leaf
    in leaf order, in ``dtype``.  With ``axes`` the leading ``axes`` axes
    are kept: stacked ``(K, ...)`` leaves give a ``(K,)`` result."""
    total = None
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        prod = la.to(dtype) * lb.to(dtype)
        if axes is None:
            part = prod.sum()
        else:
            red = tuple(range(axes, prod.ndim))
            part = prod.sum(dim=red) if red else prod
        total = part if total is None else total + part
    return total


def tree_norm(a, *, axes=None, dtype=torch.float32):
    return torch.sqrt(tree_dot(a, a, axes=axes, dtype=dtype))


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    """``s * a`` leafwise, each leaf kept in its dtype."""
    return tree_map(lambda x: (s * x).to(x.dtype), a)


def tree_axpy(s, x, y):
    """``y + s * x`` leafwise, in y's dtype."""
    return tree_map(lambda lx, ly: (ly + s * lx.to(ly.dtype)).to(ly.dtype), x, y)


def tree_zeros_like(a, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), a)


def tree_size(tree) -> int:
    """Total number of elements over the leaves."""
    return sum(l.numel() for l in tree_leaves(tree))


def tree_stack(trees):
    """List of identically-structured trees -> one tree with a new leading
    client axis on every leaf."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def tree_broadcast_clients(tree, num_clients: int):
    """A single tree -> a stacked tree of K identical rows (expanded views)."""
    return tree_map(lambda l: l.unsqueeze(0).expand((num_clients,) + tuple(l.shape)), tree)


def _row(mask, leaf):
    return mask.reshape((-1,) + (1,) * (leaf.ndim - 1))


def tree_select_rows(mask, a, b):
    """Row-wise ``where(mask[k], a_k, b_k)`` over the leading client axis."""
    return tree_map(lambda la, lb: torch.where(_row(mask, la), la, lb), a, b)


# ---------------------------------------------------------------------------
# packed (K, D) layout — the aggregation hot-path representation
# ---------------------------------------------------------------------------


class LeafSlot(NamedTuple):
    """One leaf's column slice of the packed buffer."""

    shape: tuple            # per-client leaf shape (no leading client axis)
    dtype: torch.dtype      # original leaf dtype, restored by unpack_stack
    offset: int             # first column of this leaf's slice
    size: int               # number of columns (= prod(shape))


class PackSpec(NamedTuple):
    """Static layout of a tree packed into one contiguous column axis;
    ``dtype`` is the promotion of every leaf dtype."""

    treedef: tuple
    slots: tuple            # tuple[LeafSlot, ...] in leaf order
    dim: int                # D = total packed columns
    dtype: torch.dtype      # packed buffer dtype (promoted)


def pack_spec(tree, *, stacked: bool = False) -> PackSpec:
    """Layout of ``tree`` packed along one column axis.  ``stacked=True``
    strips the leading client axis, so the spec describes ONE client row."""
    leaves = tree_leaves(tree)
    slots, off = [], 0
    dtype = leaves[0].dtype
    for l in leaves:
        shape = tuple(l.shape[1:]) if stacked else tuple(l.shape)
        n = 1
        for s in shape:
            n *= int(s)
        slots.append(LeafSlot(shape, l.dtype, off, n))
        off += n
        dtype = torch.promote_types(dtype, l.dtype)
    return PackSpec(tree_structure(tree), tuple(slots), off, dtype)


def pack_stack(stacked_tree, spec: PackSpec | None = None) -> torch.Tensor:
    """Stacked tree (leading client axis K on every leaf) -> one contiguous
    ``(K, D)`` buffer in ``spec.dtype``, columns in leaf order."""
    leaves = tree_leaves(stacked_tree)
    if spec is None:
        spec = pack_spec(stacked_tree, stacked=True)
    K = leaves[0].shape[0]
    return torch.cat(
        [l.reshape(K, slot.size).to(spec.dtype) for l, slot in zip(leaves, spec.slots)],
        dim=1,
    )


def unpack_stack(packed: torch.Tensor, spec: PackSpec):
    """Inverse of :func:`pack_stack` along the last axis, for any leading
    batch shape: ``(D,)`` unpacks to one tree, ``(K, D)`` to a stacked one."""
    lead = tuple(packed.shape[:-1])
    return tree_unflatten(spec.treedef, [
        packed[..., slot.offset : slot.offset + slot.size]
        .reshape(lead + slot.shape).to(slot.dtype)
        for slot in spec.slots
    ])


def flatten_to_matrix(stacked_tree, num_rows: int) -> torch.Tensor:
    """Stacked tree with leading client axis K -> dense ``(K, D)`` matrix:
    :func:`pack_stack` under the name the leaf layout's matrix-only rules
    use.  ``num_rows`` is read off the leaves and kept for the JAX
    package's signature."""
    del num_rows
    return pack_stack(stacked_tree)


def unflatten_from_vector(vec: torch.Tensor, template):
    """Inverse of :func:`flatten_to_matrix` for one ``(D,)`` vector, against
    a template tree of one client's leaves."""
    return unpack_stack(vec, pack_spec(template))
