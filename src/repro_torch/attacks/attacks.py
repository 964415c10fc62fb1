"""The paper's bad-client behaviours plus two beyond-paper attacks.

Counterpart of ``repro/attacks/attacks.py``:

* data poisoning, applied to a client's shard before training (numpy copies
  of the JAX package's, consuming the same numpy stream):
  ``flip_labels`` and ``noisy_features``;
* the numpy update-space helpers on flat ``(d,)`` / ``(K, d)`` arrays, for
  analysis scripts and tests (copies of the JAX package's, with its
  defaults; ``byzantine_update_attack`` consumes the caller's numpy
  generator as it does): ``byzantine_update_attack``,
  ``alie_update_attack``, ``ipm_update_attack`` and
  ``sign_flip_update_attack``;
* update poisoning on stacked proposals (every leaf has a leading client
  axis), selected by (K,) bool masks: ``byzantine_update_tree`` (w_t +
  N(0, 20^2 I)), ``alie_update_tree`` and ``ipm_update_tree``, dispatched by
  ``apply_update_attack``.

Byzantine noise is drawn from a ``torch.Generator`` seeded by (attack seed,
leaf index, ORIGINAL client id), never by row position, so compacting the
stack later is a change of layout only.  The fused engines draw it with
``byzantine_update_keyed`` from the keyed Philox stream
(``utils/philox.py``) instead, for every row of the packed proposals, and
select the bad rows by mask, with no host read.  The benign moments of
``alie_update_tree`` and ``ipm_update_tree`` are row-order folds
(``core.stats.row_sum``; a row outside the benign mask adds an exact zero),
so a compaction that moves the rows leaves the forged rows unchanged.
torch cannot replay ``jax.random``, so the noise differs from the JAX
package's in value, not in distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stats import row_sum
from repro_torch.utils.philox import keyed_normal
from repro_torch.utils.trees import tree_leaves, tree_map, tree_structure, tree_unflatten

UPDATE_ATTACK_SCENARIOS = ("byzantine", "alie", "ipm")

# stream tag separating attack noise from the other seeded torch streams
_ATTACK_STREAM = 0xA77AC4


def flip_labels(x: np.ndarray, y: np.ndarray, rng=None, target: int = 0):
    return x, np.full_like(y, target)


def noisy_features(x: np.ndarray, y: np.ndarray, rng=None, *, binary: bool | None = None):
    rng = rng or np.random.default_rng(0)
    binary = bool(((x == 0) | (x == 1)).all()) if binary is None else binary
    if binary:
        flip = rng.uniform(size=x.shape) < 0.30
        return np.where(flip, 1.0 - x, x).astype(x.dtype), y
    eps = rng.uniform(-1.4, 1.4, size=x.shape).astype(x.dtype)
    return np.clip(x + eps, -1.0, 1.0), y


ATTACKS = {
    "flipping": flip_labels,
    "noisy": noisy_features,
}


def byzantine_update_attack(w_prev_flat: np.ndarray, rng, scale: float = 20.0):
    """Paper eq.: w_{t+1}^k <- w_t + Delta, Delta ~ N(0, scale^2 I)."""
    return w_prev_flat + rng.normal(scale=scale, size=w_prev_flat.shape).astype(
        w_prev_flat.dtype
    )


def alie_update_attack(benign_updates: np.ndarray, z_max: float = 1.2):
    """Colluding stealth attack: every attacker sends mean - z_max * std of
    the benign updates (coordinate-wise), inside the benign spread."""
    mu = benign_updates.mean(axis=0)
    sd = benign_updates.std(axis=0)
    return mu - z_max * sd


def ipm_update_attack(benign_updates: np.ndarray, eps: float = 0.5):
    """Inner-product manipulation: colluders send -eps * mean(benign)."""
    return -eps * benign_updates.mean(axis=0)


def sign_flip_update_attack(own_update: np.ndarray, w_prev: np.ndarray, scale: float = 3.0):
    """Reverse and amplify the client's own honest delta."""
    return w_prev - scale * (own_update - w_prev)


def stream_seed(*keys: int) -> int:
    """A 63-bit generator seed derived from a tuple of non-negative ints."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _row(mask, leaf):
    return mask.reshape((-1,) + (1,) * (leaf.ndim - 1))


def byzantine_update_tree(proposals, w_prev, bad_mask, seed: int, *,
                          scale: float = 20.0, client_ids=None):
    """Bad rows <- w_t + N(0, scale^2 I).

    Row k's noise on leaf i comes from a generator seeded by ``(seed, i,
    client_ids[k])``; ``client_ids`` None means the identity layout."""
    leaves = tree_leaves(proposals)
    prev = tree_leaves(w_prev)
    K = leaves[0].shape[0]
    ids = list(range(K)) if client_ids is None else [int(c) for c in client_ids]
    rows = torch.nonzero(bad_mask).flatten().tolist()
    if not rows:
        return proposals
    out = []
    for i, (l, p) in enumerate(zip(leaves, prev)):
        l = l.clone()
        for k in rows:
            gen = torch.Generator(device=l.device)
            gen.manual_seed(stream_seed(_ATTACK_STREAM, seed, i, ids[k]))
            noise = torch.randn(tuple(l.shape[1:]), generator=gen,
                                dtype=torch.float32, device=l.device)
            l[k] = (p.float() + scale * noise).to(l.dtype)
        out.append(l)
    return tree_unflatten(tree_structure(proposals), out)


def byzantine_update_keyed(packed, w_prev, bad_mask, seed, offsets, *,
                           scale: float = 20.0):
    """Bad rows of the packed ``(R, D)`` proposals <- w_t + N(0, scale^2 I).

    ``w_prev`` is the packed ``(D,)`` point w_t; row r's noise is the keyed
    normal stream ``(seed, attack stream, offsets[r])`` (``offsets`` = round
    * K + original client id), drawn for every row and kept where
    ``bad_mask`` is set."""
    noise = keyed_normal(seed, _ATTACK_STREAM, offsets, packed.shape[1])
    forged = (w_prev.float()[None] + scale * noise).to(packed.dtype)
    return torch.where(bad_mask[:, None], forged, packed)


def _benign_count(benign_mask):
    return torch.clamp(benign_mask.float().sum(), min=1.0)


def _global_sums(mesh, parts, benign_mask):
    """``(parts, benign count)`` summed over the client mesh in ONE
    all-reduce of their concatenation (the count last)."""
    flat = torch.cat([p.reshape(-1) for p in parts]
                     + [benign_mask.float().sum().reshape(1)])
    flat = mesh.psum(flat)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out, torch.clamp(flat[-1], min=1.0)


def alie_update_tree(proposals, bad_mask, benign_mask, *, z_max: float = 1.2, mesh=None):
    """Bad rows <- mean - z_max * std of the benign rows (coordinate-wise).

    With ``mesh`` (a ``launch.mesh.ClientMesh``) the stack is this rank's
    rows, and the benign moments go global in ONE all-reduce of every
    leaf's partial sums and sums of squares and the benign count; the
    variance is then the one-pass ``E[x^2] - E[x]^2``, clamped at 0, as in
    the JAX package's sharded form."""
    if mesh is not None:
        leaves = tree_leaves(proposals)
        w = [_row(benign_mask, l).float() for l in leaves]
        s1 = [row_sum(wl * l.float()) for wl, l in zip(w, leaves)]
        s2 = [row_sum(wl * l.float() * l.float()) for wl, l in zip(w, leaves)]
        sums, cnt = _global_sums(mesh, s1 + s2, benign_mask)
        out = []
        for l, a, b in zip(leaves, sums[:len(leaves)], sums[len(leaves):]):
            mu = a / cnt
            var = torch.clamp(b / cnt - mu * mu, min=0.0)
            adv = (mu - z_max * torch.sqrt(var)).to(l.dtype)
            out.append(torch.where(_row(bad_mask, l), adv[None], l))
        return tree_unflatten(tree_structure(proposals), out)
    cnt = _benign_count(benign_mask)

    def leaf(l):
        w = _row(benign_mask, l).float()
        lf = l.float()
        mu = row_sum(w * lf) / cnt
        var = row_sum(w * (lf - mu[None]) ** 2) / cnt
        adv = (mu - z_max * torch.sqrt(var)).to(l.dtype)
        return torch.where(_row(bad_mask, l), adv[None], l)

    return tree_map(leaf, proposals)


def ipm_update_tree(proposals, bad_mask, benign_mask, *, eps: float = 0.5, mesh=None):
    """Bad rows <- -eps * mean(benign rows): inner-product manipulation.

    With ``mesh`` the benign mean goes global in ONE all-reduce of the
    leaves' partial sums and the benign count (see ``alie_update_tree``)."""
    if mesh is not None:
        leaves = tree_leaves(proposals)
        s1 = [row_sum(_row(benign_mask, l).float() * l.float()) for l in leaves]
        sums, cnt = _global_sums(mesh, s1, benign_mask)
        out = [torch.where(_row(bad_mask, l), (-eps * (a / cnt)).to(l.dtype)[None], l)
               for l, a in zip(leaves, sums)]
        return tree_unflatten(tree_structure(proposals), out)
    cnt = _benign_count(benign_mask)

    def leaf(l):
        w = _row(benign_mask, l).float()
        mu = row_sum(w * l.float()) / cnt
        return torch.where(_row(bad_mask, l), (-eps * mu).to(l.dtype)[None], l)

    return tree_map(leaf, proposals)


def apply_update_attack(scenario: str, proposals, w_prev, bad_mask, benign_mask,
                        seed: int, *, byzantine_scale: float = 20.0,
                        z_max: float = 1.2, eps: float = 0.5, client_ids=None, mesh=None):
    """Dispatch the update-level attacks on stacked proposals; data-level
    scenarios (clean/flipping/noisy) are a no-op here.  ``seed`` is the
    round's attack seed (``fed.engine.attack_seed``).  ``mesh`` is the
    client mesh when the stack is this rank's rows: alie and ipm then make
    their benign moments global in one all-reduce each; byzantine is
    row-local."""
    if scenario == "byzantine":
        return byzantine_update_tree(proposals, w_prev, bad_mask, seed,
                                     scale=byzantine_scale, client_ids=client_ids)
    if scenario == "alie":
        return alie_update_tree(proposals, bad_mask, benign_mask, z_max=z_max, mesh=mesh)
    if scenario == "ipm":
        return ipm_update_tree(proposals, bad_mask, benign_mask, eps=eps, mesh=mesh)
    return proposals
