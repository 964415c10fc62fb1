"""The round engines' proposal pipeline.

Counterpart of the round pieces of ``repro/fed/engine.py``: the K clients
train (``workload.local_update``), non-trainers are reset to ``w_t``, and
the update-level attacks run on the stacked proposals.  ``FusedData`` holds
the device-resident inputs of the LLM workload's round loop
(``fed/workload.simulate_llm``).  The fused and segmented scan engines are
not ported.

Seeded torch streams replace ``jax.random`` keys: client k's dropout masks in
round r come from ``client_seeds(seed, r, ids)[k]``, keyed by (seed, round,
original client id); the byzantine noise from ``attack_seed(seed, r)`` plus
(leaf, original client id).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.attacks import apply_update_attack, stream_seed
from repro_torch.utils.trees import tree_broadcast_clients, tree_select_rows

_CLIENT_STREAM = 0xC11E47
_ROUND_ATTACK_STREAM = 0xA7


class FusedData(NamedTuple):
    """Device-resident inputs of a round loop over padded client shards."""

    x: torch.Tensor        # (K, n_max, *feat) zero-padded client shards
    y: torch.Tensor        # (K, n_max, *lab) int32 labels
    lengths: torch.Tensor  # (K,) int32 live rows per shard
    n_k: torch.Tensor      # (K,) float32 aggregation data weights
    x_test: torch.Tensor   # (n_test, *feat)
    y_test: torch.Tensor   # (n_test, *lab) int32


class EngineConfig(NamedTuple):
    """Knobs of the batched round step."""

    scenario: str = "clean"      # clean | byzantine | flipping | noisy | alie | ipm
    lr: float = 0.1
    momentum: float = 0.9
    dropout: bool = True
    byzantine_scale: float = 20.0
    alie_z_max: float = 1.2
    ipm_eps: float = 0.5


def client_seeds(seed: int, rnd: int, client_ids) -> list:
    """One generator seed per client row, keyed by (seed, round, client id)."""
    return [stream_seed(_CLIENT_STREAM, seed, rnd, int(c)) for c in client_ids]


def attack_seed(seed: int, rnd: int) -> int:
    """The round's seed of the update-level attack noise."""
    return stream_seed(_ROUND_ATTACK_STREAM, seed, rnd)


def _train_and_attack(workload, cfg: EngineConfig, params, batch, seeds, train_mask,
                      bad_mask, benign_mask, round_attack_seed: int):
    """Local training of every row, non-trainer rows reset to the current
    proposal-space point ``w_t``, update-level attacks applied by mask."""
    K = train_mask.shape[0]
    w_prev = workload.codec.proposal_of(params)
    proposals = workload.local_update(cfg, params, batch, seeds, train_mask=train_mask)
    # non-trainers hold w_t until the attack layer overwrites their row
    proposals = tree_select_rows(train_mask, proposals, tree_broadcast_clients(w_prev, K))
    return apply_update_attack(
        cfg.scenario, proposals, w_prev, bad_mask, benign_mask, round_attack_seed,
        byzantine_scale=cfg.byzantine_scale, z_max=cfg.alie_z_max, eps=cfg.ipm_eps,
    )


def make_train_attack_step(workload, cfg: EngineConfig):
    """``step(params, batch, seeds, train_mask, bad_mask, benign_mask,
    round_attack_seed) -> stacked proposals``."""

    def step(params, batch, seeds, train_mask, bad_mask, benign_mask, round_attack_seed):
        return _train_and_attack(workload, cfg, params, batch, seeds, train_mask,
                                 bad_mask, benign_mask, round_attack_seed)

    return step
