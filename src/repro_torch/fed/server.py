"""Server-side aggregation: registry rule dispatch plus the AFA reputation
and blocking state.

Counterpart of ``repro/fed/server.py``: a pure core (``ServerState`` and
``server_step``) wrapped by the stateful ``FedServer`` shell the batched
engine drives; ``server_step_versioned`` is the serving tier's round over a
buffer of version-stamped updates.  The fused engines call ``server_step`` inside their round
body with a device round counter and the blocking table, and compact the
state with ``gather_server_state`` / ``scatter_server_state``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    RULES,
    AFAConfig,
    ReputationState,
    RuleOptions,
    dispatch_rule,
    dispatch_rule_tree,
    gather_reputation,
    init_reputation,
    mark_blocked_round,
    p_good,
    scatter_reputation,
    update_reputation,
    update_reputation_weighted,
)
from repro_torch.kernels.policy import KernelPlan, resolve_kernel_plan


@dataclasses.dataclass
class ServerConfig:
    rule: str = "afa"            # any key of repro_torch.core.RULES:
                                 # afa | fa | mkrum | comed | trimmed_mean
                                 # | bulyan | norm_clip | geomed | centered_clip
    num_clients: int = 10
    # AFA
    alpha0: float = 3.0
    beta0: float = 3.0
    xi0: float = 2.0
    delta_xi: float = 0.5
    delta_block: float = 0.95
    afa_variant: str = "iterative"
    # baselines
    num_byzantine: int = 3       # f for mkrum/bulyan
    trim: int = 3                # for trimmed_mean
    # the kernel decision (repro_torch.kernels.policy.KernelPlan); None =
    # resolve_kernel_plan(), which reads $REPRO_TORCH_KERNELS
    kernel_plan: KernelPlan | None = None


def resolve_server_plan(cfg: ServerConfig) -> KernelPlan:
    """The config's KernelPlan, or the default plan when it has none."""
    return cfg.kernel_plan if cfg.kernel_plan is not None else resolve_kernel_plan()


class ServerState(NamedTuple):
    """Complete server-side round state."""

    reputation: ReputationState   # Beta posteriors + blocked set, (K,) leaves
    rounds_blocked: torch.Tensor  # (K,) int32 — 1-indexed round of first
                                  # blocking, -1 = never blocked
    # completed rounds: a Python int on the batched engine, a () int32
    # tensor on the state's device on the fused engines (whose rounds read
    # and advance it without a host read)
    round: Union[int, torch.Tensor]


def init_server_state(num_clients: int, alpha0: float = 3.0, beta0: float = 3.0, *,
                      device="cuda") -> ServerState:
    """Round-0 server state on ``device`` (the card unless
    ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    return ServerState(
        reputation=init_reputation(num_clients, alpha0, beta0, device=device),
        rounds_blocked=torch.full((num_clients,), -1, dtype=torch.int32, device=device),
        round=0,
    )


def gather_server_state(state: ServerState, keep, pad_to: int) -> ServerState:
    """Compact the full-K state to the kept client ids ``keep`` (ascending;
    ``-1`` marks a pad slot) and pad to ``pad_to`` rows: pads are blocked for
    good and read "never blocked" (``rounds_blocked = -1``).  The round
    counter stays absolute."""
    keep = np.asarray(keep, np.int64)
    dev = state.rounds_blocked.device
    rb = state.rounds_blocked.index_select(0, torch.from_numpy(np.maximum(keep, 0)).to(dev))
    rb = torch.where(torch.from_numpy(keep >= 0).to(dev), rb, -1)
    if pad_to > keep.shape[0]:
        rb = torch.cat([rb, torch.full((pad_to - keep.shape[0],), -1, dtype=rb.dtype,
                                       device=dev)])
    return ServerState(gather_reputation(state.reputation, keep, pad_to), rb, state.round)


def scatter_server_state(full: ServerState, compact: ServerState, keep) -> ServerState:
    """Re-embed a compacted state into the full-K layout (inverse of
    :func:`gather_server_state`): clients not in ``keep`` keep their entries
    in ``full`` (only blocked clients are dropped, and blocking freezes them);
    pad slots are dropped.  The round counter is the compacted state's."""
    keep = np.asarray(keep, np.int64)
    live = keep >= 0
    dev = full.rounds_blocked.device
    rb = full.rounds_blocked.clone()
    rb[torch.from_numpy(keep[live]).to(dev)] = compact.rounds_blocked.index_select(
        0, torch.from_numpy(np.nonzero(live)[0]).to(dev))
    return ServerState(scatter_reputation(full.reputation, compact.reputation, keep), rb,
                       compact.round)


def make_rule_options(cfg: ServerConfig, num_participants: int, *,
                      client_mesh=None) -> RuleOptions:
    """Knob bundle for the registry, from the config's resolved plan.

    ``num_selected`` is set only for the rule that reads it (MKRUM), from
    the round's live participant count.  ``client_mesh`` marks the
    options for this rank's rows of a client mesh: over more than one shard
    AFA then screens hierarchically, and the all-blocked guard sums
    its flag over the ranks."""
    plan = resolve_server_plan(cfg)
    return RuleOptions(
        num_byzantine=cfg.num_byzantine,
        trim=cfg.trim,
        num_selected=(
            max(num_participants - cfg.num_byzantine - 2, 1) if cfg.rule == "mkrum" else None
        ),
        use_kernels=plan.mode,
        afa=AFAConfig(
            xi0=cfg.xi0, delta_xi=cfg.delta_xi, variant=cfg.afa_variant,
            use_kernels=plan.mode, kernel_launch=plan.launch,
            client_mesh=client_mesh,
        ),
    )


def _absorb(state: ServerState, good_mask, mask0, *, delta: float, table=None) -> ServerState:
    """Fold one round's screening outcome into the Beta posteriors, the
    blocked set and the 1-indexed ``rounds_blocked`` bookkeeping."""
    rep = update_reputation(state.reputation, good_mask, mask0, delta=delta, table=table)
    rounds_blocked = mark_blocked_round(
        state.rounds_blocked, state.reputation.blocked, rep.blocked, state.round
    )
    return ServerState(rep, rounds_blocked, state.round + 1)


def _dispatch(state: ServerState, proposals, n_k, mask0, rule: str, opts: RuleOptions,
              layout: str):
    """The rule on the round's proposals, weighted by the reputation means.
    ``matrix`` and its alias ``packed`` take a ``(K, D)`` buffer; ``tree``
    (packed inside the dispatch) and ``leaf`` (per leaf) a stacked tree."""
    dev = state.rounds_blocked.device
    n32 = torch.as_tensor(n_k, dtype=torch.float32, device=dev)
    if layout in ("matrix", "packed"):
        return dispatch_rule(rule, proposals, n32, p_good(state.reputation), mask0, opts)
    if layout in ("tree", "leaf"):
        return dispatch_rule_tree(rule, proposals, n32, p_good(state.reputation), mask0, opts,
                                  layout="packed" if layout == "tree" else "leaf")
    raise ValueError(f"unknown layout {layout!r}; expected tree | leaf | matrix | packed")


def server_step(
    state: ServerState,
    proposals,
    n_k,
    mask0: torch.Tensor,
    *,
    rule: str,
    opts: RuleOptions,
    delta_block: float = 0.95,
    layout: str = "tree",
    block_table=None,
):
    """One server round: dispatch the rule, then (for reputation-driven
    rules) absorb the screening outcome.  ``proposals`` is a stacked tree
    (``layout="tree"``, packed inside the dispatch, or ``"leaf"``, the
    per-leaf path) or a ``(K, D)`` matrix (``"matrix"``, or its alias
    ``"packed"`` for a buffer the caller packed).  ``block_table`` None blocks by ``betainc`` on the host;
    the fused engines pass ``(table, alpha0, beta0)``
    (``core.reputation.update_reputation``).  Returns ``(state', result)``."""
    mask0 = torch.as_tensor(mask0, device=state.rounds_blocked.device)
    res = _dispatch(state, proposals, n_k, mask0, rule, opts, layout)
    if RULES[rule].updates_reputation:
        state = _absorb(state, res.good_mask, mask0, delta=delta_block, table=block_table)
    else:
        state = state._replace(round=state.round + 1)
    return state, res


def _absorb_weighted(state: ServerState, good_mask, mask0, weights, *,
                     delta: float) -> ServerState:
    """:func:`_absorb` with per-client evidence weights (the serving tier's
    staleness decay, ``weights = decay**tau``)."""
    rep = update_reputation_weighted(state.reputation, good_mask, mask0, weights, delta=delta)
    rounds_blocked = mark_blocked_round(
        state.rounds_blocked, state.reputation.blocked, rep.blocked, state.round
    )
    return ServerState(rep, rounds_blocked, state.round + 1)


def server_step_versioned(
    state: ServerState,
    proposals,
    n_k,
    mask0: torch.Tensor,
    versions,
    *,
    rule: str,
    opts: RuleOptions,
    delta_block: float = 0.95,
    layout: str = "matrix",
    staleness_decay: float = 1.0,
):
    """:func:`server_step` for asynchronous buffers, whose rows carry version
    stamps.

    ``versions`` is ``(K,)``: the round counter of the parameters each
    buffered update was trained against; its staleness is ``tau =
    state.round - version``, clipped at 0 (``state.round`` a Python int or
    the fused engines' 0-d tensor).  The rule judges the submitted updates as
    they are; the reputation absorbs each observation with weight
    ``staleness_decay ** tau`` in float32
    (``core.reputation.update_reputation_weighted``).  ``staleness_decay =
    1.0`` goes through :func:`_absorb` itself, so the synchronous case
    evolves the state exactly as the fused engine's round does (with
    ``betainc`` on the host in place of its table).  Entries of ``versions``
    for rows outside ``mask0`` are inert."""
    if not 0.0 < staleness_decay <= 1.0:
        raise ValueError(f"staleness_decay={staleness_decay!r} outside (0, 1]")
    dev = state.rounds_blocked.device
    mask0 = torch.as_tensor(mask0, device=dev)
    res = _dispatch(state, proposals, n_k, mask0, rule, opts, layout)
    if not RULES[rule].updates_reputation:
        return state._replace(round=state.round + 1), res
    if staleness_decay == 1.0:
        return _absorb(state, res.good_mask, mask0, delta=delta_block), res
    rnd = torch.as_tensor(state.round, dtype=torch.int32, device=dev)
    tau = torch.clamp(rnd - torch.as_tensor(versions, device=dev).to(torch.int32), min=0)
    weights = torch.pow(torch.tensor(staleness_decay, dtype=torch.float32, device=dev),
                        tau.to(torch.float32))
    return _absorb_weighted(state, res.good_mask, mask0, weights, delta=delta_block), res


class FedServer:
    """Stateful wrapper over ``server_step``: holds a ``ServerState`` on
    ``device`` and swaps it for the step's output each round.  The caller
    owns the model's (un)flattening."""

    def __init__(self, config: ServerConfig, *, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.state = init_server_state(
            config.num_clients, config.alpha0, config.beta0, device=self.device
        )

    @property
    def reputation(self) -> ReputationState:
        return self.state.reputation

    @property
    def blocked(self) -> np.ndarray:
        return self.state.reputation.blocked.cpu().numpy()

    @property
    def rounds_blocked(self) -> np.ndarray:
        return self.state.rounds_blocked.cpu().numpy()

    def select(self, rng: np.random.Generator | None = None, frac: float = 1.0) -> np.ndarray:
        """Per-round client selection among the un-blocked clients: all of
        them, or with ``rng`` and ``frac`` < 1 a sorted draw of
        ``max(1, round(frac * available))`` without replacement, the JAX
        package's draw from the same generator."""
        avail = np.nonzero(~self.blocked)[0]
        if frac >= 1.0 or rng is None:
            return avail
        m = max(1, int(round(frac * len(avail))))
        return np.sort(rng.choice(avail, size=m, replace=False))

    def participation_mask(self, selected: np.ndarray) -> np.ndarray:
        mask0 = np.zeros(self.cfg.num_clients, bool)
        mask0[selected] = True
        mask0 &= ~self.blocked
        return mask0

    def rule_options(self, mask0: np.ndarray) -> RuleOptions:
        return make_rule_options(self.cfg, int(mask0.sum()))

    def _apply(self, proposals, n_k, selected: np.ndarray, layout: str):
        mask0 = self.participation_mask(selected)
        self.state, res = server_step(
            self.state, proposals, n_k, torch.from_numpy(mask0).to(self.device),
            rule=self.cfg.rule, opts=self.rule_options(mask0),
            delta_block=self.cfg.delta_block, layout=layout,
        )
        info = {
            "good_mask": res.good_mask.cpu().numpy(),
            # empty participation round: the aggregate is a zero update and
            # the engine keeps the previous parameters
            "all_blocked": bool(res.all_blocked),
        }
        if RULES[self.cfg.rule].updates_reputation:
            info.update(
                rounds=int(res.rounds),
                similarities=res.similarities.cpu().numpy(),
                blocked=self.blocked.copy(),
                p_good=p_good(self.state.reputation).cpu().numpy(),
            )
        return res.aggregate, info

    def aggregate(self, updates: torch.Tensor, n_k, selected: np.ndarray):
        """One round over a ``(K, D)`` matrix of proposals; rows outside
        ``selected`` are ignored.  Returns (aggregate vector, info dict)."""
        return self._apply(updates, n_k, selected, "matrix")

    def aggregate_tree(self, stacked, n_k, selected: np.ndarray):
        """One round over a stacked tree of proposals: packed into one
        ``(K, D)`` buffer, or per leaf when the config's plan has
        ``layout="leaf"``; rows outside ``selected`` are ignored.  Returns
        (aggregate tree, info dict)."""
        layout = "leaf" if resolve_server_plan(self.cfg).layout == "leaf" else "tree"
        return self._apply(stacked, n_k, selected, layout)
