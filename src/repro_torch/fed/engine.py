"""The round engines: the proposal pipeline of the batched engine, and the
fused and segmented engines, whose round is captured once as a CUDA graph.

Counterpart of ``repro/fed/engine.py``.  Every engine trains the K clients
(``workload.local_update``), resets non-trainers to ``w_t`` and applies the
update-level attacks to the stacked proposals.

**Batched** (``make_train_attack_step``): seeded torch streams stand in for
``jax.random`` keys: client k's dropout masks in round r come from
``client_seeds(seed, r, ids)[k]``, keyed by (seed, round, original client
id); the byzantine noise from ``attack_seed(seed, r)`` plus (leaf, original
client id).  The host draws the minibatches.

**Fused** (``make_fused_sim``): the counterpart of the JAX package's
``lax.scan`` over rounds.  One round -- the device minibatch draw, local
training, the attacks, ``server_step`` with blocking on the device, the test
error -- is ``_round_body``, a function of device tensors that reads nothing
from the host.  On the card ``scan_fn`` captures it once as a CUDA graph over
static buffers (``_RoundProgram``: the body reads the round index from a
device scalar that it advances itself, writes the round's test error,
``good_mask`` and blocked set into ``(T,)`` and ``(T, K)`` buffers at that
index, and copies the new parameters and server state into the buffers the
next replay reads) and replays it T times; the host reads nothing until the
run ends.  A capture that fails raises: the engine never goes on eagerly.
On the CPU, which has no graphs, it runs the same body in a loop.
``round_fn`` is the body called once, the ``fused_eager`` engine's step
(``fused_eager_run`` calls it T times).
``make_packed_propose_fn`` is the body's proposal phase alone, for the
serving tier (``repro_torch.serve``).

**Segmented** (``make_fused_segment``): the same round graph replayed
``seg_len`` times from ``seg_start``, over a client axis the simulator has
compacted to a power-of-two bucket of the still-live clients; one capture
per bucket, so O(log K) captures a run (``make_fused_segment(...).programs``
holds them; ``analysis.retrace`` audits the bound).

**Client-sharded** (``make_fused_sim`` / ``make_fused_segment`` with
``client_mesh``, a ``launch.mesh.ClientMesh``): the counterpart of the JAX
package's ``shard_map`` branches.  Each rank holds its K / S rows of the
inputs, the server state, ``bad`` and ``client_ids``, and the parameters
whole; it runs the same round body, with the full K as the stride of the
keyed streams, AFA screening hierarchically over the mesh (``core/afa.py``)
and alie/ipm taking their benign moments over it.  The rounds run eagerly,
one body call a round, with AFA's stopping loop (nothing is captured, so a
pass may read the host, and the passes after screening stops, three
all-reduces each, are not run); the ``(T, K)`` ``good_mask`` and
blocked trajectory is gathered over the ranks (``ClientMesh.gather_rows``),
the state stays this rank's rows.  A one-shard mesh runs the unsharded
code.

**Seed sweeps** (``sweep_fused_sim``): ``scan_fn`` once per seed, every
seed replaying the one captured program with its own seed loaded.

Random streams of the fused engines are keyed Philox streams
(``utils/philox.py``): ``(seed, stream, round * K + original client id,
element)`` for the minibatch indices, the dropout masks and the byzantine
noise, with K the full client count.  They depend on a client's id, never on
its row, so compaction changes the layout only; they are not the batched
engine's streams, nor ``jax.random``'s.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.attacks import (
    UPDATE_ATTACK_SCENARIOS,
    apply_update_attack,
    byzantine_update_keyed,
    stream_seed,
)
from repro_torch.core import blocking_table
from repro_torch.fed.server import ServerState, init_server_state, server_step
from repro_torch.utils.philox import keyed_randint
from repro_torch.utils.regions import ROUND_BODY, region
from repro_torch.utils.trees import (
    pack_stack,
    tree_broadcast_clients,
    tree_map,
    tree_select_rows,
    unpack_stack,
)

_CLIENT_STREAM = 0xC11E47
_ROUND_ATTACK_STREAM = 0xA7
_BATCH_STREAM = 0x0B47C4    # the fused engines' device minibatch draws
ROUNDS_RANGE = "fused_rounds"  # profiler range around the fused rounds (no capture)


# scenarios with a client-sharded form: the first four touch only their own
# client row; alie/ipm make their benign moments global in one all-reduce
SHARDABLE_SCENARIOS = ("clean", "flipping", "noisy", "byzantine", "alie", "ipm")


class FusedData(NamedTuple):
    """Device-resident inputs of a round loop over padded client shards."""

    x: torch.Tensor        # (K, n_max, *feat) zero-padded client shards
    y: torch.Tensor        # (K, n_max, *lab) integer labels
    lengths: torch.Tensor  # (K,) integer live rows per shard
    n_k: torch.Tensor      # (K,) float32 aggregation data weights
    x_test: torch.Tensor   # (n_test, *feat)
    y_test: torch.Tensor   # (n_test, *lab) integer labels


class EngineConfig(NamedTuple):
    """Knobs of the round step."""

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


# ---------------------------------------------------------------------------
# fused engine — one round captured as a CUDA graph, replayed T times
# ---------------------------------------------------------------------------


class FusedTrajectory(NamedTuple):
    """Per-round outputs (leading axis T)."""

    test_error: torch.Tensor  # (T,) fraction in [0, 1]
    good_mask: torch.Tensor   # (T, K) bool — rule's kept-set each round
    blocked: torch.Tensor     # (T, K) bool — blocked set AFTER each round


def _propose_round(workload, cfg: EngineConfig, num_clients_total, batch_s, batch_b,
                   params, blocked, rnd, seed, data: FusedData, bad, client_ids, mesh=None):
    """One round's proposal phase: participation masks, the keyed device
    minibatch draw (per-client upper bound ``lengths[k]``; pad rows carry
    length 1), local training, non-trainers reset to ``w_t`` and the
    update-level attack on the packed buffer (over the client ``mesh``
    when the rows are one rank's of several).  Returns ``(packed (R, D),
    pack spec, mask0)``."""
    skip_bad = cfg.scenario in UPDATE_ATTACK_SCENARIOS
    mask0 = ~blocked
    train_mask = mask0 & ~bad if skip_bad else mask0
    R = client_ids.shape[0]
    offsets = rnd * num_clients_total + client_ids
    idx = keyed_randint(seed, _BATCH_STREAM, offsets, batch_s * batch_b, data.lengths)
    idx = idx.reshape(R, batch_s, batch_b)
    rows = torch.arange(R, device=idx.device)[:, None, None]
    batch = {"x": data.x[rows, idx], "y": data.y[rows, idx]}
    proposals = workload.local_update_keyed(cfg, params, batch, seed, offsets)
    w_prev = workload.codec.proposal_of(params)
    proposals = tree_select_rows(train_mask, proposals, tree_broadcast_clients(w_prev, R))
    pspec = workload.delta_spec(params)
    packed = pack_stack(proposals, pspec)
    w_row = pack_stack(tree_map(lambda l: l[None], w_prev), pspec)[0]
    bad_live = bad & mask0
    if cfg.scenario == "byzantine":
        packed = byzantine_update_keyed(packed, w_row, bad_live, seed, offsets,
                                        scale=cfg.byzantine_scale)
    else:
        packed = apply_update_attack(cfg.scenario, packed, w_row, bad_live, mask0 & ~bad, 0,
                                     z_max=cfg.alie_z_max, eps=cfg.ipm_eps, mesh=mesh)
    return packed, pspec, mask0


@functools.lru_cache(maxsize=32)
def make_packed_propose_fn(workload, cfg: EngineConfig, num_clients_total, batch_s, batch_b):
    """The serving tier's cohort computation::

        propose(params, blocked, rnd, seed, data, bad, client_ids) -> (R, D)

    the proposal phase of the fused round body (:func:`_propose_round`: the
    keyed minibatch draw, local training, the update-level attack) on the
    packed buffer, so a row equals, bit for bit, the row that the fused body
    aggregates at round ``rnd``.  Blocked rows hold the packed current
    proposal point w_t.  ``blocked`` and ``bad`` are ``(R,)`` bool and
    ``client_ids`` ``(R,)`` int64 device tensors, ``rnd`` and ``seed`` 0-d
    int64 device tensors.  It takes the workloads with a keyed local update
    (the DNN and LoRA); any other raises, as on the fused engines."""

    def propose(params, blocked, rnd, seed, data: FusedData, bad, client_ids):
        packed, _, _ = _propose_round(workload, cfg, int(num_clients_total), int(batch_s),
                                      int(batch_b), params, blocked, rnd, seed, data, bad,
                                      client_ids)
        return packed

    return propose


def _round_body(workload, cfg: EngineConfig, rule, opts, delta_block, block_table,
                num_clients_total, batch_s, batch_b, attack_mesh, carry, rnd, seed,
                data: FusedData, bad, client_ids, layout: str = "packed"):
    """ONE fused round over a (possibly compacted) client layout of R rows:
    ``bad`` and ``client_ids`` are ``(R,)`` device tensors, ``rnd`` a 0-d
    int64 device tensor, ``seed`` a 0-d int64 device tensor, and
    ``num_clients_total`` the full K, the stride of the keyed streams
    (``attack_mesh``: the client mesh alie/ipm sum over, or None).  The
    packed ``(R, D)`` proposals go through ``server_step`` (blocking from
    ``block_table``); with no live client the aggregate keeps the previous
    proposal point (a ``torch.where``, not a host branch).  ``layout`` is
    the aggregation representation (``ServerConfig.agg_layout``, as the
    reference's ``_round_body`` takes it): ``"packed"`` dispatches the
    rule's matrix form on the packed buffer, ``"tree"`` hands the stacked
    tree to the tree dispatch, which packs it again (the same bits), and
    ``"leaf"`` runs AFA's tree form on the leaves.  Returns
    ``((params', state'), FusedTrajectory row)``."""
    params, state = carry
    packed, pspec, mask0 = _propose_round(
        workload, cfg, num_clients_total, batch_s, batch_b, params,
        state.reputation.blocked, rnd, seed, data, bad, client_ids, attack_mesh,
    )
    if layout == "packed":
        state, res = server_step(state, packed, data.n_k, mask0, rule=rule, opts=opts,
                                 delta_block=delta_block, layout="matrix",
                                 block_table=block_table)
        new = unpack_stack(res.aggregate, pspec)
    else:
        state, res = server_step(state, unpack_stack(packed, pspec), data.n_k, mask0,
                                 rule=rule, opts=opts, delta_block=delta_block, layout=layout,
                                 block_table=block_table)
        new = res.aggregate
    w_prev = workload.codec.proposal_of(params)
    aggregate = tree_map(lambda prev, new: torch.where(res.all_blocked, prev, new),
                         w_prev, new)
    params = workload.codec.apply(params, aggregate)
    err = workload.eval_metric(params, data.x_test, data.y_test)
    return (params, state), FusedTrajectory(err, res.good_mask, state.reputation.blocked)


def fused_server_state(num_clients: int, alpha0: float, beta0: float, device) -> ServerState:
    """Round-0 server state with its round counter a 0-d int32 tensor on
    ``device``, as the fused engines carry it."""
    state = init_server_state(num_clients, alpha0, beta0, device=device)
    return state._replace(round=torch.zeros((), dtype=torch.int32, device=device))


def _device_seed(seed: int, device) -> torch.Tensor:
    return torch.full((), int(seed), dtype=torch.int64, device=device)


def _clone_state(state: ServerState) -> ServerState:
    return ServerState(state.reputation._replace(
        alpha=state.reputation.alpha.clone(), beta=state.reputation.beta.clone(),
        blocked=state.reputation.blocked.clone()),
        state.rounds_blocked.clone(), state.round.clone())


def _copy_state_(dst: ServerState, src: ServerState) -> None:
    for d, s in ((dst.reputation.alpha, src.reputation.alpha),
                 (dst.reputation.beta, src.reputation.beta),
                 (dst.reputation.blocked, src.reputation.blocked),
                 (dst.rounds_blocked, src.rounds_blocked), (dst.round, src.round)):
        d.copy_(s)


def _copy_tree_(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


class _RoundProgram:
    """The round body over static buffers, for one client layout.

    The program owns its buffers: copies of the parameters, the server
    state, the inputs and the seed it was built with.  ``load()`` copies
    another run's into them (any seed, any data of the same layout), so one
    program, and on the card one capture, serves every run of its layout.
    ``step()`` runs one round: the body reads the parameters, server state,
    seed, round index and inputs from the buffers, then writes the round's
    outputs into the trajectory at the round index, copies the new
    parameters and state over the old ones and advances the index.
    ``capture()`` records ``step()`` as a CUDA graph: one warm-up round on
    the capture stream (it builds the kernel library, loads the kernels,
    creates the stream's ticket counter of ``kernels.ops`` and lets autograd
    settle), the buffers restored, then the capture, in a private memory
    pool.  ``run()`` replays the graph, or on the CPU calls ``step()``, once
    per round."""

    def __init__(self, body, params, state: ServerState, seed: int, data: FusedData, bad,
                 client_ids, num_rounds: int):
        dev = client_ids.device
        self.body = body
        self.params = tree_map(lambda l: l.clone(), params)
        self.state = _clone_state(state)
        self.seed = _device_seed(seed, dev)
        self.data = FusedData(*(t.clone() for t in data))
        self.bad, self.ids = bad.clone(), client_ids.clone()
        self.rnd = torch.zeros((), dtype=torch.int64, device=dev)
        R = client_ids.shape[0]
        self.traj = FusedTrajectory(
            torch.zeros((num_rounds,), dtype=torch.float32, device=dev),
            torch.zeros((num_rounds, R), dtype=torch.bool, device=dev),
            torch.zeros((num_rounds, R), dtype=torch.bool, device=dev),
        )
        self.graph = None
        self.capture_s = 0.0

    def step(self) -> None:
        (params, state), out = self.body((self.params, self.state), self.rnd, self.seed,
                                         self.data, self.bad, self.ids)
        at = self.rnd.reshape(1)
        for buf, val in zip(self.traj, out):
            buf.index_copy_(0, at, val.reshape((1,) + tuple(buf.shape[1:])).to(buf.dtype))
        _copy_tree_(self.params, params)
        _copy_state_(self.state, state)
        self.rnd.add_(1)

    def load(self, params, state: ServerState, seed: int, data: FusedData, bad, client_ids,
             start: int) -> None:
        """Set the buffers for a run from round ``start``."""
        _copy_tree_(self.params, params)
        _copy_state_(self.state, state)
        self.seed.fill_(int(seed))
        for buf, new in zip((*self.data, self.bad, self.ids), (*data, bad, client_ids)):
            buf.copy_(new)
        self.rnd.fill_(int(start))

    def capture(self) -> None:
        dev = self.ids.device
        t0 = time.perf_counter()
        saved = (tree_map(lambda l: l.clone(), self.params), _clone_state(self.state),
                 self.rnd.clone(), [t.clone() for t in self.traj])
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        _copy_tree_(self.params, saved[0])
        _copy_state_(self.state, saved[1])
        self.rnd.copy_(saved[2])
        for buf, old in zip(self.traj, saved[3]):
            buf.copy_(old)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.step()
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self, count: int) -> None:
        # a named range, so that a profiler trace can tell the rounds from
        # the capture's warm-up round (free when no profiler is on)
        with torch.profiler.record_function(ROUNDS_RANGE):
            for _ in range(count):
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self.step()

    def outputs(self, start: int, count: int):
        """Copies of the parameters, the state and rounds ``start ..
        start + count`` of the trajectory."""
        traj = FusedTrajectory(*(t[start:start + count].clone() for t in self.traj))
        return tree_map(lambda l: l.clone(), self.params), _clone_state(self.state), traj


def _program_runner(body, num_rounds: int, device: torch.device):
    """``run(params, state, seed, data, bad, client_ids, start, count) ->
    ((params', state', traj), capture_s)``: rounds ``start .. start + count``
    of ``body`` over the layout the arguments carry, on one program per
    row count R, built (and on the card captured) at its first run;
    ``capture_s`` is the seconds of a capture made in the call, else 0.
    ``run.programs`` holds the programs by R (``analysis.retrace`` counts
    them)."""
    programs: dict = {}

    def run(params, state, seed, data, bad, client_ids, start: int, count: int):
        rows = int(client_ids.shape[0])
        prog = programs.get(rows)
        capture_s = 0.0
        if prog is None:
            prog = programs[rows] = _RoundProgram(body, params, state, seed, data, bad,
                                                  client_ids, num_rounds)
            if device.type == "cuda":
                prog.capture()
                capture_s = prog.capture_s
        prog.load(params, state, seed, data, bad, client_ids, start)
        prog.run(int(count))
        return prog.outputs(int(start), int(count)), capture_s

    run.programs = programs
    return run


def _body(workload, cfg, rule, opts, delta_block, num_clients_total, batch_s, batch_b,
          alpha0, beta0, num_rounds, device, client_mesh=None, layout: str = "packed"):
    """The round body with its static configuration bound: the rule asked
    for no host read (``RuleOptions.capturable``) unless the body runs
    eagerly over a client mesh, its Gram kernels to plan for the run's full
    K in every bucket (``RuleOptions.plan_rows``), the blocking table
    (counts up to ``num_rounds``) on ``device``, and the client mesh the
    attacks sum over when it has more than one shard (a one-shard mesh runs
    the unsharded attacks bit for bit), and the aggregation ``layout``."""
    table = torch.from_numpy(blocking_table(alpha0, beta0, delta_block, num_rounds)).to(device)
    block = (table, float(alpha0), float(beta0))
    opts = opts._replace(capturable=client_mesh is None, plan_rows=int(num_clients_total))
    attack_mesh = client_mesh if client_mesh is not None and client_mesh.num_shards > 1 else None

    def body(carry, rnd, seed, data, bad, client_ids):
        with region(ROUND_BODY):
            return _round_body(workload, cfg, rule, opts, delta_block, block, num_clients_total,
                               batch_s, batch_b, attack_mesh, carry, rnd, seed, data, bad,
                               client_ids, layout)

    return body


def _validate_client_mesh(mesh, cfg: EngineConfig, rule: str, num_rows: int,
                          layout: str = "packed") -> None:
    """The checks of the client-sharded fused engines (``KernelPlan``
    checks ``layout``'s name)."""
    if mesh is None:
        return
    if layout != "packed":
        raise ValueError("the client-sharded engine packs once a round and requires the "
                         f"packed layout (got {layout!r})")
    if mesh.num_shards > 1:
        if cfg.scenario not in SHARDABLE_SCENARIOS:
            raise ValueError(f"scenario {cfg.scenario!r} has no client-sharded form "
                             f"(supported: {SHARDABLE_SCENARIOS})")
        if rule != "afa":
            raise ValueError(f"rule {rule!r} has no client-sharded form; only 'afa' screens "
                             "hierarchically over the client mesh")
    if num_rows % mesh.num_shards != 0:
        raise ValueError(f"client rows ({num_rows}) must divide evenly over the "
                         f"{mesh.num_shards} client shards")


def _gather_trajectory(mesh, traj: FusedTrajectory, total: int) -> FusedTrajectory:
    """The ``(T, total)`` trajectory from every rank's ``(T, total / S)``
    rows, in one all-reduce; the test error is the same on every rank."""
    local = torch.stack([traj.good_mask, traj.blocked], dim=-1).transpose(0, 1)
    both = mesh.gather_rows(local.to(torch.uint8).contiguous(), total).transpose(0, 1)
    return FusedTrajectory(traj.test_error, both[..., 0].bool(), both[..., 1].bool())


def _sharded_runner(body, mesh, device: torch.device):
    """``run(params, state, seed, data, bad, client_ids, start, count) ->
    (params', state', traj)``: rounds ``start .. start + count`` of
    ``body`` on this rank's rows, one body call a round; the trajectory is
    gathered over the mesh.  Nothing is captured, so ``stats`` gets
    nothing."""

    def run(params, state, seed, data, bad, client_ids, start: int, count: int, *,
            stats=None):
        seed_t = _device_seed(seed, device)
        carry, outs = (params, state), []
        with torch.profiler.record_function(ROUNDS_RANGE):
            for rnd in range(int(start), int(start) + int(count)):
                carry, out = body(carry, torch.full((), rnd, dtype=torch.int64, device=device),
                                  seed_t, data, bad, client_ids)
                outs.append(out)
        traj = FusedTrajectory(*[torch.stack(parts) for parts in zip(*outs)])
        return carry[0], carry[1], _gather_trajectory(
            mesh, traj, int(client_ids.shape[0]) * mesh.num_shards)

    return run


def make_fused_sim(
    workload,
    cfg: EngineConfig,
    *,
    rule: str,
    opts,                      # repro_torch.core.RuleOptions, built once with K
    delta_block: float,
    num_clients: int,
    num_rounds: int,
    batch_s: int,
    batch_b: int,
    bad_mask: np.ndarray,
    alpha0: float = 3.0,
    beta0: float = 3.0,
    device="cuda",
    client_mesh=None,
    layout: str = "packed",
):
    """Build the fused T-round simulation on ``device``.

    Returns ``(scan_fn, round_fn)``:

    * ``scan_fn(params0, seed, data, *, stats=None) -> (params_T, state_T,
      traj)``: all T rounds from the int ``seed``, the round captured as a
      CUDA graph at the first call and replayed on the card, looped on the
      CPU; later calls, with any seed and data of the same shapes, replay
      the same graph.  ``stats``, a dict, receives ``capture_s`` (warm-up
      round and capture made in the call, in seconds).
    * ``round_fn(carry, rnd, seed, data) -> (carry', out)``: the round body
      called once (``rnd`` and ``seed`` 0-d int64 tensors on ``device``), the
      ``fused_eager`` engine's step.

    Blocked clients keep their row and are excluded by mask; the segmented
    form (:func:`make_fused_segment`) compacts them away.

    With ``client_mesh`` (``opts`` built with the same mesh,
    ``fed.server.make_rule_options``) the simulation is this rank's: ``data``
    holds its K / S rows (``bad_mask`` is the full K), ``scan_fn`` runs the
    rounds eagerly and returns this rank's state rows and the gathered
    ``(T, K)`` trajectory, and ``round_fn`` is None.  ``layout``: the
    aggregation representation (``_round_body``; a client mesh packs)."""
    device = torch.device(device)
    K, T = int(num_clients), int(num_rounds)
    _validate_client_mesh(client_mesh, cfg, rule, K, layout)
    bad = torch.from_numpy(np.asarray(bad_mask, bool)).to(device)
    ids = torch.arange(K, dtype=torch.int64, device=device)
    body = _body(workload, cfg, rule, opts, delta_block, K, int(batch_s), int(batch_b),
                 alpha0, beta0, T, device, client_mesh, layout)
    if client_mesh is not None:
        rows = K // client_mesh.num_shards
        block = client_mesh.row_block(rows)
        bad, ids = bad[block], ids[block]
        runner = _sharded_runner(body, client_mesh, device)

        def sharded_scan_fn(params0, seed, data: FusedData, *, stats=None):
            state0 = fused_server_state(rows, alpha0, beta0, device)
            return runner(params0, state0, seed, data, bad, ids, 0, T)

        return sharded_scan_fn, None
    runner = _program_runner(body, T, device)

    def round_fn(carry, rnd, seed, data: FusedData):
        return body(carry, rnd, seed, data, bad, ids)

    def scan_fn(params0, seed, data: FusedData, *, stats=None):
        state0 = fused_server_state(K, alpha0, beta0, device)
        out, capture_s = runner(params0, state0, seed, data, bad, ids, 0, T)
        if stats is not None:
            stats["capture_s"] = capture_s
        return out

    return scan_fn, round_fn


def fused_eager_run(round_fn, params0, state0: ServerState, seed: int, data: FusedData,
                    num_rounds: int):
    """The ``fused_eager`` engine: ``round_fn`` called once per round from
    ``(params0, state0)``, the reference a replayed graph is held to.
    Returns ``(params_T, state_T, traj)`` as ``scan_fn`` does."""
    dev = state0.rounds_blocked.device
    seed_t = _device_seed(seed, dev)
    carry, outs = (params0, state0), []
    for rnd in range(int(num_rounds)):
        carry, out = round_fn(carry, torch.full((), rnd, dtype=torch.int64, device=dev),
                              seed_t, data)
        outs.append(out)
    return carry[0], carry[1], FusedTrajectory(*[torch.stack(parts) for parts in zip(*outs)])


def _stack_runs(items):
    """Per-run outputs (tensors, dicts of them, NamedTuples of them) ->
    one with a leading run axis on every tensor."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack_runs([it[k] for it in items]) for k in first}
    return type(first)(*(_stack_runs(list(parts)) for parts in zip(*items)))


def sweep_fused_sim(scan_fn, workload, seeds, data: FusedData, *, stats=None):
    """The fused simulation for every seed of ``seeds``: the counterpart of
    the JAX package's ``vmap`` over a seed axis, as a loop of ``scan_fn``
    over one captured program (one capture a sweep).

    Each seed drives the model init (``workload.init_params`` from a
    generator on the data's device seeded with it), the device minibatch
    stream and the attack-noise stream; the shard split is the caller's and
    fixed across the sweep.  Returns ``(params_T, state_T, traj)`` with a
    leading ``len(seeds)`` axis on every tensor; ``stats``, a dict,
    receives the sweep's ``capture_s``."""
    dev = data.x.device
    outs, capture_s = [], 0.0
    for s in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(s))
        one: dict = {}
        outs.append(scan_fn(workload.init_params(gen, dev), int(s), data, stats=one))
        capture_s += one["capture_s"]
    if stats is not None:
        stats["capture_s"] = capture_s
    return tuple(_stack_runs(list(parts)) for parts in zip(*outs))


def make_fused_segment(
    workload,
    cfg: EngineConfig,
    *,
    rule: str,
    opts,
    delta_block: float,
    num_clients_total: int,
    num_rounds: int,
    batch_s: int,
    batch_b: int,
    alpha0: float = 3.0,
    beta0: float = 3.0,
    device="cuda",
    client_mesh=None,
    layout: str = "packed",
):
    """Build the segments of the fused simulation on ``device``.

    Returns ``segment_fn(params, state, seed, data, bad, client_ids,
    seg_start, seg_len, *, stats=None) -> (params', state', traj)``: rounds
    ``seg_start .. seg_start + seg_len`` of the round body over the client
    layout the arguments carry (R rows: ``data``, ``state``, ``bad`` and
    ``client_ids``, the rows' original ids), ``seed`` the run's int seed.
    Unlike the JAX package's, ``seg_len`` is an argument: one round is
    captured, and the segment replays it.  One program, and on the card one
    capture, per R: a bucket of the segmented simulator's compaction, so
    O(log K) a run, for any seed (a seed sweep shares them).  ``stats``,
    a dict, has the seconds of a capture made in the call added to its
    ``capture_s``.

    Compaction contract (the simulator keeps it): ``client_ids[:K_live]``
    are the live original ids ascending; pad rows are blocked in ``state``,
    with zero shards of length 1 in ``data``.  The keyed streams then give
    every live client the draws of the uncompacted run.

    With ``client_mesh`` the client layout is this rank's R / S rows of a
    per-shard compaction (``data.shard_compact_plan``, whose ``-1`` pads
    are blocked); the segment runs eagerly and returns this rank's state
    rows and the ``(seg_len, R)`` trajectory gathered over the mesh.
    ``layout`` as ``make_fused_sim``'s."""
    device = torch.device(device)
    _validate_client_mesh(client_mesh, cfg, rule, int(num_clients_total), layout)
    body = _body(workload, cfg, rule, opts, delta_block, int(num_clients_total), int(batch_s),
                 int(batch_b), alpha0, beta0, int(num_rounds), device, client_mesh, layout)
    if client_mesh is not None:
        return _sharded_runner(body, client_mesh, device)
    runner = _program_runner(body, int(num_rounds), device)

    def segment_fn(params, state, seed, data: FusedData, bad, client_ids, seg_start: int,
                   seg_len: int, *, stats=None):
        out, capture_s = runner(params, state, seed, data, bad, client_ids, seg_start, seg_len)
        if stats is not None and capture_s:
            stats["capture_s"] = stats.get("capture_s", 0.0) + capture_s
        return out

    segment_fn.programs = runner.programs
    return segment_fn
