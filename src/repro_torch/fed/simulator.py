"""Paper-scale federated simulator: K clients x T rounds over a synthetic
dataset, in the clean / byzantine / flipping / noisy / alie / ipm scenarios.

Counterpart of ``repro/fed/simulator.py``.  Four round engines, selected
by ``SimConfig.engine``:

* ``batched`` (default) -- each round trains all K clients at once on
  stacked parameters, applies the update-level attacks on the stacked
  proposals and aggregates through the packed registry dispatch; the host
  draws the minibatches and reads the round's outcome.
* ``looped`` -- the reference for the batched engine's client layer: each
  round trains the clients one at a time (``workload.local_update`` on a
  one-row stack, with the batched engine's minibatch indices and per-client
  seeds), stacks their proposals, applies the same update-level attack and
  aggregates through the same ``FedServer.aggregate_tree``, so the two
  engines differ only in how the clients are trained.
* ``fused`` -- the whole T-round simulation as one round body that reads
  nothing from the host (``fed/engine.make_fused_sim``): on the card one
  CUDA graph, captured once and replayed T times, on the CPU the same body
  in a loop.  With ``segment_rounds > 0`` the rounds run in segments, and
  with ``compact`` the host reads the blocked set between segments and
  compacts blocked clients out of the client axis (power-of-two buckets,
  streams keyed by original id): the same trajectory, paying only for live
  clients.
* ``fused_eager`` -- the fused round body called one round at a time, the
  reference the graph is held to.

``SimConfig.client_shards = S > 0`` (``engine="fused"`` only) runs the
fused engine client-sharded, as the JAX package's ``shard_map`` engine:
the caller runs ``simulate`` on each of S ranks of an initialized
``torch.distributed`` group (``repro_torch.launch.shards.run_sharded``
starts one), each rank holds the rows of K / S clients, AFA screens
hierarchically over the ranks, and every rank returns the whole result.
Segmented, the blocked clients are compacted PER SHARD
(``data.shard_compact_plan``): the live ids are spread over S equal
power-of-two blocks, whose ``-1`` pad slots stay blocked; every rank
gathers the blocked set and computes the same plan.

``_Setup`` consumes ONE numpy stream exactly as the JAX package does (the
noisy-features poisoning first, then, on the batched and looped engines,
the minibatch indices of the trainers in ascending order, byzantine clients
skipping training), so the shards and those engines' minibatches equal the
JAX run's; only the torch-side streams (init, dropout, byzantine noise) differ.
The fused engines draw minibatches, dropout masks and byzantine noise from
keyed Philox streams on the device (``utils/philox.py``), as the JAX
package's fused engines draw theirs from ``jax.random``; the two packages'
fused runs agree in distribution, not bit for bit.  The fused engines fill
``round_time`` as total / T (capture included; ``capture_time`` apart) and
leave ``train_time`` and ``agg_time`` at 0.

``sweep`` runs the fused simulation once for every seed of a list (each
seed's init and keyed streams, the shards of ``sim.seed``), replaying one
captured program, segmented with compaction on the union of the clients live
in any seed when ``segment_rounds > 0``; ``run_sweep`` and ``run_simulation``
are the JAX package's deprecated shims.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.attacks import (
    UPDATE_ATTACK_SCENARIOS,
    apply_update_attack,
    flip_labels,
    noisy_features,
)
from repro_torch.data import (
    SyntheticClassification,
    compact_stack,
    dirichlet_shards,
    iid_shards,
    padded_stack,
    pow2_bucket,
    shard_compact_plan,
)
from repro_torch.fed.engine import (
    EngineConfig,
    FusedData,
    attack_seed,
    client_seeds,
    fused_eager_run,
    fused_server_state,
    make_fused_segment,
    make_fused_sim,
    make_train_attack_step,
    sweep_fused_sim,
)
from repro_torch.fed.server import (
    FedServer,
    ServerConfig,
    ServerState,
    gather_server_state,
    make_rule_options,
    resolve_server_plan,
    scatter_server_state,
)
from repro_torch.fed.workload import DnnWorkload
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.utils.trees import tree_map, tree_stack


@dataclasses.dataclass
class SimConfig:
    num_clients: int = 10
    bad_frac: float = 0.3
    scenario: str = "clean"      # clean | byzantine | flipping | noisy | alie | ipm
    rounds: int = 30
    local_epochs: int = 10
    batch_size: int = 200
    lr: float = 0.1
    momentum: float = 0.9
    dropout: bool = True
    byzantine_scale: float = 20.0
    seed: int = 0
    hidden: tuple = (512, 256)
    sharding: str = "iid"        # iid | dirichlet (non-IID label skew)
    dirichlet_alpha: float = 0.5
    engine: str = "batched"      # batched | looped | fused | fused_eager
    # fused engine only: > 0 runs the rounds in segments of this many, with
    # the blocked clients compacted out of the client axis between segments
    # when ``compact`` is set (0 = one run of T rounds, no compaction)
    segment_rounds: int = 0
    compact: bool = True
    # fused engine only: > 0 splits the clients over this many ranks of the
    # caller's process group (repro_torch.launch.shards.run_sharded)
    client_shards: int = 0


@dataclasses.dataclass
class SimResult:
    test_error: list            # per round, percent
    train_time: float           # mean per round: local training (+ attacks)
    agg_time: float             # mean per round: server aggregation
    blocked_round: np.ndarray   # (K,) round at which blocked (-1 = never)
    bad_clients: np.ndarray     # indices
    good_mask_history: list
    detection_rate: float       # fraction of bad clients blocked by the end
    mean_rounds_to_block: float
    round_time: float = 0.0     # mean per round: batch draw + train +
                                # aggregate + eval
    round_times: list = dataclasses.field(default_factory=list)  # raw per-round
    capture_time: float = 0.0   # fused engine on the card: seconds spent capturing
                                # the round graphs (a warm-up round each included)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Setup:
    """Shared experiment state (shards, poisoning, model, batch geometry)."""

    def __init__(self, data: SyntheticClassification, sim: SimConfig, device,
                 workload=None):
        self.rng = np.random.default_rng(sim.seed)
        self.sim = sim
        self.device = device
        K = sim.num_clients
        n_bad = int(round(sim.bad_frac * K))
        self.bad = np.arange(n_bad)  # deterministic: first n_bad clients are bad
        self.bad_mask = np.zeros(K, bool)
        self.bad_mask[self.bad] = True

        if sim.sharding == "dirichlet":
            shards = dirichlet_shards(
                data.x_train, data.y_train, K, alpha=sim.dirichlet_alpha, seed=sim.seed
            )
        else:
            shards = iid_shards(data.x_train, data.y_train, K, seed=sim.seed)
        binary = data.num_classes == 2
        # data-level poisoning (consumes self.rng before any minibatch draw)
        self.poisoned = []
        for k, (x, y) in enumerate(shards):
            if self.bad_mask[k] and sim.scenario == "flipping":
                x, y = flip_labels(x, y)
            elif self.bad_mask[k] and sim.scenario == "noisy":
                x, y = noisy_features(x, y, self.rng, binary=binary)
            self.poisoned.append((x, y))

        out_units = 1 if binary else data.num_classes
        self.sizes = (data.dim, *sim.hidden, out_units)
        self.workload = workload if workload is not None else DnnWorkload(self.sizes)
        gen = torch.Generator(device=device)
        gen.manual_seed(sim.seed)
        self.params0 = self.workload.init_params(gen, device)
        self.n_k = np.asarray([len(x) for x, _ in self.poisoned], np.float32)
        self.x_test = torch.from_numpy(data.x_test).to(device)
        self.y_test = torch.from_numpy(data.y_test.astype(np.int64)).to(device)

        # shards as padded stacks, on the host (the segmented engine compacts
        # them) and on the device, where each round gathers its minibatches;
        # a sharded run moves only its rows there (``_compact_inputs``)
        lens = [len(x) for x, _ in self.poisoned]
        self.padded = padded_stack(self.poisoned)
        if sim.client_shards <= 0:
            self.x_pad = torch.from_numpy(self.padded[0]).to(device)
            self.y_pad = torch.from_numpy(self.padded[1].astype(np.int64)).to(device)

        # uniform per-round minibatch geometry, keyed to the MEAN shard;
        # sampling is with replacement
        self.batch_b = min(sim.batch_size, max(lens))
        self.batch_s = sim.local_epochs * max(int(np.mean(lens)) // sim.batch_size, 1)

    def trainers(self, selected) -> list:
        """Selected clients that run local SGD this round, ascending
        (update-level attackers send forged updates instead)."""
        skip_bad = self.sim.scenario in UPDATE_ATTACK_SCENARIOS
        return [int(k) for k in selected if not (skip_bad and self.bad_mask[k])]

    def draw_indices(self, trainers: list) -> dict:
        """Consume the shared numpy stream, as the JAX engines do."""
        out = {}
        for k in trainers:
            x, _ = self.poisoned[k]
            out[k] = self.rng.integers(0, len(x), size=(self.batch_s, self.batch_b))
        return out

    def client_batch(self, k: int, ix: np.ndarray) -> dict:
        """Client k's minibatches ``(1, S, b, ...)`` from its drawn indices,
        on the device: the batched engine's row k."""
        ix = torch.from_numpy(ix).to(self.device)
        return {"x": self.x_pad[k][ix][None], "y": self.y_pad[k][ix][None]}

    def batch(self, idx: dict) -> dict:
        """Device minibatches ``(K, S, b, ...)``; non-trainer rows gather
        index 0 (their proposals are reset to ``w_t`` anyway)."""
        K = self.sim.num_clients
        full = np.zeros((K, self.batch_s, self.batch_b), np.int64)
        for k, ix in idx.items():
            full[k] = ix
        ix = torch.from_numpy(full).to(self.device)
        rows = torch.arange(K, device=self.device)[:, None, None]
        return {"x": self.x_pad[rows, ix], "y": self.y_pad[rows, ix]}

    def engine_config(self) -> EngineConfig:
        s = self.sim
        return EngineConfig(
            scenario=s.scenario, lr=s.lr, momentum=s.momentum, dropout=s.dropout,
            byzantine_scale=s.byzantine_scale,
        )

    def result(self, blocked_round, test_error, good_hist, t_train, t_agg,
               round_times) -> SimResult:
        sim, bad = self.sim, self.bad
        rate, mean_rounds = detection_stats(blocked_round, bad)
        return SimResult(
            test_error=test_error,
            train_time=t_train / sim.rounds,
            agg_time=t_agg / sim.rounds,
            blocked_round=blocked_round,
            bad_clients=bad,
            good_mask_history=good_hist,
            detection_rate=rate,
            mean_rounds_to_block=mean_rounds,
            round_time=float(np.mean(round_times)) if round_times else 0.0,
            round_times=list(round_times),
        )


def detection_stats(blocked_round: np.ndarray, bad: np.ndarray):
    """(detection rate, mean rounds-to-block) over the bad-client set;
    ``blocked_round`` is 1-indexed, -1 = never blocked."""
    blocked_round = np.asarray(blocked_round)
    bad = np.asarray(bad, dtype=np.int64)
    if len(bad) == 0:
        return float("nan"), float("nan")
    det = blocked_round[bad] > 0
    rate = float(det.mean())
    mean_rounds = float(blocked_round[bad][det].mean()) if det.any() else float("nan")
    return rate, mean_rounds


_ENGINES = ("batched", "looped", "fused", "fused_eager")


def simulate(data: SyntheticClassification, sim: SimConfig, server_cfg: ServerConfig, *,
             eval_every: int = 1, workload=None, device="cuda") -> SimResult:
    """The classification simulator behind ``repro_torch.fed.api.run``."""
    if sim.engine not in _ENGINES:
        raise ValueError(f"unknown engine {sim.engine!r} (batched | looped | fused | fused_eager)")
    if sim.client_shards > 0 and sim.engine != "fused":
        raise ValueError(f"client_shards requires engine='fused' (got {sim.engine!r})")
    dev = resolve_device(device)
    mesh = _client_mesh(sim, server_cfg, dev)
    setup = _Setup(data, sim, dev if mesh is None else mesh.device, workload=workload)
    if mesh is not None:
        if sim.segment_rounds > 0:
            return _run_fused_segmented_sharded(setup, server_cfg, eval_every, mesh)
        return _run_fused_sharded(setup, server_cfg, eval_every, mesh)
    if sim.engine == "batched":
        return _run_batched(setup, server_cfg, eval_every)
    if sim.engine == "looped":
        return _run_looped(setup, server_cfg, eval_every)
    if sim.engine == "fused" and sim.segment_rounds > 0:
        return _run_fused_segmented(setup, server_cfg, eval_every)
    return _run_fused(setup, server_cfg, eval_every, eager=sim.engine == "fused_eager")


def _run_batched(setup: _Setup, server_cfg: ServerConfig, eval_every: int) -> SimResult:
    sim, dev = setup.sim, setup.device
    K = sim.num_clients
    step = make_train_attack_step(setup.workload, setup.engine_config())
    bad_t = torch.from_numpy(setup.bad_mask).to(dev)

    def propose(params, rnd, batch, trainers, mask0, benign):
        train_mask = np.zeros(K, bool)
        train_mask[trainers] = True
        return step(
            params, batch, client_seeds(sim.seed, rnd, range(K)),
            torch.from_numpy(train_mask).to(dev), bad_t & torch.from_numpy(mask0).to(dev),
            torch.from_numpy(benign).to(dev), attack_seed(sim.seed, rnd),
        )

    return _run_rounds(setup, server_cfg, eval_every, setup.batch, propose)


def _run_looped(setup: _Setup, server_cfg: ServerConfig, eval_every: int) -> SimResult:
    sim, dev = setup.sim, setup.device
    K = sim.num_clients
    ec = setup.engine_config()
    workload = setup.workload

    def load(idx):
        return {k: setup.client_batch(k, ix) for k, ix in idx.items()}

    def propose(params, rnd, batches, trainers, mask0, benign):
        seeds = client_seeds(sim.seed, rnd, range(K))
        w_prev = workload.codec.proposal_of(params)
        per_client = [w_prev] * K  # non-trainers hold w_t
        for k in trainers:
            one = workload.local_update(ec, params, batches[k], [seeds[k]])
            per_client[k] = tree_map(lambda l: l[0], one)
        return apply_update_attack(
            sim.scenario, tree_stack(per_client), w_prev,
            torch.from_numpy(setup.bad_mask & mask0).to(dev), torch.from_numpy(benign).to(dev),
            attack_seed(sim.seed, rnd), byzantine_scale=ec.byzantine_scale,
            z_max=ec.alie_z_max, eps=ec.ipm_eps,
        )

    return _run_rounds(setup, server_cfg, eval_every, load, propose)


def _run_rounds(setup: _Setup, server_cfg: ServerConfig, eval_every: int, load,
                propose) -> SimResult:
    """The round loop of the batched and looped engines, which differ only
    in the client layer: ``load`` turns the drawn minibatch indices into
    device batches, ``propose(params, rnd, batches, trainers, mask0,
    benign)`` trains and attacks and returns the stacked proposals."""
    sim, dev = setup.sim, setup.device
    server = FedServer(server_cfg, device=dev)
    params = setup.params0

    test_error, good_hist, round_times = [], [], []
    t_train = t_agg = 0.0
    for rnd in range(sim.rounds):
        t_start = time.perf_counter()
        selected = server.select()
        trainers = setup.trainers(selected)
        batches = load(setup.draw_indices(trainers))
        mask0 = server.participation_mask(selected)
        benign = mask0 & ~setup.bad_mask

        _sync(dev)
        t0 = time.perf_counter()
        proposals = propose(params, rnd, batches, trainers, mask0, benign)
        _sync(dev)
        t_train += time.perf_counter() - t0

        t0 = time.perf_counter()
        agg, info = server.aggregate_tree(proposals, setup.n_k, selected)
        if not info["all_blocked"]:  # zero update: keep previous params
            params = setup.workload.codec.apply(params, agg)
        _sync(dev)
        t_agg += time.perf_counter() - t0
        good_hist.append(info.get("good_mask"))

        if rnd % eval_every == 0 or rnd == sim.rounds - 1:
            err = setup.workload.eval_metric(params, setup.x_test, setup.y_test)
            test_error.append(float(err) * 100.0)
        round_times.append(time.perf_counter() - t_start)

    return setup.result(
        server.rounds_blocked, test_error, good_hist, t_train, t_agg, round_times
    )


# ---------------------------------------------------------------------------
# fused engine — one round body, a CUDA graph on the card
# ---------------------------------------------------------------------------


def _fused_data(setup: _Setup) -> FusedData:
    """The device inputs of the fused engine over all K clients."""
    dev = setup.device
    return FusedData(
        x=setup.x_pad, y=setup.y_pad,
        lengths=torch.from_numpy(setup.padded[2].astype(np.int64)).to(dev),
        n_k=torch.from_numpy(setup.n_k).to(dev),
        x_test=setup.x_test, y_test=setup.y_test,
    )


def _client_mesh(sim: SimConfig, server_cfg: ServerConfig, device):
    """The client mesh of a sharded run (``sim.client_shards > 0``), on the
    caller's process group, or None."""
    if sim.client_shards <= 0:
        return None
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"SimConfig.client_shards={sim.client_shards} runs one process a shard inside an "
            "initialized torch.distributed group of that many ranks; start them with "
            "repro_torch.launch.shards.run_sharded(workload, sim, server, data=..., device=...)")
    layout = resolve_server_plan(server_cfg).layout
    if layout != "packed":
        raise ValueError("the client-sharded engine packs once a round and requires the "
                         f"packed layout (got {layout!r})")
    return make_client_mesh(sim.client_shards, device)


def _client_opts_kwargs(mesh) -> dict:
    """``make_rule_options`` keywords marking the options for a client mesh."""
    return {} if mesh is None else {"client_mesh": mesh}


def _make_setup_sim(setup: _Setup, server_cfg: ServerConfig, mesh=None):
    """Fused simulation for this experiment's static configuration; the rule
    options are built once, with K (MKRUM selects K - f - 2)."""
    sim = setup.sim
    return make_fused_sim(
        setup.workload, setup.engine_config(),
        rule=server_cfg.rule,
        opts=make_rule_options(server_cfg, sim.num_clients, **_client_opts_kwargs(mesh)),
        delta_block=server_cfg.delta_block,
        num_clients=sim.num_clients,
        num_rounds=sim.rounds,
        batch_s=setup.batch_s,
        batch_b=setup.batch_b,
        bad_mask=setup.bad_mask,
        alpha0=server_cfg.alpha0,
        beta0=server_cfg.beta0,
        device=setup.device,
        client_mesh=mesh,
        layout=resolve_server_plan(server_cfg).layout,
    )


class FusedInputs(NamedTuple):
    """Everything an outside caller of the fused round pipeline needs."""

    workload: object           # ClientWorkload (hashable frozen dataclass)
    engine_cfg: EngineConfig
    data: FusedData            # padded device stacks + n_k + test set
    bad_mask: np.ndarray       # (K,) bool — ground-truth byzantine ids
    batch_s: int               # per-round local steps
    batch_b: int               # minibatch width
    params0: object            # workload.init_params from sim.seed


def fused_inputs(data: SyntheticClassification, sim: SimConfig, *, workload=None,
                 device="cuda") -> FusedInputs:
    """The fused engine's inputs for this experiment, built by the same
    ``_Setup`` the engines use, without running it."""
    setup = _Setup(data, sim, resolve_device(device), workload=workload)
    return FusedInputs(
        workload=setup.workload, engine_cfg=setup.engine_config(), data=_fused_data(setup),
        bad_mask=setup.bad_mask, batch_s=setup.batch_s, batch_b=setup.batch_b,
        params0=setup.params0,
    )


def _even(total: float, T: int) -> list:
    """A run's seconds spread evenly over its T rounds."""
    return [total / max(T, 1)] * T


def _fused_result(setup: _Setup, rounds_blocked, test_error, good_hist, round_times,
                  eval_every: int, capture_s: float) -> SimResult:
    T = setup.sim.rounds
    errs = np.asarray(test_error, np.float64) * 100.0
    kept = [float(errs[r]) for r in range(T) if r % eval_every == 0 or r == T - 1]
    # the rounds run as one program (or a segment's): no per-phase host
    # timings exist, so only round_time is filled
    res = setup.result(np.asarray(rounds_blocked), kept, good_hist, 0.0, 0.0, list(round_times))
    res.capture_time = capture_s
    return res


def _run_fused(setup: _Setup, server_cfg: ServerConfig, eval_every: int, *,
               eager: bool = False) -> SimResult:
    sim, dev = setup.sim, setup.device
    data = _fused_data(setup)
    scan_fn, round_fn = _make_setup_sim(setup, server_cfg)
    stats = {"capture_s": 0.0}
    _sync(dev)
    t_start = time.perf_counter()
    if eager:
        # the reference for the graph: the identical round body, called once
        # per round
        state0 = fused_server_state(sim.num_clients, server_cfg.alpha0, server_cfg.beta0, dev)
        _, state, traj = fused_eager_run(round_fn, setup.params0, state0, sim.seed, data,
                                         sim.rounds)
    else:
        _, state, traj = scan_fn(setup.params0, sim.seed, data, stats=stats)
    _sync(dev)
    total = time.perf_counter() - t_start
    return _fused_result(setup, state.rounds_blocked.cpu().numpy(),
                         traj.test_error.cpu().numpy(), list(traj.good_mask.cpu().numpy()),
                         _even(total, sim.rounds), eval_every, stats["capture_s"])


# ---------------------------------------------------------------------------
# segmented fused engine — compaction of blocked clients between segments
# ---------------------------------------------------------------------------


def _compact_inputs(setup: _Setup, kept: np.ndarray, bucket: int):
    """The kept clients' device inputs in a ``bucket``-row layout: ``kept``
    holds the live original ids, ascending, and -1 for a pad slot within it
    (a block of ``shard_compact_plan``); pad rows, and the rows past
    ``kept``, carry zero shards of length 1, zero ``n_k``, benign ``bad``
    and id 0, all inert, since their server-state rows are blocked."""
    dev = setup.device
    x_pad, y_pad, lengths = setup.padded
    kept = np.asarray(kept, np.int64)
    x_c, y_c, len_c = compact_stack(x_pad, y_pad, lengths, kept, pad_to=bucket)
    n = len(kept)
    valid = kept >= 0
    n_k_c = np.zeros((bucket,), np.float32)
    n_k_c[:n] = np.where(valid, setup.n_k[kept], 0.0)
    bad_c = np.zeros((bucket,), bool)
    bad_c[:n] = valid & setup.bad_mask[kept]
    ids_c = np.zeros((bucket,), np.int64)
    ids_c[:n] = np.where(valid, kept, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    data = FusedData(x=t(x_c), y=t(y_c.astype(np.int64)), lengths=t(len_c.astype(np.int64)),
                     n_k=t(n_k_c), x_test=setup.x_test, y_test=setup.y_test)
    return data, t(bad_c), t(ids_c)


def _segment_fn(setup: _Setup, server_cfg: ServerConfig, mesh=None):
    """The segments for this experiment's static configuration: one program
    (one capture on the card) per bucket, or this rank's eager rounds."""
    sim = setup.sim
    return make_fused_segment(
        setup.workload, setup.engine_config(),
        rule=server_cfg.rule,
        opts=make_rule_options(server_cfg, sim.num_clients, **_client_opts_kwargs(mesh)),
        delta_block=server_cfg.delta_block,
        num_clients_total=sim.num_clients,
        num_rounds=sim.rounds,
        batch_s=setup.batch_s,
        batch_b=setup.batch_b,
        alpha0=server_cfg.alpha0,
        beta0=server_cfg.beta0,
        device=setup.device,
        client_mesh=mesh,
        layout=resolve_server_plan(server_cfg).layout,
    )


def _seed_params(setup: _Setup, seed: int):
    """The model init of ``seed``: a generator on the device seeded with it,
    as ``_Setup`` draws ``params0`` from ``sim.seed``."""
    gen = torch.Generator(device=setup.device)
    gen.manual_seed(int(seed))
    return setup.workload.init_params(gen, setup.device)


def _segmented_runs(setup: _Setup, server_cfg: ServerConfig, seeds, stats: dict):
    """The fused simulation of each seed in segments of ``segment_rounds``
    rounds, every seed on the same client layout.

    Before each segment the host reads the blocked sets (with ``compact``;
    the only device-to-host read of the run until its end) and, when the
    clients live in ANY seed fit a smaller power-of-two bucket, saves each
    seed's rows being dropped into its full-K state, gathers the live
    clients' shards, ``n_k``, attack flags and each seed's posteriors into
    the bucket, and replays that bucket's round graph once per seed.  A
    client blocked in some seeds only stays resident, held out by those
    seeds' masks.  Every keyed stream depends on the original id and every
    client-axis sum adds the live rows in order, so each seed's stitched
    trajectory equals its one-shot run's.  Returns ``(rounds_blocked (n, K),
    test_error (n, T), good_mask (n, T, K))`` as host arrays."""
    return _run_segments(_segment_fn(setup, server_cfg), setup, server_cfg, seeds, stats)


def _run_segments(seg_fn, setup: _Setup, server_cfg: ServerConfig, seeds, stats: dict):
    """``_segmented_runs`` on the segments ``seg_fn`` (``_segment_fn``'s),
    whose programs outlive the call."""
    sim, dev = setup.sim, setup.device
    K, T, S = sim.num_clients, sim.rounds, sim.segment_rounds
    n = len(seeds)
    params = [_seed_params(setup, s) for s in seeds]
    # each seed's full-K state holds the frozen rows of clients dropped at
    # earlier compactions; its live rows' state is in ``state_c``, scattered
    # back at bucket changes and once at the end
    state_full = [fused_server_state(K, server_cfg.alpha0, server_cfg.beta0, dev)
                  for _ in seeds]
    state_c = list(state_full)
    data_c = bad_c = ids_c = None
    kept, bucket = np.arange(K), None
    test_error = np.zeros((n, T), np.float64)
    good = np.zeros((n, T, K), bool)
    seg_start = 0
    while seg_start < T:
        seg_len = min(S, T - seg_start)
        if sim.compact:
            blocked_c = np.stack([st.reputation.blocked.cpu().numpy()[: len(kept)]
                                  for st in state_c])
            live = kept[~blocked_c.all(axis=0)]
        else:
            live = np.arange(K)
        new_bucket = pow2_bucket(len(live), K)
        if bucket != new_bucket:
            if bucket is not None:
                state_full = [scatter_server_state(f, c, kept)
                              for f, c in zip(state_full, state_c)]
            bucket, kept = new_bucket, live
            data_c, bad_c, ids_c = _compact_inputs(setup, kept, bucket)
            state_c = [gather_server_state(f, kept, bucket) for f in state_full]
        end = seg_start + seg_len
        for i, s in enumerate(seeds):
            params[i], state_c[i], traj = seg_fn(params[i], state_c[i], int(s), data_c, bad_c,
                                                 ids_c, seg_start, seg_len, stats=stats)
            # dropped clients keep good_mask = False, as the one-shot run
            # gives them (they are blocked)
            test_error[i, seg_start:end] = traj.test_error.cpu().numpy()
            good[i][seg_start:end, kept] = traj.good_mask.cpu().numpy()[:, : len(kept)]
        seg_start = end
    state_full = [scatter_server_state(f, c, kept) for f, c in zip(state_full, state_c)]
    rounds_blocked = np.stack([st.rounds_blocked.cpu().numpy() for st in state_full])
    return rounds_blocked, test_error, good


def _run_fused_segmented(setup: _Setup, server_cfg: ServerConfig,
                         eval_every: int) -> SimResult:
    """The fused simulation in segments of ``segment_rounds`` rounds, with
    the blocked clients compacted out between them (``_segmented_runs`` on
    the one seed ``sim.seed``)."""
    stats = {"capture_s": 0.0}
    _sync(setup.device)
    t_start = time.perf_counter()
    rounds_blocked, test_error, good = _segmented_runs(setup, server_cfg, [setup.sim.seed],
                                                       stats)
    total = time.perf_counter() - t_start
    return _fused_result(setup, rounds_blocked[0], test_error[0], list(good[0]),
                         _even(total, setup.sim.rounds), eval_every, stats["capture_s"])


# ---------------------------------------------------------------------------
# client-sharded fused engine — this rank's rows of a client mesh
# ---------------------------------------------------------------------------


def _gather_state(mesh, state: ServerState, total: int) -> ServerState:
    """Every rank's rows of the server state, stacked in rank order (one
    all-reduce; float64 holds the posteriors, the flags and the rounds
    exactly)."""
    rep = state.reputation
    parts = (rep.alpha, rep.beta, rep.blocked, state.rounds_blocked)
    both = mesh.gather_rows(torch.stack([p.double() for p in parts], dim=1), total)
    alpha, beta, blocked, rb = (both[:, i].to(p.dtype) for i, p in enumerate(parts))
    return ServerState(rep._replace(alpha=alpha, beta=beta, blocked=blocked), rb, state.round)


def _run_fused_sharded(setup: _Setup, server_cfg: ServerConfig, eval_every: int,
                       mesh) -> SimResult:
    """``engine="fused"`` on this rank's K / S clients; every rank returns
    the whole result."""
    sim, dev = setup.sim, setup.device
    K = sim.num_clients
    scan_fn, _ = _make_setup_sim(setup, server_cfg, mesh)
    rows = K // mesh.num_shards
    data, _, _ = _compact_inputs(setup, np.arange(K)[mesh.row_block(rows)], rows)
    _sync(dev)
    t_start = time.perf_counter()
    _, state, traj = scan_fn(setup.params0, sim.seed, data)
    rounds_blocked = mesh.gather_rows(state.rounds_blocked, K)
    _sync(dev)
    total = time.perf_counter() - t_start
    return _fused_result(setup, rounds_blocked.cpu().numpy(), traj.test_error.cpu().numpy(),
                         list(traj.good_mask.cpu().numpy()), _even(total, sim.rounds),
                         eval_every, 0.0)


def _run_fused_segmented_sharded(setup: _Setup, server_cfg: ServerConfig, eval_every: int,
                                 mesh) -> SimResult:
    """The sharded fused simulation in segments of ``segment_rounds``
    rounds, compacted per shard between them.

    Every rank keeps the full-K state (the frozen rows of clients dropped
    at earlier compactions) alike; before a segment it reads the blocked
    set of the bucket, gathered over the ranks with the last segment's
    trajectory, and computes the same ``shard_compact_plan``.  When the
    plan's bucket changes, the ranks gather their state rows into the
    full-K state, and each takes its block of the new plan.  Each rank's
    per-round times are its segments' wall times spread over their
    rounds."""
    sim, dev = setup.sim, setup.device
    K, T, S = sim.num_clients, sim.rounds, sim.segment_rounds
    n_shards = mesh.num_shards
    seg_fn = _segment_fn(setup, server_cfg, mesh)
    params = setup.params0
    state_full = fused_server_state(K, server_cfg.alpha0, server_cfg.beta0, dev)
    state_c = data_c = bad_c = ids_c = None
    kept, bucket = np.arange(K), None
    blocked_c = np.zeros(K, bool)
    test_error = np.zeros((T,), np.float64)
    good = np.zeros((T, K), bool)
    round_times = np.zeros((T,), np.float64)
    seg_start = 0
    while seg_start < T:
        t0 = time.perf_counter()
        seg_len = min(S, T - seg_start)
        # pad slots (kept == -1) are blocked and drop out
        live = kept[~blocked_c & (kept >= 0)] if sim.compact else np.arange(K)
        new_kept, new_rows = shard_compact_plan(live, n_shards, K // n_shards)
        if bucket != new_rows * n_shards:
            if bucket is not None:
                state_full = scatter_server_state(
                    state_full, _gather_state(mesh, state_c, bucket), kept)
            kept, bucket = new_kept, new_rows * n_shards
            mine = kept[mesh.row_block(new_rows)]
            data_c, bad_c, ids_c = _compact_inputs(setup, mine, new_rows)
            state_c = gather_server_state(state_full, mine, new_rows)
        params, state_c, traj = seg_fn(params, state_c, sim.seed, data_c, bad_c, ids_c,
                                       seg_start, seg_len)
        end = seg_start + seg_len
        valid = kept >= 0
        test_error[seg_start:end] = traj.test_error.cpu().numpy()
        # dropped clients keep good_mask = False, as the one-shot run gives
        # them (they are blocked)
        good[seg_start:end, kept[valid]] = traj.good_mask.cpu().numpy()[:, valid]
        blocked_c = traj.blocked[-1].cpu().numpy()
        round_times[seg_start:end] = (time.perf_counter() - t0) / seg_len
        seg_start = end
    state_full = scatter_server_state(state_full, _gather_state(mesh, state_c, bucket), kept)
    return _fused_result(setup, state_full.rounds_blocked.cpu().numpy(), test_error,
                         list(good), round_times, eval_every, 0.0)


# ---------------------------------------------------------------------------
# seed sweeps — one program replayed for every seed
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepResult:
    """Per-seed trajectories and detection statistics of a seed sweep."""

    seeds: np.ndarray                # (n,)
    test_error: np.ndarray           # (n, T) percent, every round
    good_mask_history: np.ndarray    # (n, T, K) bool
    blocked_round: np.ndarray        # (n, K) 1-indexed, -1 = never
    bad_clients: np.ndarray          # (n_bad,) indices (fixed across seeds)
    detection_rate: np.ndarray       # (n,)
    mean_rounds_to_block: np.ndarray  # (n,)
    capture_time: float = 0.0        # on the card: seconds spent capturing the
                                     # round graphs (one a sweep, or one a bucket)


def _sweep_result(setup: _Setup, seeds, blocked_round, test_error, good_mask,
                  capture_s: float) -> SweepResult:
    stats = [detection_stats(br, setup.bad) for br in blocked_round]
    return SweepResult(
        seeds=np.asarray(seeds),
        test_error=np.asarray(test_error, np.float64) * 100.0,
        good_mask_history=np.asarray(good_mask, bool),
        blocked_round=np.asarray(blocked_round),
        bad_clients=setup.bad,
        detection_rate=np.asarray([r for r, _ in stats]),
        mean_rounds_to_block=np.asarray([m for _, m in stats]),
        capture_time=capture_s,
    )


def sweep(data: SyntheticClassification, sim: SimConfig, server_cfg: ServerConfig, seeds, *,
          workload=None, device="cuda") -> SweepResult:
    """Run the fused simulation once for every seed of ``seeds``.

    The shard split (and data-level poisoning) is built once from
    ``sim.seed`` and shared across the sweep; each sweep seed drives the
    model init, the device minibatch stream and the attack-noise stream, so
    the row of ``sim.seed`` is the ``engine="fused"`` run.  The round is
    captured once and replayed for every seed (``sweep_fused_sim``).  With
    ``sim.segment_rounds > 0`` the sweep runs segmented, compacting on the
    UNION of the clients live in any seed between segments, with one
    capture a bucket for all seeds; each seed's trajectory equals its
    unsegmented one bit for bit."""
    if sim.client_shards > 0:
        raise ValueError("run_sweep is not wired for the client-sharded engine; set "
                         "client_shards=0 for sweeps")
    setup = _Setup(data, sim, resolve_device(device), workload=workload)
    stats = {"capture_s": 0.0}
    if sim.segment_rounds > 0:
        rounds_blocked, test_error, good = _segmented_runs(setup, server_cfg, seeds, stats)
    else:
        scan_fn, _ = _make_setup_sim(setup, server_cfg)
        _, state, traj = sweep_fused_sim(scan_fn, setup.workload, seeds, _fused_data(setup),
                                         stats=stats)
        rounds_blocked = state.rounds_blocked.cpu().numpy()
        test_error = traj.test_error.cpu().numpy()
        good = traj.good_mask.cpu().numpy()
    return _sweep_result(setup, seeds, rounds_blocked, test_error, good, stats["capture_s"])


def run_sweep(data: SyntheticClassification, sim: SimConfig, server_cfg: ServerConfig, seeds, *,
              device="cuda") -> SweepResult:
    """DEPRECATED: call :func:`repro_torch.fed.api.run` with ``seeds=``
    instead.  A thin shim over :func:`sweep` (the same trajectories), kept
    so existing callers keep working, with a warning."""
    warnings.warn(
        "run_sweep is deprecated; use repro_torch.fed.api.run(workload, sim, server, "
        "data=data, seeds=seeds) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return sweep(data, sim, server_cfg, seeds, device=device)


def run_simulation(data: SyntheticClassification, sim: SimConfig, server_cfg: ServerConfig, *,
                   eval_every: int = 1, device="cuda") -> SimResult:
    """DEPRECATED: call :func:`repro_torch.fed.api.run` instead.  A thin shim
    over :func:`simulate` (the same trajectory), kept so existing callers
    keep working, with a warning."""
    warnings.warn(
        "run_simulation is deprecated; use repro_torch.fed.api.run(workload, sim, server, "
        "data=data) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return simulate(data, sim, server_cfg, eval_every=eval_every, device=device)
