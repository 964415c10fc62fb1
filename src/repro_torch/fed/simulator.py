"""Paper-scale federated simulator: K clients x T rounds over a synthetic
dataset, in the clean / byzantine / flipping / noisy / alie / ipm scenarios.

Counterpart of ``repro/fed/simulator.py`` with the ``batched`` engine: each
round trains all K clients at once on stacked parameters, applies the
update-level attacks on the stacked proposals and aggregates through the
packed registry dispatch.  The ``looped``, ``fused`` and ``fused_eager``
engines are not ported and raise.

``_Setup`` consumes ONE numpy stream exactly as the JAX package does (the
noisy-features poisoning first, then the minibatch indices of the trainers
in ascending order, byzantine clients skipping training), so the shards and
minibatches equal the JAX run's; only the torch-side streams (init, dropout,
byzantine noise) differ.  The shards live on the device and each round
gathers its minibatches there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.attacks import UPDATE_ATTACK_SCENARIOS, flip_labels, noisy_features
from repro_torch.data import SyntheticClassification, dirichlet_shards, iid_shards
from repro_torch.fed.engine import (
    EngineConfig,
    attack_seed,
    client_seeds,
    make_train_attack_step,
)
from repro_torch.fed.server import FedServer, ServerConfig
from repro_torch.fed.workload import DnnWorkload


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
    engine: str = "batched"      # the port runs "batched" only


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

        # shards as padded device stacks; each round gathers its minibatches
        lens = [len(x) for x, _ in self.poisoned]
        n_max = max(lens)
        x_pad = np.zeros((K, n_max, data.dim), np.float32)
        y_pad = np.zeros((K, n_max), np.int64)
        for k, (x, y) in enumerate(self.poisoned):
            x_pad[k, : len(x)] = x
            y_pad[k, : len(y)] = y
        self.x_pad = torch.from_numpy(x_pad).to(device)
        self.y_pad = torch.from_numpy(y_pad).to(device)

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


_NOT_PORTED = {
    "looped": "ROADMAP queue A: the looped engine",
    "fused": "ROADMAP queue A: the fused and segmented engines",
    "fused_eager": "ROADMAP queue A: the fused and segmented engines",
}


def simulate(data: SyntheticClassification, sim: SimConfig, server_cfg: ServerConfig, *,
             eval_every: int = 1, workload=None, device="cuda") -> SimResult:
    """The classification simulator behind ``repro_torch.fed.api.run``."""
    if sim.engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={sim.engine!r} is not ported to repro_torch yet "
            f"({_NOT_PORTED[sim.engine]}); use engine='batched'"
        )
    if sim.engine != "batched":
        raise ValueError(f"unknown engine {sim.engine!r} (batched | looped | fused | fused_eager)")
    dev = resolve_device(device)
    setup = _Setup(data, sim, dev, workload=workload)
    return _run_batched(setup, server_cfg, eval_every)


def _run_batched(setup: _Setup, server_cfg: ServerConfig, eval_every: int) -> SimResult:
    sim, dev = setup.sim, setup.device
    K = sim.num_clients
    server = FedServer(server_cfg, device=dev)
    params = setup.params0
    step = make_train_attack_step(setup.workload, setup.engine_config())
    bad_t = torch.from_numpy(setup.bad_mask).to(dev)

    test_error, good_hist, round_times = [], [], []
    t_train = t_agg = 0.0
    for rnd in range(sim.rounds):
        t_start = time.perf_counter()
        selected = server.select()
        trainers = setup.trainers(selected)
        batch = setup.batch(setup.draw_indices(trainers))
        train_mask = np.zeros(K, bool)
        train_mask[trainers] = True
        mask0 = server.participation_mask(selected)
        benign = mask0 & ~setup.bad_mask
        mask0_t = torch.from_numpy(mask0).to(dev)

        _sync(dev)
        t0 = time.perf_counter()
        proposals = step(
            params, batch, client_seeds(sim.seed, rnd, range(K)),
            torch.from_numpy(train_mask).to(dev), bad_t & mask0_t,
            torch.from_numpy(benign).to(dev), attack_seed(sim.seed, rnd),
        )
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
