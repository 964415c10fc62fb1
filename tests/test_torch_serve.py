"""The port's serve tier (``repro_torch.serve``) on the CPU, at the JAX
package's test size (``tests/test_serve.py``: K = 8, 12 rounds,
``make_mnist_like(n_train=600, n_test=150, dim=20)``, hidden (16,)).

Part 1 is the port's counterpart of each of ``tests/test_serve.py``'s ten
tests: the synchronous replay equals the port's ``engine="fused"`` bit for
bit; the blocked, duplicate, stale and invalid ingress paths; a deadline
round with no arrival keeps the params; decayed increments of the
posterior; traffic that blocks exactly the attackers, rejects their
reconnects and replays deterministically; ``ServeConfig``'s validation.

Part 2 holds the port to the JAX package on the same numpy inputs:
``update_reputation_weighted`` and ``server_step_versioned`` at decay 0.7
and tau in {0, 1, 2} (posteriors within 1e-6 relative; the screening and
blocking exactly, where the blocking margin to delta exceeds 1e-5: the
port's betainc is a float64 continued fraction, the JAX package's works in
float32); ``validate_submission``'s decisions; an ``AggregationService`` in
each package, with the same params, rows and schedule, gives the same
decision log and round records (test error within 1 / n_test); and
``run_traffic`` in both packages, each served the same rows by a stub pool,
gives the same ingress log.  The hand-made rows are well apart (benign rows
near the initial params, attackers far off), so that no screening decision
sits on a rounding tie.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.reputation import ReputationState as JReputationState  # noqa: E402
from repro.core.reputation import update_reputation_weighted as j_update_weighted  # noqa: E402
from repro.data import make_mnist_like as j_make_mnist_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed.server import init_server_state as j_init_server_state  # noqa: E402
from repro.fed.server import make_rule_options as j_make_rule_options  # noqa: E402
from repro.fed.server import server_step_versioned as j_server_step_versioned  # noqa: E402
from repro.fed.simulator import fused_inputs as j_fused_inputs  # noqa: E402
from repro.fed.workload import validate_submission as j_validate_submission  # noqa: E402
from repro.serve import AggregationService as JAggregationService  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import run_traffic as j_run_traffic  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ReputationState, betainc, update_reputation  # noqa: E402
from repro_torch.core import update_reputation_weighted  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    ServerConfig,
    SimConfig,
    fused_inputs,
    init_server_state,
    make_rule_options,
    server_step,
    server_step_versioned,
    simulate,
    validate_submission,
)
from repro_torch.serve import (  # noqa: E402
    ACCEPTED,
    REJECTED_BLOCKED,
    REJECTED_DUPLICATE,
    REJECTED_INVALID,
    REJECTED_STALE,
    AggregationService,
    ProposalPool,
    ServeConfig,
    TrafficConfig,
    run_serve_replay,
    run_traffic,
)

K = 8
ROUNDS = 12  # enough for AFA to block both attackers (round 6)
DATA_KW = dict(n_train=600, n_test=150, dim=20)
SIM_KW = dict(num_clients=K, bad_frac=0.25, scenario="byzantine", rounds=ROUNDS,
              local_epochs=2, batch_size=50, hidden=(16,), dropout=False, seed=0,
              engine="fused")
DECAY = 0.7
MARGIN = 1e-5   # blocking compared where |I_0.5(alpha, beta) - delta| exceeds it


@pytest.fixture(scope="module")
def data():
    return make_mnist_like(**DATA_KW)


@pytest.fixture(scope="module")
def sim():
    return SimConfig(**SIM_KW)


@pytest.fixture(scope="module")
def server():
    return ServerConfig(rule="afa", num_clients=K)


@pytest.fixture(scope="module")
def inputs(data, sim):
    return fused_inputs(data, sim, device="cpu")


def _service(inputs, server, serve_cfg):
    return AggregationService(inputs.workload, server, serve_cfg, inputs.params0, inputs.data)


# ---------------------------------------------------------------------------
# 1. the port's counterparts of tests/test_serve.py
# ---------------------------------------------------------------------------


def test_sync_replay_bit_identical_to_fused_engine(data, sim, server):
    ref = simulate(data, sim, server, eval_every=1, device="cpu")
    out = run_serve_replay(data, sim, server, device="cpu")  # default ServeConfig

    # the run must exercise blocking, or the equality proves too little
    assert (np.asarray(ref.blocked_round) >= 0).any()
    assert ref.test_error == out.test_error  # float-exact, every round
    assert np.array_equal(ref.blocked_round, out.blocked_round)
    assert len(ref.good_mask_history) == len(out.good_mask_history) == ROUNDS
    for a, b in zip(ref.good_mask_history, out.good_mask_history):
        assert np.array_equal(a, b)
    # every round closed on a full live buffer, nothing was rejected
    assert all(r.trigger in ("buffer", "flush") for r in out.rounds)
    assert out.decisions[ACCEPTED] > 0
    assert sum(v for d, v in out.decisions.items() if d != ACCEPTED) == 0


def test_blocked_client_resubmission_rejected_at_ingress(inputs, server):
    svc = _service(inputs, server, ServeConfig())
    pool = ProposalPool(inputs, 0)
    for rnd in range(ROUNDS):
        blocked = svc.blocked.copy()
        rows = pool.rows(svc.round, svc.params, blocked)
        for k in range(K):
            if not blocked[k]:
                svc.submit(k, rows[k], svc.round, now=float(rnd))
        if svc.blocked.any():
            break
    assert svc.blocked.any(), "no client was blocked within the horizon"
    bad = int(np.flatnonzero(svc.blocked)[0])

    alpha = svc.state.reputation.alpha.numpy().copy()
    n_before = svc.accepted_count
    out = svc.submit(bad, rows[bad], svc.round, now=99.0)
    assert out.decision == REJECTED_BLOCKED and out.fired is None
    # rejected before any buffering or aggregation work
    assert svc.accepted_count == n_before
    assert svc.blocked[bad]
    assert np.array_equal(svc.state.reputation.alpha.numpy(), alpha)


def test_duplicate_submission_same_round_rejected(inputs, server):
    svc = _service(inputs, server, ServeConfig(buffer_size=K))
    pool = ProposalPool(inputs, 0)
    rows = pool.rows(0, svc.params, svc.blocked)
    assert svc.submit(2, rows[2], 0, now=0.0).decision == ACCEPTED
    out = svc.submit(2, rows[2], 0, now=0.1)
    assert out.decision == REJECTED_DUPLICATE
    assert svc.accepted_count == 1


def test_stale_submission_dropped_and_reputation_untouched(inputs, server):
    svc = _service(inputs, server, ServeConfig(buffer_size=2, max_staleness=0))
    pool = ProposalPool(inputs, 0)
    rows0 = pool.rows(0, svc.params, svc.blocked)
    svc.submit(2, rows0[2], 0, now=0.0)
    fired = svc.submit(3, rows0[3], 0, now=0.1).fired
    assert fired is not None and svc.round == 1

    alpha = svc.state.reputation.alpha.numpy().copy()
    beta = svc.state.reputation.beta.numpy().copy()
    out = svc.submit(4, rows0[4], 0, now=0.2)  # tau = 1 > max_staleness = 0
    assert out.decision == REJECTED_STALE
    assert svc.accepted_count == 0
    assert np.array_equal(svc.state.reputation.alpha.numpy(), alpha)
    assert np.array_equal(svc.state.reputation.beta.numpy(), beta)
    # a version stamp from the future is corrupt, not stale
    assert svc.submit(4, rows0[4], 5, now=0.3).decision == REJECTED_INVALID


def test_invalid_payload_rejected_by_codec_validation(inputs, server):
    svc = _service(inputs, server, ServeConfig())
    dim = svc._pspec.dim
    assert svc.submit(0, np.zeros(dim + 1, np.float32), 0, now=0.0).decision == REJECTED_INVALID
    nonfinite = np.full(dim, np.nan, np.float32)
    assert svc.submit(0, nonfinite, 0, now=0.0).decision == REJECTED_INVALID
    assert svc.accepted_count == 0


def test_deadline_with_zero_arrivals_keeps_params(inputs, server):
    svc = _service(inputs, server, ServeConfig(deadline=1.0))
    p0 = {k: v.clone() for k, v in svc.params.items()}
    alpha = svc.state.reputation.alpha.numpy().copy()
    fired = svc.poll(3.0)  # three deadlines elapsed, nobody submitted
    assert [r.trigger for r in fired] == ["deadline"] * 3
    assert all(r.all_blocked and r.n_accepted == 0 for r in fired)
    # the all-blocked guard held the params bit for bit; reputation untouched
    assert all(torch.equal(p0[k], svc.params[k]) for k in p0)
    assert np.array_equal(svc.state.reputation.alpha.numpy(), alpha)
    assert not svc.blocked.any()
    assert svc.round == 3  # the server's version still advanced


def test_staleness_decay_downweights_posterior_increments(inputs, server):
    gamma = 0.5
    svc = _service(inputs, server,
                   ServeConfig(buffer_size=K, staleness_decay=gamma, max_staleness=4))
    pool = ProposalPool(inputs, 0)
    rows0 = pool.rows(0, svc.params, svc.blocked)
    for k in range(K):  # round 0: everyone fresh (tau = 0, weight 1)
        svc.submit(k, rows0[k], 0, now=0.0)
    a1 = svc.state.reputation.alpha.numpy().copy()
    b1 = svc.state.reputation.beta.numpy().copy()
    inc1 = (a1 - server.alpha0) + (b1 - server.beta0)
    assert np.allclose(inc1[~svc.blocked], 1.0)  # live rows got full weight

    # round 1: every live client submits its stale round-0 row (tau = 1)
    blocked = svc.blocked.copy()
    live = ~blocked
    for k in range(K):
        if live[k]:
            svc.submit(k, rows0[k], 0, now=1.0)
    a2 = svc.state.reputation.alpha.numpy()
    b2 = svc.state.reputation.beta.numpy()
    inc2 = (a2 - a1) + (b2 - b1)
    assert np.allclose(inc2[live], gamma)       # decayed evidence
    assert np.allclose(inc2[blocked], 0.0)


TRAFFIC = dict(seed=3, straggler_frac=0.25, burst_every=5.0)
ASYNC = dict(buffer_size=6, deadline=4.0, max_staleness=2, staleness_decay=DECAY)


@pytest.fixture(scope="module")
def traffic_run(inputs, server):
    svc = _service(inputs, server, ServeConfig(**ASYNC))
    rep = run_traffic(svc, ProposalPool(inputs, 0), TrafficConfig(**TRAFFIC), target_rounds=20)
    return svc, rep


def test_traffic_blocks_attackers_and_rejects_them_at_ingress(traffic_run, inputs):
    svc, rep = traffic_run
    assert len(rep.rounds) == 20
    assert np.array_equal(svc.blocked, inputs.bad_mask)
    assert rep.byz_submissions_after_block > 0
    assert rep.byz_reject_fraction >= 0.95
    assert rep.decisions[REJECTED_DUPLICATE] > 0
    assert rep.decisions[REJECTED_STALE] > 0


def test_traffic_replay_is_deterministic(traffic_run, inputs, server):
    svc, rep = traffic_run
    svc2 = _service(inputs, server, ServeConfig(**ASYNC))
    rep2 = run_traffic(svc2, ProposalPool(inputs, 0), TrafficConfig(**TRAFFIC),
                       target_rounds=20)
    assert svc.log == svc2.log
    assert [r.test_error for r in rep.rounds] == [r.test_error for r in rep2.rounds]
    assert [r.fired_at for r in rep.rounds] == [r.fired_at for r in rep2.rounds]


def test_serve_config_validation():
    with pytest.raises(ValueError):
        ServeConfig(buffer_size=-1)
    with pytest.raises(ValueError):
        ServeConfig(deadline=0.0)
    with pytest.raises(ValueError):
        ServeConfig(staleness_decay=0.0)
    with pytest.raises(ValueError):
        ServeConfig(max_staleness=-2)


# ---------------------------------------------------------------------------
# 2. parity with the JAX package on the same numpy inputs
# ---------------------------------------------------------------------------


def _posteriors():
    """Eight clients' counts, some a step from blocking, two already blocked."""
    alpha = np.array([3, 4, 3, 5, 3, 6, 3, 4], np.float32)
    beta = np.array([8, 3, 7.3, 3, 8.5, 4, 9, 6.6], np.float32)
    blocked = np.array([0, 0, 0, 0, 0, 0, 1, 0], bool)
    return alpha, beta, blocked


def _margin_ok(alpha, beta, delta=0.95):
    return np.abs(betainc(torch.from_numpy(alpha), torch.from_numpy(beta), 0.5).numpy()
                  - delta) > MARGIN


def test_weighted_reputation_with_unit_weights_is_the_unweighted_update():
    alpha, beta, blocked = _posteriors()
    state = ReputationState(torch.from_numpy(alpha), torch.from_numpy(beta),
                            torch.from_numpy(blocked))
    good = torch.tensor([0, 1, 0, 1, 0, 1, 0, 1], dtype=torch.bool)
    part = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.bool)
    a = update_reputation_weighted(state, good, part, torch.ones(K))
    b = update_reputation(state, good, part)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tau", [0, 1, 2])
def test_weighted_reputation_matches_jax(tau):
    alpha, beta, blocked = _posteriors()
    good = np.array([0, 1, 0, 1, 0, 1, 0, 1], bool)
    part = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    w = np.full(K, DECAY ** tau, np.float32)
    j = j_update_weighted(JReputationState(alpha, beta, blocked), good, part, w)
    t = update_reputation_weighted(
        ReputationState(*(torch.from_numpy(a) for a in (alpha, beta, blocked))),
        torch.from_numpy(good), torch.from_numpy(part), torch.from_numpy(w))
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), rtol=1e-6)
    np.testing.assert_allclose(t.beta.numpy(), np.asarray(j.beta), rtol=1e-6)
    ok = _margin_ok(t.alpha.numpy(), t.beta.numpy())
    assert ok.sum() >= K - 2
    assert np.array_equal(t.blocked.numpy()[ok], np.asarray(j.blocked)[ok])
    assert t.blocked.numpy()[~blocked & ok].any()   # a client newly blocked


def _rows(w0, version, seed=7, scale=0.05, bad=(0, 1)):
    """Hand-made rows of one version: benign rows near ``w0``, the attackers'
    far off."""
    out = np.empty((K, w0.shape[0]), np.float32)
    for k in range(K):
        rng = np.random.default_rng([seed, version, k])
        spread = 20.0 if k in bad else scale
        out[k] = w0 + spread * rng.standard_normal(w0.shape[0]).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_inputs():
    return j_fused_inputs(j_make_mnist_like(**DATA_KW), JSimConfig(**SIM_KW))


def _w0(jax_inputs):
    leaves = [np.asarray(jax_inputs.params0[k]).reshape(-1) for k in sorted(jax_inputs.params0)]
    return np.concatenate(leaves).astype(np.float32)


@pytest.mark.parametrize("tau", [0, 1, 2])
def test_versioned_server_step_matches_jax(jax_inputs, tau):
    rows = _rows(_w0(jax_inputs), 0)
    n_k = np.full(K, 75.0, np.float32)
    mask0 = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    rnd = 3
    versions = np.full(K, rnd - tau, np.int32)
    alpha, beta, blocked = _posteriors()
    jstate = j_init_server_state(K)._replace(
        reputation=JReputationState(alpha, beta, blocked), round=np.int32(rnd))
    jstate, jres = j_server_step_versioned(
        jstate, rows, n_k, mask0, versions, rule="afa",
        opts=j_make_rule_options(JServerConfig(num_clients=K), K), layout="packed",
        staleness_decay=DECAY)
    state = init_server_state(K, device="cpu")
    state = state._replace(
        reputation=ReputationState(*(torch.from_numpy(a) for a in (alpha, beta, blocked))),
        round=rnd)
    state, res = server_step_versioned(
        state, torch.from_numpy(rows), torch.from_numpy(n_k), torch.from_numpy(mask0),
        torch.from_numpy(versions), rule="afa",
        opts=make_rule_options(ServerConfig(num_clients=K), K), staleness_decay=DECAY)
    assert np.array_equal(res.good_mask.numpy(), np.asarray(jres.good_mask))
    assert not res.good_mask.numpy()[:2].any() and res.good_mask.numpy()[2:6].all()
    rep = state.reputation
    np.testing.assert_allclose(rep.alpha.numpy(), np.asarray(jstate.reputation.alpha), rtol=1e-6)
    np.testing.assert_allclose(rep.beta.numpy(), np.asarray(jstate.reputation.beta), rtol=1e-6)
    ok = _margin_ok(rep.alpha.numpy(), rep.beta.numpy())
    assert np.array_equal(rep.blocked.numpy()[ok], np.asarray(jstate.reputation.blocked)[ok])
    assert np.array_equal(state.rounds_blocked.numpy()[ok],
                          np.asarray(jstate.rounds_blocked)[ok])
    assert state.round == rnd + 1 == int(jstate.round)


def test_versioned_step_without_decay_is_server_step():
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.standard_normal((K, 64)).astype(np.float32))
    n_k = torch.full((K,), 10.0)
    mask0 = torch.ones(K, dtype=torch.bool)
    opts = make_rule_options(ServerConfig(num_clients=K), K)
    for rnd in (2, torch.tensor(2, dtype=torch.int32)):   # host int or fused 0-d tensor
        state = init_server_state(K, device="cpu")._replace(round=rnd)
        a_state, a = server_step_versioned(state, rows, n_k, mask0, torch.zeros(K), rule="afa",
                                           opts=opts)
        b_state, b = server_step(state, rows, n_k, mask0, rule="afa", opts=opts,
                                 layout="matrix")
        assert torch.equal(a.aggregate, b.aggregate) and torch.equal(a.good_mask, b.good_mask)
        assert torch.equal(a_state.reputation.beta, b_state.reputation.beta)
        assert int(a_state.round) == 3
        c_state, _ = server_step_versioned(state, rows, n_k, mask0, torch.zeros(K), rule="afa",
                                           opts=opts, staleness_decay=0.5)
        assert int(c_state.round) == 3
    with pytest.raises(ValueError, match="staleness_decay"):
        server_step_versioned(state, rows, n_k, mask0, torch.zeros(K), rule="afa", opts=opts,
                              staleness_decay=1.5)


PAYLOADS = {
    "f32": lambda d: np.ones(d, np.float32),
    "f64": lambda d: np.linspace(-1, 1, d),
    "int32": lambda d: np.arange(d, dtype=np.int32),
    "wrong_length": lambda d: np.ones(d + 1, np.float32),
    "2d": lambda d: np.ones((1, d), np.float32),
    "nan": lambda d: np.where(np.arange(d) == 3, np.nan, 1.0).astype(np.float32),
    "inf": lambda d: np.where(np.arange(d) == 3, np.inf, 1.0),
    "complex": lambda d: np.ones(d, np.complex64),
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_validate_submission_decides_as_jax(jax_inputs, inputs, name):
    jspec = jax_inputs.workload.delta_spec(jax_inputs.params0)
    spec = inputs.workload.delta_spec(inputs.params0)
    assert spec.dim == jspec.dim
    payload = PAYLOADS[name](spec.dim)
    results = []
    for fn, s in ((j_validate_submission, jspec), (validate_submission, spec)):
        try:
            results.append(fn(s, payload))
        except ValueError:
            results.append(None)
    jrow, row = results
    assert (jrow is None) == (row is None)
    assert (row is not None) == (name in ("f32", "f64", "int32"))
    if row is not None:
        assert row.dtype == np.float32 and np.array_equal(row, np.asarray(jrow))
        # a tensor payload decides the same
        assert np.array_equal(validate_submission(spec, torch.from_numpy(payload)), row)


def _carried(jax_inputs):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_inputs.params0),
                             device="cpu")


def _schedule(services, rows_of, n_steps=300, seed=5):
    """The same submit / poll / flush schedule on each service: at each step
    one client submits the rows of a version 0-2 rounds old (a NaN row, a
    version from the future or a duplicate now and then); the services'
    counters must agree for the schedule to stay common, which the caller's
    assertions check."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for step in range(n_steps):
        t += float(rng.exponential(0.4))
        k = int(rng.integers(K))
        lag = int(rng.integers(3))
        rounds = {svc.round for svc in services}
        assert len(rounds) == 1
        version = max(rounds.pop() - lag, 0)
        payload = rows_of(version)[k]
        if step % 23 == 11:
            payload = np.full_like(payload, np.nan)
        if step % 31 == 17:
            version += 5
        for svc in services:
            svc.poll(t)
            svc.submit(k, payload, version, now=t)
    for svc in services:
        svc.flush(t + 1.0)


def test_aggregation_service_matches_jax(jax_inputs, inputs):
    w0 = _w0(jax_inputs)
    cache = {}

    def rows_of(version):
        if version not in cache:
            cache[version] = _rows(w0, version)
        return cache[version]

    server = ServerConfig(num_clients=K)
    jsvc = JAggregationService(jax_inputs.workload, JServerConfig(num_clients=K),
                               JServeConfig(**ASYNC), jax_inputs.params0, jax_inputs.data)
    svc = AggregationService(inputs.workload, server, ServeConfig(**ASYNC),
                             _carried(jax_inputs), inputs.data)
    _schedule([jsvc, svc], rows_of)
    assert svc.log == jsvc.log
    assert svc.decisions == jsvc.decisions
    assert all(svc.decisions[d] > 0 for d in svc.decisions if d != REJECTED_BLOCKED)
    assert svc.decisions[REJECTED_BLOCKED] > 0
    assert np.array_equal(svc.blocked, np.arange(K) < 2)
    assert len(svc.rounds) == len(jsvc.rounds) > ROUNDS
    n_test = DATA_KW["n_test"]
    for a, b in zip(svc.rounds, jsvc.rounds):
        for f in ("index", "opened_at", "fired_at", "trigger", "n_accepted", "all_blocked",
                  "n_blocked"):
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.good_mask, np.asarray(b.good_mask))
        assert abs(a.test_error - b.test_error) <= 1.0 / n_test + 1e-6
    assert np.array_equal(svc.rounds_blocked, np.asarray(jsvc.rounds_blocked))


class _StubPool:
    """Serves the same hand-made rows per (version, client) to either
    package's traffic driver."""

    def __init__(self, w0):
        self.w0 = w0
        self.bad_mask = np.arange(K) < 2
        self.cache = {}

    def row(self, client_id, version, params, blocked):
        if version not in self.cache:
            self.cache[version] = _rows(self.w0, version)
        return self.cache[version][int(client_id)].copy()


def test_traffic_driver_matches_jax(jax_inputs, inputs):
    w0 = _w0(jax_inputs)
    jsvc = JAggregationService(jax_inputs.workload, JServerConfig(num_clients=K),
                               JServeConfig(**ASYNC), jax_inputs.params0, jax_inputs.data)
    svc = AggregationService(inputs.workload, ServerConfig(num_clients=K),
                             ServeConfig(**ASYNC), _carried(jax_inputs), inputs.data)
    jrep = j_run_traffic(jsvc, _StubPool(w0), JTrafficConfig(**TRAFFIC), target_rounds=20)
    rep = run_traffic(svc, _StubPool(w0), TrafficConfig(**TRAFFIC), target_rounds=20)
    assert svc.log == jsvc.log
    assert rep.n_events == jrep.n_events and rep.end_time == jrep.end_time
    assert rep.decisions == jrep.decisions
    assert (rep.byz_submissions_after_block, rep.byz_rejected_at_ingress) == (
        jrep.byz_submissions_after_block, jrep.byz_rejected_at_ingress)
    assert rep.byz_submissions_after_block > 0
    assert [r.fired_at for r in rep.rounds] == [r.fired_at for r in jrep.rounds]
    assert not math.isnan(rep.byz_reject_fraction)
