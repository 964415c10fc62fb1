"""Two places where the segmented fused engine's contract, "the stitched
trajectory equals the one-shot run's", did not hold; each checked on the CPU.

* The alie and ipm attacks forge their rows from the benign moments.  Those
  sums are row-order folds (``core.stats.row_sum``), so the round body on a
  compacted layout (10 clients, rows 0-1 blocked and dropped, row 2 bad and
  live) forges the same rows, bit for bit, as on the full layout, and the
  whole round gives the same parameters and screening.
* The Gram kernels (``gram``, ``afa_screen``) sum each entry over D in the
  column chunks of ``ops.gram_geometry``'s split, which grows with K.  The
  fused engines pass the run's full K (``RuleOptions.plan_rows``), so every
  bucket of a run is planned alike: at D = 535,818 on 132 multiprocessors
  the 128-row bucket of a 200-client run splits as the 200-row buffer does.
  The card holds the kernels' Gram bit for bit across buckets
  (``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import afa as afa_mod  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    ServerConfig,
    SimConfig,
    fused_inputs,
    fused_server_state,
    gather_server_state,
    make_fused_segment,
    make_packed_propose_fn,
    make_rule_options,
    run,
)
from repro_torch.fed.engine import FusedData  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

K = 10
D_PAPER = 535_818
SM_COUNT = 132
ROUND = 6          # the round run on both layouts
DROPPED = 2        # rows 0-1: blocked, and compacted away


def _sim(scenario):
    return SimConfig(num_clients=K, bad_frac=0.3, scenario=scenario, rounds=8, local_epochs=2,
                     batch_size=100, hidden=(64, 32), dropout=True, seed=1, engine="fused")


@pytest.fixture(scope="module")
def data():
    return make_mnist_like(n_train=1000, n_test=200, dim=196)


def _layouts(inputs, server):
    """The full layout with clients 0-1 blocked, and the same clients
    compacted into an 8-row bucket: (data, state, bad, ids) each."""
    full_state = fused_server_state(K, server.alpha0, server.beta0, "cpu")
    rep = full_state.reputation
    blocked = rep.blocked.clone()
    blocked[:DROPPED] = True
    beta = rep.beta.clone()
    beta[:DROPPED] += ROUND
    rounds_blocked = full_state.rounds_blocked.clone()
    rounds_blocked[:DROPPED] = ROUND
    full_state = full_state._replace(reputation=rep._replace(beta=beta, blocked=blocked),
                                     rounds_blocked=rounds_blocked,
                                     round=torch.tensor(ROUND, dtype=torch.int32))
    bad = torch.from_numpy(inputs.bad_mask)
    ids = torch.arange(K, dtype=torch.int64)
    kept = np.arange(DROPPED, K)
    d = inputs.data
    data_c = FusedData(d.x[DROPPED:], d.y[DROPPED:], d.lengths[DROPPED:], d.n_k[DROPPED:],
                       d.x_test, d.y_test)
    state_c = gather_server_state(full_state, kept, K - DROPPED)
    return ((d, full_state, bad, ids),
            (data_c, state_c, bad[DROPPED:].clone(), ids[DROPPED:].clone()))


@pytest.mark.parametrize("scenario", ["alie", "ipm"])
def test_compaction_leaves_the_forged_rows_and_the_round_unchanged(data, scenario):
    sim = _sim(scenario)
    inputs = fused_inputs(data, sim, device="cpu")
    assert inputs.bad_mask[DROPPED] and not inputs.bad_mask[DROPPED:].all()
    server = ServerConfig(num_clients=K)
    full, compact = _layouts(inputs, server)
    seed = torch.tensor(sim.seed, dtype=torch.int64)
    rnd = torch.tensor(ROUND, dtype=torch.int64)

    propose = make_packed_propose_fn(inputs.workload, inputs.engine_cfg, K, inputs.batch_s,
                                     inputs.batch_b)
    rows = [propose(inputs.params0, state.reputation.blocked, rnd, seed, d, bad, ids)
            for d, state, bad, ids in (full, compact)]
    assert bool(full[2][DROPPED])   # row 2 is bad and live: its forged row is compared
    assert torch.equal(rows[0][DROPPED:], rows[1])

    segment = make_fused_segment(
        inputs.workload, inputs.engine_cfg, rule="afa", opts=make_rule_options(server, K),
        delta_block=server.delta_block, num_clients_total=K, num_rounds=sim.rounds,
        batch_s=inputs.batch_s, batch_b=inputs.batch_b, device="cpu")
    out = [segment(inputs.params0, state, sim.seed, d, bad, ids, ROUND, 1)
           for d, state, bad, ids in (full, compact)]
    (p_full, s_full, t_full), (p_c, s_c, t_c) = out
    for name in p_full:
        assert torch.equal(p_full[name], p_c[name]), name
    assert torch.equal(t_full.test_error, t_c.test_error)
    assert torch.equal(t_full.good_mask[:, DROPPED:], t_c.good_mask)
    assert torch.equal(s_full.reputation.alpha[DROPPED:], s_c.reputation.alpha)
    assert torch.equal(s_full.reputation.beta[DROPPED:], s_c.reputation.beta)


# --- the Gram's column split -------------------------------------------------------


@pytest.mark.parametrize("sms", [114, SM_COUNT])
@pytest.mark.parametrize("bucket", [1, 16, 32, 64, 128, 200])
def test_every_bucket_of_a_run_splits_d_as_the_full_buffer_does(bucket, sms):
    full = ops.gram_geometry(200, D_PAPER, 1 << 20, sms)
    geo = ops.gram_geometry(bucket, D_PAPER, 1 << 20, sms, plan_rows=200)
    assert (geo.nsplit, geo.chunk) == (full.nsplit, full.chunk)
    # tiles and pairs stay the bucket's own
    own = ops.gram_geometry(bucket, D_PAPER, 1 << 20, sms)
    assert (geo.tile_rows, geo.ntiles, geo.npairs, geo.entries) == (
        own.tile_rows, own.ntiles, own.npairs, own.entries)
    assert 4 * geo.nsplit * (geo.entries + bucket) <= ops.GRAM_PARTIALS_CAP


def test_without_a_plan_the_split_follows_k():
    splits = {k: ops.gram_geometry(k, D_PAPER, 1 << 20, SM_COUNT).nsplit
              for k in (200, 128, 64, 32, 10)}
    assert splits == {200: 38, 128: 106, 64: 349, 32: 1047, 10: 1047}
    for k in (200, 10):   # the plan for K itself is the plan without one
        assert (ops.gram_geometry(k, D_PAPER, 1 << 20, SM_COUNT, plan_rows=k)
                == ops.gram_geometry(k, D_PAPER, 1 << 20, SM_COUNT))


def test_a_plan_for_fewer_rows_than_the_operand_is_refused():
    with pytest.raises(ValueError, match="plan_rows"):
        ops.gram_geometry(200, D_PAPER, 1 << 20, SM_COUNT, plan_rows=128)


class _StandIn:
    """Records the C entries' arguments in place of the kernel library."""

    def __init__(self):
        self.calls = {}

    def repro_screen_max_k(self):
        return 1528

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.mark.parametrize("entry", ["gram", "afa_screen"])
def test_the_wrappers_split_a_bucket_as_planned(monkeypatch, entry):
    monkeypatch.setattr(ops, "_sm_count", lambda index: SM_COUNT)
    D = 50_000
    u = torch.zeros((128, D), dtype=torch.float32)
    pn = torch.ones((128,), dtype=torch.float32)
    mask = torch.ones((128,), dtype=torch.bool)
    plans = {}
    for plan_rows in (None, 200):
        lib = _StandIn()
        if entry == "gram":
            ops._gram_cuda(lib, 0, u, plan_rows)
            args = lib.calls["repro_gram"]
            plans[plan_rows] = args[6:8]          # nsplit, chunk
        else:
            ops._afa_screen_cuda(lib, 0, u, pn, mask, xi0=2.0, delta_xi=0.5, max_rounds=8,
                                 ddof=0, plan_rows=plan_rows)
            args = lib.calls["repro_afa_screen"]
            plans[plan_rows] = args[16:18]        # nsplit, chunk
    want = ops.gram_geometry(200, D, u.data_ptr(), SM_COUNT)
    assert plans[200] == (want.nsplit, want.chunk)
    own = ops.gram_geometry(128, D, u.data_ptr(), SM_COUNT)
    assert plans[None] == (own.nsplit, own.chunk) != plans[200]


@pytest.mark.parametrize("launch,wrapper", [("fused", "afa_screen"), ("chained", "gram")])
def test_the_segmented_engine_plans_every_bucket_for_the_full_k(monkeypatch, data, launch,
                                                                wrapper):
    seen = []
    real = getattr(afa_mod.kernel_ops, wrapper)

    def spy(updates, *args, **kw):
        seen.append((updates.shape[0], kw.get("plan_rows")))
        return real(updates, *args, **kw)

    monkeypatch.setattr(afa_mod.kernel_ops, wrapper, spy)
    sim = SimConfig(num_clients=K, bad_frac=0.4, scenario="byzantine", rounds=8,
                    local_epochs=1, batch_size=100, hidden=(16,), dropout=False, seed=0,
                    engine="fused", segment_rounds=2)
    server = ServerConfig(num_clients=K, afa_variant="gram",
                          kernel_plan=resolve_kernel_plan("cuda", kernel_launch=launch))
    run(None, sim, server, data=data, device="cpu")
    assert {rows for rows, _ in seen} == {10, 8}       # a compaction happened
    assert {plan for _, plan in seen} == {K}
