"""The port's fused and segmented round engines on the CPU, at the JAX
package's test size (``tests/test_fused_engine.py``: 1000 training samples
of dimension 196, hidden (64, 32)):

* ``fused`` equals ``fused_eager`` bit for bit: test error, ``good_mask``
  history and blocked rounds (on the CPU both run the round body in a loop;
  ``chip_smoke.py`` holds the CUDA graph to the eager body on the card);
* the segmented run, with and without compaction, equals the one-shot run
  bit for bit, on the 40 %-byzantine case whose compaction drops the client
  axis from 10 rows to 8 and on a ragged last segment;
* afa, fa, mkrum, comed and trimmed_mean run through the fused engine, and
  the kernel routes (each wrapper's CPU twin) as well;
* the port's fused run and the JAX package's, on the same numpy data and
  the same initial parameters, both block every byzantine client in round
  ``min_rounds_to_block()`` and no good client, and end within 15
  percentage points of test error (their random streams differ, as
  ``tests/test_fused_engine.py`` allows between engines);
* the paper DNN at full width runs through ``run`` on both fused engines;
* a wrapper call recorded into a CUDA graph is not counted as a launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import make_mnist_like as jax_make_mnist_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed import run as jax_run  # noqa: E402
from repro.fed.workload import DnnWorkload as JDnnWorkload  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import min_rounds_to_block  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    DnnWorkload,
    ServerConfig,
    SimConfig,
    SimResult,
    fused_inputs,
    make_fused_sim,
    make_rule_options,
    run,
)
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

DATA_KW = dict(n_train=1000, n_test=300, dim=196)
# what tests/test_fused_engine.py:74 allows between engines whose streams differ
ENGINE_TOL_PP = 15.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eq_data():
    return make_mnist_like(**DATA_KW)


def _sim(scenario, engine, rounds=5, seed=3, **kw):
    return SimConfig(num_clients=8, scenario=scenario, rounds=rounds, local_epochs=2,
                     batch_size=100, hidden=(64, 32), dropout=True, seed=seed,
                     engine=engine, **kw)


def _run(data, sim, rule="afa"):
    return run(None, sim, ServerConfig(rule=rule, num_clients=sim.num_clients), data=data,
               device="cpu")


def _assert_same_trajectory(a, b):
    np.testing.assert_array_equal(np.asarray(a.test_error), np.asarray(b.test_error))
    np.testing.assert_array_equal(np.stack(a.good_mask_history), np.stack(b.good_mask_history))
    np.testing.assert_array_equal(a.blocked_round, b.blocked_round)


@pytest.mark.parametrize("scenario", ["clean", "byzantine"])
def test_fused_bit_equal_to_fused_eager(eq_data, scenario):
    fused = _run(eq_data, _sim(scenario, "fused"))
    eager = _run(eq_data, _sim(scenario, "fused_eager"))
    _assert_same_trajectory(fused, eager)
    assert len(fused.good_mask_history) == 5 and fused.good_mask_history[0].shape == (8,)
    assert fused.capture_time == 0.0 and fused.train_time == 0.0 and fused.agg_time == 0.0
    assert fused.round_time > 0 and len(fused.round_times) == 5


def test_fused_engine_trains(eq_data):
    res = _run(eq_data, _sim("clean", "fused", rounds=6))
    assert np.isfinite(res.test_error).all()
    assert res.test_error[-1] < res.test_error[0]


def _seg_sim(scenario, rounds=12, **kw):
    """40 % byzantine at K = 10: AFA blocks 4 clients, and compaction drops
    the client axis from 10 rows to 8."""
    return SimConfig(num_clients=10, bad_frac=0.4, scenario=scenario, rounds=rounds,
                     local_epochs=2, batch_size=100, hidden=(64, 32), dropout=True, seed=3,
                     engine="fused", **kw)


def test_segmented_compacted_bit_equals_one_shot(eq_data):
    base = _run(eq_data, _seg_sim("byzantine"))
    seg = _run(eq_data, _seg_sim("byzantine", segment_rounds=4, compact=True))
    # the scenario engages compaction: 4 blocked, 6 live -> a bucket of 8
    assert int((base.blocked_round > 0).sum()) == 4
    assert base.blocked_round[:4].max() < 12 - 4
    _assert_same_trajectory(base, seg)


def test_segmented_without_compaction_bit_equals_one_shot(eq_data):
    base = _run(eq_data, _seg_sim("clean", rounds=7))
    seg = _run(eq_data, _seg_sim("clean", rounds=7, segment_rounds=3, compact=False))
    _assert_same_trajectory(base, seg)


def test_segmented_ragged_last_segment(eq_data):
    base = _run(eq_data, _seg_sim("byzantine", rounds=11))
    seg = _run(eq_data, _seg_sim("byzantine", rounds=11, segment_rounds=5))
    _assert_same_trajectory(base, seg)


@pytest.mark.parametrize("rule", ["afa", "fa", "mkrum", "comed", "trimmed_mean"])
def test_fused_engine_serves_registry_rules(eq_data, rule):
    res = _run(eq_data, _sim("clean", "fused", rounds=3), rule=rule)
    assert np.isfinite(res.test_error).all()
    assert len(res.good_mask_history) == 3
    assert res.good_mask_history[0].shape == (8,)
    eager = _run(eq_data, _sim("clean", "fused_eager", rounds=3), rule=rule)
    _assert_same_trajectory(res, eager)


@pytest.mark.parametrize("rule,variant,launch", [
    ("afa", "iterative", "fused"), ("afa", "gram", "chained"), ("afa", "gram", "fused"),
    ("comed", "iterative", "fused"), ("trimmed_mean", "iterative", "fused"),
])
def test_fused_engine_on_the_kernel_routes(eq_data, rule, variant, launch):
    """The kernel routes through the fused engine: on the CPU each wrapper
    takes its twin (``afa_screen``'s runs Algorithm 1's loop inside), and the
    unrolled screening of the chained routes calls them pass after pass."""
    server = ServerConfig(rule=rule, num_clients=10, afa_variant=variant,
                          kernel_plan=resolve_kernel_plan(True, kernel_launch=launch))
    res = {}
    for engine in ("fused", "fused_eager"):
        sim = SimConfig(num_clients=10, bad_frac=0.3, scenario="byzantine", rounds=7,
                        local_epochs=2, batch_size=100, hidden=(64, 32), seed=3, engine=engine)
        res[engine] = run(None, sim, server, data=eq_data, device="cpu")
    _assert_same_trajectory(res["fused"], res["fused_eager"])
    if rule == "afa":
        np.testing.assert_array_equal(res["fused"].blocked_round,
                                      [min_rounds_to_block()] * 3 + [-1] * 7)


def test_fused_run_agrees_with_the_jax_fused_run(monkeypatch):
    """The same numpy data and initial parameters through both packages'
    fused engines, 3 of 10 clients byzantine."""
    kw = dict(num_clients=10, bad_frac=0.3, scenario="byzantine", rounds=8, local_epochs=2,
              batch_size=100, hidden=(64, 32), dropout=True, seed=3, engine="fused")
    jdata = jax_make_mnist_like(**DATA_KW)
    jres = jax_run(None, JSimConfig(**kw), JServerConfig(rule="afa", num_clients=10),
                   data=jdata)
    p0 = JDnnWorkload((196, 64, 32, 10)).init_params(jax.random.PRNGKey(3))
    p0_np = jax.tree_util.tree_map(np.asarray, p0)
    monkeypatch.setattr(DnnWorkload, "init_params",
                        lambda self, gen, device: params_from_numpy(p0_np, device=device))
    tres = run(None, SimConfig(**kw), ServerConfig(rule="afa", num_clients=10),
               data=make_mnist_like(**DATA_KW), device="cpu")
    n_min = min_rounds_to_block()
    for res in (tres, jres):
        bad = np.asarray(res.bad_clients)
        good = np.setdiff1d(np.arange(10), bad)
        np.testing.assert_array_equal(np.asarray(res.blocked_round)[bad], [n_min] * len(bad))
        np.testing.assert_array_equal(np.asarray(res.blocked_round)[good], [-1] * len(good))
    assert abs(tres.test_error[-1] - jres.test_error[-1]) < ENGINE_TOL_PP


@pytest.mark.parametrize("engine", ["fused", "fused_eager"])
def test_paper_dnn_runs_through_run(engine):
    """The paper DNN at full width (784 x 512 x 256 x 10, D = 535,818) on a
    small dataset: two rounds, the byzantine noise drawn over the whole D."""
    data = make_mnist_like(n_train=200, n_test=50, dim=784)
    sim = SimConfig(num_clients=4, bad_frac=0.25, scenario="byzantine", rounds=2,
                    local_epochs=1, batch_size=50, seed=0, engine=engine)
    res = run(None, sim, ServerConfig(rule="afa", num_clients=4), data=data, device="cpu")
    assert np.isfinite(res.test_error).all() and len(res.test_error) == 2
    assert not res.good_mask_history[0][0]    # the byzantine row is screened out


def test_fused_inputs_and_scan_on_the_cpu(eq_data):
    sim = _sim("byzantine", "fused")
    inp = fused_inputs(eq_data, sim, device="cpu")
    assert inp.data.x.shape[0] == 8 and inp.batch_b == 100 and inp.batch_s == 2
    np.testing.assert_array_equal(inp.bad_mask, np.arange(8) < 2)
    server = ServerConfig(rule="afa", num_clients=8)
    scan_fn, _ = make_fused_sim(
        inp.workload, inp.engine_cfg, rule="afa", opts=make_rule_options(server, 8),
        delta_block=0.95, num_clients=8, num_rounds=2, batch_s=inp.batch_s,
        batch_b=inp.batch_b, bad_mask=inp.bad_mask, device="cpu")
    stats = {}
    params, state, traj = scan_fn(inp.params0, sim.seed, inp.data, stats=stats)
    assert stats == {"capture_s": 0.0}     # no graph on the CPU: the body loops
    assert traj.test_error.shape == (2,) and traj.good_mask.shape == (2, 8)
    assert int(state.round) == 2 and state.round.dtype == torch.int32
    assert set(params) == set(inp.params0)


def test_unported_engine_and_workload_raise(eq_data):
    looped = _run(eq_data, _sim("clean", "looped", rounds=1))
    assert isinstance(looped, SimResult) and len(looped.test_error) == 1
    with pytest.raises(ValueError, match="unknown engine"):
        _run(eq_data, _sim("clean", "scan"))


@pytest.mark.parametrize("capturing,counted", [(False, 1), (True, 0)])
def test_a_call_recorded_into_a_graph_is_not_counted(monkeypatch, capturing, counted):
    """A wrapper counts a launch only where it launches: a call made while
    the stream is captured records the kernel and launches nothing."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    ops.reset_launch_counts()
    try:
        ops._count_launch("afa_screen")
        assert ops.LAUNCH_COUNTS == {**dict.fromkeys(ops.LAUNCH_COUNTS, 0),
                                     "afa_screen": counted}
    finally:
        ops.reset_launch_counts()
