"""Seed sweeps on the port's fused engine, on the CPU, at the JAX package's
test size (``tests/test_fused_engine.py``: 1000 training samples of
dimension 196, hidden (64, 32)); the counterparts of
``tests/test_fused_engine.py``'s sweep tests and of ``tests/test_api.py``'s
shim tests:

* the shapes of a ``SweepResult``;
* the row of ``sim.seed`` equals ``engine="fused"`` bit for bit, and the row
  of another seed equals ``scan_fn(init_params(Generator(s)), s, data)``;
* the segmented, compacted sweep equals the unsegmented one bit for bit,
  compacting on the union of the clients live in any seed: a client blocked
  in one seed only stays resident;
* distinct seeds give distinct draws and trajectories;
* the deprecated shims warn and match ``run``;
* each seed's ``blocked_round`` equals the JAX package's sweep on the same
  data (torch cannot replay ``jax.random``: decisions only).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import make_mnist_like as jax_make_mnist_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed import run as jax_run  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    ServerConfig,
    SimConfig,
    SweepResult,
    fused_inputs,
    get_workload,
    make_fused_sim,
    make_rule_options,
    run,
    run_llm_simulation,
    run_simulation,
    run_sweep,
    simulate,
    sweep,
)
from repro_torch.fed import simulator as simulator_mod  # noqa: E402
from repro_torch.fed.engine import _BATCH_STREAM  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.utils.philox import keyed_randint  # noqa: E402

DATA_KW = dict(n_train=1000, n_test=300, dim=196)
SEEDS = [3, 4, 5]


@pytest.fixture(scope="module")
def data():
    return make_mnist_like(**DATA_KW)


def _sim(scenario="byzantine", **kw):
    base = dict(num_clients=8, scenario=scenario, rounds=7, local_epochs=2, batch_size=100,
                hidden=(64, 32), dropout=True, seed=3, engine="fused")
    return SimConfig(**{**base, **kw})


def _server(K, variant="iterative", kernels=False):
    return ServerConfig(rule="afa", num_clients=K, afa_variant=variant,
                        kernel_plan=resolve_kernel_plan(kernels, kernel_launch="fused"))


def _same(a: SweepResult, b: SweepResult):
    for field in ("seeds", "test_error", "good_mask_history", "blocked_round", "bad_clients",
                  "detection_rate", "mean_rounds_to_block"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def test_sweep_shapes(data):
    sim = _sim()
    sw = run(None, sim, _server(8), data=data, seeds=SEEDS, device="cpu")
    assert isinstance(sw, SweepResult)
    assert sw.test_error.shape == (3, sim.rounds) and np.isfinite(sw.test_error).all()
    assert sw.good_mask_history.shape == (3, sim.rounds, 8)
    assert sw.good_mask_history.dtype == bool
    assert sw.blocked_round.shape == (3, 8)
    assert sw.detection_rate.shape == sw.mean_rounds_to_block.shape == (3,)
    np.testing.assert_array_equal(sw.seeds, SEEDS)
    np.testing.assert_array_equal(sw.bad_clients, [0, 1])
    assert sw.capture_time == 0.0          # no graph on the CPU
    np.testing.assert_array_equal(sw.detection_rate, [1.0, 1.0, 1.0])


@pytest.mark.parametrize("variant,kernels", [("iterative", False), ("gram", True)],
                         ids=["iterative/plain", "gram/fused"])
def test_sweep_row_of_sim_seed_equals_the_fused_run(data, variant, kernels):
    sim = _sim()
    server = _server(8, variant, kernels)
    sw = sweep(data, sim, server, [5, sim.seed], device="cpu")
    one = simulate(data, sim, server, device="cpu")
    np.testing.assert_array_equal(sw.test_error[1], np.asarray(one.test_error))
    np.testing.assert_array_equal(sw.good_mask_history[1], np.stack(one.good_mask_history))
    np.testing.assert_array_equal(sw.blocked_round[1], one.blocked_round)
    assert not np.array_equal(sw.test_error[0], sw.test_error[1])


def test_sweep_row_of_another_seed_equals_scan_fn(data):
    sim = _sim()
    server = _server(8)
    inp = fused_inputs(data, sim, device="cpu")
    scan_fn, _ = make_fused_sim(
        inp.workload, inp.engine_cfg, rule="afa", opts=make_rule_options(server, 8),
        delta_block=server.delta_block, num_clients=8, num_rounds=sim.rounds,
        batch_s=inp.batch_s, batch_b=inp.batch_b, bad_mask=inp.bad_mask, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(11)
    _, state, traj = scan_fn(inp.workload.init_params(gen, "cpu"), 11, inp.data)
    sw = sweep(data, sim, server, [sim.seed, 11], device="cpu")
    np.testing.assert_array_equal(sw.test_error[1], traj.test_error.numpy().astype(np.float64)
                                  * 100.0)
    np.testing.assert_array_equal(sw.good_mask_history[1], traj.good_mask.numpy())
    np.testing.assert_array_equal(sw.blocked_round[1], state.rounds_blocked.numpy())


# flipping, shards of seed 0, K = 10: seed 3 blocks clients 0-2 in round 6,
# seed 4 blocks 0 and 1 in round 6 and 2 in round 8, so from round 6 the
# union of live clients fits 8 rows with client 2 blocked in seed 3 only;
# and the 40 %-byzantine case of tests/test_fused_engine.py (10 -> 8 rows)
UNION_CASES = {
    "flipping-union": (dict(num_clients=10, scenario="flipping", rounds=10, seed=0), [3, 4]),
    "byzantine-40": (dict(num_clients=10, bad_frac=0.4, rounds=10), SEEDS),
}


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_segmented_sweep_equals_the_unsegmented_sweep(data, monkeypatch, case):
    kw, seeds = UNION_CASES[case]
    server = _server(10)
    kept = []
    real = simulator_mod._compact_inputs

    def recording(setup, k, bucket):
        kept.append((np.asarray(k).copy(), bucket))
        return real(setup, k, bucket)

    monkeypatch.setattr(simulator_mod, "_compact_inputs", recording)
    base = run(None, _sim(**kw), server, data=data, seeds=seeds, device="cpu")
    seg = run(None, _sim(**kw, segment_rounds=2), server, data=data, seeds=seeds, device="cpu")
    _same(base, seg)
    assert [b for _, b in kept] == [10, 8], kept      # compacted once, 10 -> 8 rows
    live = kept[1][0]
    blocked_in = (base.blocked_round > 0) & (base.blocked_round <= 6)
    assert not blocked_in[:, live].all(axis=0).any()  # no kept client blocked in every seed
    if case == "flipping-union":
        np.testing.assert_array_equal(base.blocked_round[:, :3], [[6, 6, 6], [6, 6, 8]])
        assert 2 in live and len(live) == 8           # blocked in seed 3 only, resident


def test_distinct_seeds_give_distinct_draws_and_trajectories(data):
    lengths = torch.full((10,), 100, dtype=torch.int64)
    for s_a, s_b in [(0, 1), (3, 4), (7, 1000)]:
        for rnd in (0, 5):
            offsets = rnd * 10 + torch.arange(10, dtype=torch.int64)
            a = keyed_randint(torch.tensor(s_a), _BATCH_STREAM, offsets, 32, lengths)
            b = keyed_randint(torch.tensor(s_b), _BATCH_STREAM, offsets, 32, lengths)
            assert not torch.equal(a[2], b[2])
    server = _server(10)
    for sim in (_sim(num_clients=10, bad_frac=0.4, rounds=10),
                _sim(num_clients=10, bad_frac=0.4, rounds=10, segment_rounds=4)):
        sw = run(None, sim, server, data=data, seeds=SEEDS, device="cpu")
        for i in range(3):
            for j in range(i + 1, 3):
                assert not np.array_equal(sw.test_error[i], sw.test_error[j])


def test_deprecated_shims_warn_and_match_run(data):
    sim, server = _sim(rounds=3), _server(8)
    with pytest.deprecated_call():
        old = run_sweep(data, sim, server, seeds=[0, 1], device="cpu")
    _same(old, run(None, sim, server, data=data, seeds=[0, 1], device="cpu"))
    batched = _sim(rounds=3, engine="batched")
    with pytest.deprecated_call():
        old = run_simulation(data, batched, server, device="cpu")
    new = run(None, batched, server, data=data, device="cpu")
    assert old.test_error == new.test_error
    np.testing.assert_array_equal(old.blocked_round, new.blocked_round)
    cfg = ModelConfig(name="t-api-lora", family="dense", num_layers=2, d_model=32,
                      vocab_size=64, num_heads=4, num_kv_heads=2, d_ff=64, block_q=16,
                      block_k=16)
    workload = get_workload("lora", model_cfg=cfg, rank=2)
    with pytest.deprecated_call():
        old = run_llm_simulation(workload, clients=4, byzantine=1, rounds=3, local_steps=1,
                                 batch=2, samples_per_client=8, seq=16, n_test=8, seed=0,
                                 scenario="byzantine", device="cpu")
    new = run(workload, SimConfig(num_clients=4, bad_frac=0.25, scenario="byzantine",
                                  rounds=3, local_epochs=1, batch_size=2, seed=0, lr=0.2),
              samples_per_client=8, seq=16, n_test=8, device="cpu")
    for key in ("test_error", "good_mask", "blocked", "rounds_blocked"):
        np.testing.assert_array_equal(old[key], new[key], err_msg=key)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run(None, sim, server, data=data, seeds=[0], device="cpu")  # the front door is quiet


def test_sweep_refuses_the_client_sharded_engine(data):
    with pytest.raises(ValueError, match="client-sharded"):
        sweep(data, _sim(client_shards=2), _server(8), [0, 1], device="cpu")


def test_sweep_blocks_like_the_jax_sweep():
    """The same numpy data through both packages' sweeps: every seed blocks
    the same clients in the same rounds."""
    kw = dict(num_clients=10, bad_frac=0.3, scenario="byzantine", rounds=7, local_epochs=2,
              batch_size=100, hidden=(64, 32), dropout=True, seed=3, engine="fused")
    seeds = [0, 1, 2]
    jres = jax_run(None, JSimConfig(**kw), JServerConfig(rule="afa", num_clients=10),
                   data=jax_make_mnist_like(**DATA_KW), seeds=seeds)
    tres = run(None, SimConfig(**kw), ServerConfig(rule="afa", num_clients=10),
               data=make_mnist_like(**DATA_KW), seeds=seeds, device="cpu")
    np.testing.assert_array_equal(tres.blocked_round, np.asarray(jres.blocked_round))
    np.testing.assert_array_equal(tres.bad_clients, np.asarray(jres.bad_clients))
    np.testing.assert_array_equal(tres.detection_rate, np.asarray(jres.detection_rate))
    np.testing.assert_array_equal(tres.blocked_round[:, :3], 6)
