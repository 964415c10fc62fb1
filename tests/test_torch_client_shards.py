"""The port's client-sharded fused engine against the JAX package and
against its own unsharded engine, on the CPU (gloo ranks):

* ``shard_compact_plan`` equals the JAX package's, errors included;
* the sharded ``afa_aggregate`` on 4 ranks (plain route and the kernel
  route's CPU twins; stopping loop and ``unroll``) equals the JAX package's
  under ``jax.shard_map`` on 4 host devices: masks and rounds exactly,
  similarities and aggregate within 1e-6; and the port's unsharded call;
  with one all-reduce to gather n, p and the mask, three a pass and one
  for the final aggregate;
* sharded alie/ipm forged rows equal the JAX package's unsharded
  ``apply_update_attack`` within 1e-6, with exactly one all-reduce each;
* end to end at the JAX package's own sharded test configuration (its
  ``tests/test_distributed_equivalence.py``): 4 shards, segmented by 4 with
  per-shard compaction (5 rows a shard, then 4), and unsegmented, and
  alie/ipm at 4 shards, against the unsharded ``engine="fused"`` run:
  every round's ``good_mask`` and ``blocked_round`` equal, test error
  within 1e-4; 1 shard equal to the unsharded run bit for bit;
* the refusals: a rule other than AFA, a scenario without a sharded form,
  the leaf layout, K not divisible by the shards, a group of the wrong
  size, the gram variant, the tree dispatch, and ``run`` without a group.

The ranks are spawned once a world size (module fixtures); they import
this module, so the JAX package is imported only inside the tests that use
it.  The JAX package's sharded AFA runs in one subprocess with 4 forced
host devices.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.attacks import apply_update_attack  # noqa: E402
from repro_torch.core import AFAConfig, afa_aggregate, dispatch_rule_tree  # noqa: E402
from repro_torch.core.baselines import RuleOptions  # noqa: E402
from repro_torch.data import make_spambase_like, shard_compact_plan  # noqa: E402
from repro_torch.fed import ServerConfig, SimConfig, run  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402
from repro_torch.launch.shards import run_sharded, spawn  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S = 4
AFA_K, AFA_D, AFA_OUTLIERS = 16, 300, 4
ROUTES = ("torch", "cuda")     # the plain route, and the kernel route (its CPU twins)
TOL = 1e-6
ERR_TOL = 1e-4                 # percent, as the JAX package's sharded test holds it
K = 20


def afa_inputs():
    """Seeded (16, 300) f32 proposals, the first 4 outlying; one client
    masked out."""
    rng = np.random.default_rng(11)
    mu = rng.normal(size=AFA_D).astype(np.float32)
    updates = (mu + 0.5 * rng.normal(size=(AFA_K, AFA_D))).astype(np.float32)
    updates[:AFA_OUTLIERS] = 3.0 * rng.normal(size=(AFA_OUTLIERS, AFA_D))
    mask0 = np.ones(AFA_K, bool)
    mask0[-1] = False
    return {"updates": updates, "n_k": rng.integers(50, 150, AFA_K).astype(np.float32),
            "p_k": rng.uniform(0.4, 0.9, AFA_K).astype(np.float32), "mask0": mask0}


def attack_inputs():
    """The JAX package's sharded-attack test inputs: a two-leaf tree of 16
    rows, the first 5 byzantine."""
    rng = np.random.default_rng(3)
    props = {"w": rng.normal(size=(AFA_K, 33, 2)).astype(np.float32),
             "b": rng.normal(size=(AFA_K, 7)).astype(np.float32)}
    bad = np.zeros(AFA_K, bool)
    bad[:5] = True
    return props, bad


def e2e_data():
    return make_spambase_like(n_train=640, n_test=200, dim=24, seed=0)


def e2e_sim(shards, seg=0, **kw):
    """The JAX package's sharded trajectory test: 8 of 20 clients byzantine,
    16 rounds."""
    base = dict(num_clients=K, bad_frac=0.4, scenario="byzantine", rounds=16, local_epochs=1,
                batch_size=16, hidden=(8,), engine="fused", segment_rounds=seg,
                compact=seg > 0, client_shards=shards, seed=0)
    base.update(kw)
    return SimConfig(**base)


def attack_sim(shards, scenario):
    """The JAX package's sharded attack-matrix test: 16 clients, 4 of them
    alie or ipm, 8 rounds."""
    return SimConfig(num_clients=16, bad_frac=0.25, scenario=scenario, rounds=8, local_epochs=1,
                     batch_size=16, hidden=(8,), engine="fused", client_shards=shards, seed=0)


def attack_data():
    return make_spambase_like(n_train=480, n_test=160, dim=24, seed=0)


E2E = {  # label -> (sim, data maker)
    "byzantine/segmented": (lambda s: e2e_sim(s, seg=4), e2e_data),
    "byzantine/one-shot": (lambda s: e2e_sim(s), e2e_data),
    "alie": (lambda s: attack_sim(s, "alie"), attack_data),
    "ipm": (lambda s: attack_sim(s, "ipm"), attack_data),
}


def _refusals(mesh):
    """name -> a call that must raise under a 4-rank group."""
    data = e2e_data()
    fa = ServerConfig(rule="fa", num_clients=K)
    afa = ServerConfig(rule="afa", num_clients=K)
    leaf = ServerConfig(rule="afa", num_clients=K,
                        kernel_plan=resolve_kernel_plan(False, "leaf"))
    U = torch.zeros((AFA_K // S, AFA_D))
    ones = torch.ones(AFA_K // S)
    gram = AFAConfig(variant="gram", client_mesh=mesh)
    return {
        "rule": lambda: run(None, e2e_sim(S), fa, data=data, device="cpu"),
        "scenario": lambda: run(None, e2e_sim(S, scenario="sign_flip"), afa, data=data,
                                device="cpu"),
        "layout": lambda: run(None, e2e_sim(S), leaf, data=data, device="cpu"),
        "divisible": lambda: run(None, e2e_sim(S, num_clients=18),
                                 ServerConfig(rule="afa", num_clients=18), data=data,
                                 device="cpu"),
        "group_size": lambda: run(None, e2e_sim(3), afa, data=data, device="cpu"),
        "gram": lambda: afa_aggregate(U, ones, ones, config=gram),
        "tree_dispatch": lambda: dispatch_rule_tree("afa", {"w": U}, ones, ones,
                                                    opts=RuleOptions(afa=gram)),
    }


def _four_rank_worker(afa_in, attack_in):
    """Run on each of 4 gloo ranks; rank 0's dict is the fixture."""
    import repro_torch.fed.simulator as simulator
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(S, "cpu")
    out = {}
    rows = AFA_K // S
    blk = mesh.row_block(rows)
    U, n, p, m = (torch.from_numpy(afa_in[k][blk]) for k in ("updates", "n_k", "p_k", "mask0"))
    for route in ROUTES:
        for unroll in (False, True):
            cfg = AFAConfig(variant="iterative", use_kernels=route, client_mesh=mesh)
            before = mesh.all_reduces
            r = afa_aggregate(U, n, p, m, cfg, unroll=unroll)
            calls = mesh.all_reduces - before
            out[("afa", route, unroll)] = {
                "aggregate": r.aggregate.numpy(), "rounds": int(r.rounds), "all_reduces": calls,
                "good_mask": mesh.gather_rows(r.good_mask, AFA_K).numpy(),
                "similarities": mesh.gather_rows(r.similarities, AFA_K).numpy()}
    props, bad = attack_in
    local = {k: torch.from_numpy(v[blk]) for k, v in props.items()}
    w_prev = {k: torch.zeros(v.shape[1:]) for k, v in props.items()}
    bad_l = torch.from_numpy(bad[blk])
    for scenario in ("alie", "ipm"):
        before = mesh.all_reduces
        forged = apply_update_attack(scenario, local, w_prev, bad_l, ~bad_l, 0, mesh=mesh)
        calls = mesh.all_reduces - before
        out[("attack", scenario)] = {
            "all_reduces": calls,
            "forged": {k: mesh.gather_rows(v, AFA_K).numpy() for k, v in forged.items()}}
    # the segmented run's per-shard layouts: rows a shard at each compaction
    compact_rows = []
    compact = simulator._compact_inputs

    def recording(setup, kept, bucket):
        compact_rows.append(int(bucket))
        return compact(setup, kept, bucket)

    simulator._compact_inputs = recording
    for label, (make_sim, make_data) in E2E.items():
        compact_rows.clear()
        sim = make_sim(S)
        out[("e2e", label)] = run(None, sim, ServerConfig(rule="afa", num_clients=sim.num_clients),
                                  data=make_data(), device="cpu")
        out[("rows", label)] = list(compact_rows)
    simulator._compact_inputs = compact
    for name, call in _refusals(mesh).items():
        try:
            call()
        except (ValueError, RuntimeError) as e:
            out[("refused", name)] = f"{type(e).__name__}: {e}"
        else:
            out[("refused", name)] = None
    return out


@pytest.fixture(scope="module")
def four_ranks():
    return spawn(_four_rank_worker, S, backend="gloo", device="cpu",
                 args=(afa_inputs(), attack_inputs()))


@pytest.fixture(scope="module")
def one_rank():
    sim = e2e_sim(1)
    return run_sharded(None, sim, ServerConfig(rule="afa", num_clients=K), data=e2e_data(),
                       device="cpu")


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded engine="fused" run of each end-to-end case."""
    out = {}
    for label, (make_sim, make_data) in E2E.items():
        sim = make_sim(0)
        out[label] = run(None, sim, ServerConfig(rule="afa", num_clients=sim.num_clients),
                         data=make_data(), device="cpu")
    return out


JAX_AFA = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import AFAConfig, afa_aggregate
from repro.launch.mesh import make_client_mesh

d = np.load(sys.argv[1])
args = [jnp.asarray(d[k]) for k in ("updates", "n_k", "p_k", "mask0")]
cfg = AFAConfig(variant="iterative", client_axis="client", client_shards=4)

def shard(u, n, p, m):
    r = afa_aggregate(u, n, p, mask0=m, config=cfg)
    return r.aggregate, r.good_mask, r.rounds, r.similarities

fn = jax.shard_map(shard, mesh=make_client_mesh(4), in_specs=(P("client"),) * 4,
                   out_specs=(P(), P("client"), P(), P("client")), check_vma=False)
agg, good, rounds, sims = fn(*args)
np.savez(sys.argv[2], aggregate=np.asarray(agg), good_mask=np.asarray(good),
         rounds=np.asarray(rounds), similarities=np.asarray(sims))
"""


@pytest.fixture(scope="module")
def jax_sharded_afa(tmp_path_factory):
    """The JAX package's sharded AFA on 4 host devices, in a subprocess."""
    tmp = tmp_path_factory.mktemp("jax_afa")
    np.savez(tmp / "in.npz", **afa_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_AFA, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(np.load(tmp / "out.npz"))


# ---------------------------------------------------------------------------
# shard_compact_plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_live,shards,cap", [
    (20, 4, 5), (12, 4, 5), (13, 4, 5), (1, 4, 5), (0, 4, 5), (7, 1, 8), (9, 2, 8),
    (33, 8, 16), (5, 3, 4),
])
def test_shard_compact_plan_equals_the_reference(n_live, shards, cap):
    from repro.data import shard_compact_plan as jax_plan

    live = np.sort(np.random.default_rng(n_live).choice(shards * cap, n_live, replace=False))
    keep, rows = shard_compact_plan(live, shards, cap)
    want_keep, want_rows = jax_plan(live, shards, cap)
    assert rows == want_rows
    np.testing.assert_array_equal(keep, want_keep)
    assert keep.dtype == np.int64


@pytest.mark.parametrize("args", [(np.arange(9), 2, 4), (np.arange(3), 0, 4)])
def test_shard_compact_plan_errors_equal_the_reference(args):
    from repro.data import shard_compact_plan as jax_plan

    with pytest.raises(ValueError) as want:
        jax_plan(*args)
    with pytest.raises(ValueError) as got:
        shard_compact_plan(*args)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the sharded AFA step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("unroll", [False, True])
def test_sharded_afa_equals_the_reference_shard_map(four_ranks, jax_sharded_afa, route, unroll):
    got, want = four_ranks[("afa", route, unroll)], jax_sharded_afa
    np.testing.assert_array_equal(got["good_mask"], want["good_mask"])
    assert got["rounds"] == int(want["rounds"]) >= 2
    assert not got["good_mask"][:AFA_OUTLIERS].any()
    np.testing.assert_allclose(got["similarities"], want["similarities"], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["aggregate"], want["aggregate"], rtol=0, atol=TOL)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("unroll", [False, True])
def test_sharded_afa_equals_the_unsharded_call(four_ranks, route, unroll):
    got = four_ranks[("afa", route, unroll)]
    args = [torch.from_numpy(v) for v in afa_inputs().values()]
    want = afa_aggregate(*args, AFAConfig(variant="iterative", use_kernels=route), unroll=unroll)
    np.testing.assert_array_equal(got["good_mask"], want.good_mask.numpy())
    assert got["rounds"] == int(want.rounds)
    np.testing.assert_allclose(got["similarities"], want.similarities.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(got["aggregate"], want.aggregate.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("unroll", [False, True])
def test_sharded_afa_all_reduces(four_ranks, route, unroll):
    """One all-reduce for n, p and the mask, three a pass (the (d,)
    aggregate, the similarities, rank 0's statistics), one for the final
    aggregate; unrolled, every one of max_rounds passes runs them."""
    got = four_ranks[("afa", route, unroll)]
    passes = AFAConfig().max_rounds if unroll else got["rounds"]
    assert got["all_reduces"] == 1 + 3 * passes + 1


# ---------------------------------------------------------------------------
# sharded alie / ipm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["alie", "ipm"])
def test_sharded_attack_equals_the_reference_with_one_all_reduce(four_ranks, scenario):
    import jax
    import jax.numpy as jnp

    from repro.attacks import apply_update_attack as jax_attack

    props, bad = attack_inputs()
    got = four_ranks[("attack", scenario)]
    assert got["all_reduces"] == 1
    w_prev = {k: jnp.zeros(v.shape[1:], jnp.float32) for k, v in props.items()}
    want = jax_attack(scenario, {k: jnp.asarray(v) for k, v in props.items()}, w_prev,
                      jnp.asarray(bad), jnp.asarray(~bad), jax.random.PRNGKey(0))
    for k in props:
        np.testing.assert_allclose(got["forged"][k], np.asarray(want[k]), rtol=0, atol=TOL)
    # the benign rows pass through untouched
    for k, v in props.items():
        np.testing.assert_array_equal(got["forged"][k][~bad], v[~bad])


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", list(E2E))
def test_sharded_run_equals_the_unsharded_run(four_ranks, unsharded, label):
    got, want = four_ranks[("e2e", label)], unsharded[label]
    np.testing.assert_array_equal(np.stack(got.good_mask_history),
                                  np.stack(want.good_mask_history))
    np.testing.assert_array_equal(got.blocked_round, want.blocked_round)
    np.testing.assert_allclose(got.test_error, want.test_error, rtol=ERR_TOL, atol=ERR_TOL)


def test_sharded_segments_compact_per_shard(four_ranks, unsharded):
    """8 byzantine clients blocked: the 12 live ones move from 5 rows a
    shard into 4."""
    want = unsharded["byzantine/segmented"]
    assert set(np.nonzero(want.blocked_round > 0)[0]) == set(want.bad_clients.tolist())
    assert four_ranks[("rows", "byzantine/segmented")] == [5, 4]
    assert four_ranks[("rows", "byzantine/one-shot")] == [K // S]


def test_compacted_pad_slots_are_inert():
    """A rank's block of ``shard_compact_plan`` ends in -1 pad slots: they
    get a zero shard of length 1, zero n_k, a benign flag and id 0, never
    the last client's."""
    import repro_torch.fed.simulator as simulator

    setup = simulator._Setup(e2e_data(), e2e_sim(0), torch.device("cpu"))
    live = [int(np.nonzero(setup.bad_mask)[0][0]), K - 1]
    data, bad, ids = simulator._compact_inputs(setup, np.array(live + [-1, -1]), 5)
    np.testing.assert_array_equal(data.n_k.numpy(), np.r_[setup.n_k[live], 0, 0, 0])
    assert bad.tolist() == setup.bad_mask[live].tolist() + [False] * 3
    assert ids.tolist() == live + [0] * 3
    assert data.lengths.tolist()[2:] == [1] * 3 and not data.x[2:].any()


def test_one_shard_equals_the_unsharded_run_bit_for_bit(one_rank, unsharded):
    want = unsharded["byzantine/one-shot"]
    assert list(one_rank.test_error) == list(want.test_error)
    np.testing.assert_array_equal(np.stack(one_rank.good_mask_history),
                                  np.stack(want.good_mask_history))
    np.testing.assert_array_equal(one_rank.blocked_round, want.blocked_round)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


REFUSALS = {
    "rule": "rule 'fa' has no client-sharded form",
    "scenario": "scenario 'sign_flip' has no client-sharded form",
    "layout": "requires the packed layout",
    "divisible": "client rows (18) must divide evenly over the 4 client shards",
    "group_size": "client mesh wants 3 shards but the process group has 4 ranks",
    "gram": "sharded AFA implements the iterative variant only",
    "tree_dispatch": "tree dispatch has no client-sharded form",
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_sharded_refusals(four_ranks, name):
    msg = four_ranks[("refused", name)]
    assert msg is not None, f"{name}: nothing raised"
    assert REFUSALS[name] in msg


def test_run_without_a_group_names_run_sharded():
    with pytest.raises(RuntimeError, match="run_sharded"):
        run(None, e2e_sim(S), ServerConfig(rule="afa", num_clients=K), data=e2e_data(),
            device="cpu")


@pytest.mark.parametrize("engine", ["batched", "fused_eager", "looped"])
def test_client_shards_need_the_fused_engine(engine):
    with pytest.raises(ValueError, match="client_shards requires engine='fused'"):
        run(None, e2e_sim(S, engine=engine), ServerConfig(rule="afa", num_clients=K),
            data=e2e_data(), device="cpu")


def test_sweep_refuses_client_shards():
    with pytest.raises(ValueError, match="client-sharded"):
        run(None, e2e_sim(S), ServerConfig(rule="afa", num_clients=K), data=e2e_data(),
            seeds=[0, 1], device="cpu")
