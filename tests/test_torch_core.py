"""Trees, masked statistics, reputation and the kernel policy of the port
against the JAX package, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.special  # noqa: E402

from repro.core import stats as jstats  # noqa: E402
from repro.core.reputation import ReputationState as JRep  # noqa: E402
from repro.core.reputation import mark_blocked_round as jax_mark  # noqa: E402
from repro.core.reputation import update_reputation as jax_update  # noqa: E402
from repro.utils.trees import pack_stack as jax_pack_stack  # noqa: E402
from repro_torch.core import reputation as rep  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.kernels import policy  # noqa: E402
from repro_torch.utils import trees  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dnn_tree(K, rng):
    shapes = {"w0": (6, 5), "b0": (5,), "w1": (5, 4), "b1": (4,), "w2": (4, 3), "b2": (3,)}
    return {k: rng.normal(size=(K,) + s).astype(np.float32) for k, s in shapes.items()}


def test_pack_order_matches_jax_sorted_keys():
    rng = np.random.default_rng(0)
    tree = _dnn_tree(3, rng)
    spec = trees.pack_spec({k: torch.from_numpy(v) for k, v in tree.items()}, stacked=True)
    assert [p[0] for p in spec.treedef] == ["b0", "b1", "b2", "w0", "w1", "w2"]
    packed = trees.pack_stack({k: torch.from_numpy(v) for k, v in tree.items()}, spec)
    jpacked = jax_pack_stack({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))


def test_pack_round_trip_is_exact_for_nested_trees():
    rng = np.random.default_rng(1)
    tree = {"layer": {"w": torch.from_numpy(rng.normal(size=(4, 3, 2)).astype(np.float32)),
                      "b": torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32))},
            "head": torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))}
    spec = trees.pack_spec(tree, stacked=True)
    assert spec.dim == 3 * 2 + 2 + 5
    back = trees.unpack_stack(trees.pack_stack(tree, spec), spec)
    for a, b in zip(trees.tree_leaves(back), trees.tree_leaves(tree)):
        assert torch.equal(a, b)
    row = trees.unpack_stack(trees.pack_stack(tree, spec)[2], spec)
    assert torch.equal(row["layer"]["w"], tree["layer"]["w"][2])


def test_stack_select_broadcast():
    a = {"w": torch.zeros(2), "b": torch.ones(1)}
    s = trees.tree_stack([a, a, a])
    assert s["w"].shape == (3, 2)
    other = trees.tree_broadcast_clients({"w": torch.full((2,), 7.0), "b": torch.zeros(1)}, 3)
    sel = trees.tree_select_rows(torch.tensor([True, False, True]), s, other)
    np.testing.assert_array_equal(sel["w"][:, 0].numpy(), [0.0, 7.0, 0.0])


@pytest.mark.parametrize("seed", range(6))
def test_masked_stats_match_jax(seed):
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 16))
    x = rng.normal(size=K).astype(np.float32)
    mask = rng.random(K) < 0.6
    if seed == 0:
        mask[:] = False
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    np.testing.assert_allclose(float(stats.masked_mean(tx, tm)),
                               float(jstats.masked_mean(jx, jm)), rtol=1e-6)
    assert float(stats.masked_median(tx, tm)) == float(jstats.masked_median(jx, jm))
    for ddof in (0, 1):
        np.testing.assert_allclose(float(stats.masked_std(tx, tm, ddof=ddof)),
                                   float(jstats.masked_std(jx, jm, ddof=ddof)),
                                   rtol=1e-5, atol=1e-7)


def test_betainc_matches_scipy_and_jax():
    rng = np.random.default_rng(2)
    # integer counts, the fractional counts staleness decay gives, and x != 0.5
    a = np.concatenate([np.arange(1, 41), rng.uniform(0.5, 60, 60)])
    b = np.concatenate([np.arange(40, 0, -1), rng.uniform(0.5, 60, 60)])
    x = np.concatenate([np.full(40, 0.5), rng.uniform(0.01, 0.99, 60)])
    got = rep.betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, scipy.special.betainc(a, b, x), rtol=1e-10, atol=1e-13)
    want_f32 = np.asarray(jax.scipy.special.betainc(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want_f32, rtol=1e-4, atol=1e-6)
    assert rep.betainc(3.0, 3.0, 0.0) == 0.0 and rep.betainc(3.0, 3.0, 1.0) == 1.0


def test_min_rounds_to_block_is_six():
    assert rep.min_rounds_to_block() == 6
    np.testing.assert_allclose(float(rep.betainc(3.0, 8.0, 0.5)), 0.9453125, rtol=1e-12)
    np.testing.assert_allclose(float(rep.betainc(3.0, 9.0, 0.5)), 0.96728515625, rtol=1e-12)


def test_update_reputation_matches_jax():
    rng = np.random.default_rng(3)
    K = 12
    alpha = rng.integers(3, 8, K).astype(np.float32)
    beta = rng.integers(3, 10, K).astype(np.float32)
    blocked = rng.random(K) < 0.2
    for _ in range(5):
        good = rng.random(K) < 0.5
        part = rng.random(K) < 0.8
        j = jax_update(JRep(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(blocked)),
                       jnp.asarray(good), jnp.asarray(part))
        t = rep.update_reputation(
            rep.ReputationState(torch.from_numpy(alpha), torch.from_numpy(beta),
                                torch.from_numpy(blocked)),
            torch.from_numpy(good), torch.from_numpy(part))
        np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha))
        np.testing.assert_array_equal(t.beta.numpy(), np.asarray(j.beta))
        np.testing.assert_array_equal(t.blocked.numpy(), np.asarray(j.blocked))
        alpha, beta, blocked = t.alpha.numpy(), t.beta.numpy(), t.blocked.numpy()


def test_mark_blocked_round_matches_jax():
    rb = np.array([2, -1, -1, -1], np.int32)
    before = np.array([True, False, False, False])
    after = np.array([True, True, False, True])
    got = rep.mark_blocked_round(torch.from_numpy(rb), torch.from_numpy(before),
                                 torch.from_numpy(after), 6)
    want = jax_mark(jnp.asarray(rb), jnp.asarray(before), jnp.asarray(after), jnp.int32(6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [2, 7, -1, 7])
    assert got.dtype == torch.int32


def test_kernel_policy(monkeypatch):
    monkeypatch.delenv(policy.ENV_VAR, raising=False)
    assert policy.resolve_kernel_mode(False) == "torch"
    assert policy.resolve_kernel_mode(True) == "cuda"
    assert policy.resolve_kernel_mode("auto") == "cuda"
    assert policy.resolve_kernel_plan(True).mode is True
    assert policy.resolve_kernel_plan("cuda", kernel_launch="chained").launch == "chained"
    monkeypatch.setenv(policy.ENV_VAR, "torch")
    assert policy.resolve_kernel_mode(True) == "torch"
    assert policy.resolve_kernel_plan(True).mode == "torch"
    with pytest.raises(ValueError, match="conflicting"):
        policy.resolve_kernel_plan("cuda")
    monkeypatch.setenv(policy.ENV_VAR, "pallas")
    with pytest.raises(ValueError, match="invalid"):
        policy.requested_policy()
    with pytest.raises(ValueError):
        policy.KernelPlan(launch="bogus")
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    monkeypatch.setenv(policy.ENV_VAR, "auto")
    assert policy.resolve_kernel_mode(True) == "cuda"
