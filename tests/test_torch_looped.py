"""The port's looped engine, AFA's tree form, the leaf layout and the rest of
``FedServer``'s API on the CPU.

* ``engine="looped"`` equals ``"batched"`` on the port (clean, byzantine,
  alie, ipm), as ``tests/test_round_engine.py`` holds the JAX engines, and
  the port's looped run matches the JAX package's looped run (clean,
  flipping) with the JAX ``params0`` carried over;
* ``afa_aggregate_tree`` against the JAX one, both variants, at
  ``max_rounds`` 0 and the default;
* ``dispatch_rule_tree(layout="leaf")`` against ``layout="packed"`` for
  every rule, to the bounds of ``tests/test_packed.py``: matrix-only rules
  bit for bit, AFA's tree form within rtol 2e-5 / atol 2e-6;
* ``server_step`` and ``server_step_versioned`` on the four layouts,
  ``KernelPlan.layout``, ``FedServer.select(rng, frac)`` against the JAX
  draw, ``FedServer.aggregate`` against ``aggregate_tree``, and the tree
  helpers of ``utils/trees.py`` against the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.utils.trees as jtrees  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.utils.trees as ttrees  # noqa: E402
from repro.fed import FedServer as JFedServer  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.kernels.policy import resolve_kernel_plan as jax_plan  # noqa: E402
from repro_torch.core import min_rounds_to_block  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    FedServer,
    ServerConfig,
    SimConfig,
    init_server_state,
    make_rule_options,
    run,
    server_step,
    server_step_versioned,
)
from repro_torch.kernels.policy import KernelPlan, resolve_kernel_plan  # noqa: E402
from test_torch_scenarios import parity_run  # noqa: E402

RULES = sorted(tcore.RULES)
K = 10
SIZES = (20, 12, 8, 3)  # a small paper DNN: leaves b0, b1, b2, w0, w1, w2
LEAF_RTOL, LEAF_ATOL = 2e-5, 2e-6   # tests/test_packed.py:187 for AFA's tree form
SIM_TOL = 1e-6


# ------------------------------ looped engine --------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eq_data():
    return make_mnist_like(n_train=1000, n_test=300, dim=196)


def _engine_run(data, scenario, engine, dropout=True):
    sim = SimConfig(num_clients=8, scenario=scenario, rounds=5, local_epochs=2,
                    batch_size=100, hidden=(64, 32), dropout=dropout, seed=3, engine=engine)
    return run(None, sim, ServerConfig(num_clients=8), data=data, device="cpu")


@pytest.mark.parametrize("scenario,dropout", [
    ("clean", True), ("byzantine", True), ("alie", False), ("ipm", False),
])
def test_looped_equals_batched(eq_data, scenario, dropout):
    """Same seeds -> the same per-round test error and good_mask history: the
    engines share the minibatch draws, the per-client seeds, the attacks
    and the aggregation, and differ only in the client layer."""
    looped = _engine_run(eq_data, scenario, "looped", dropout)
    batched = _engine_run(eq_data, scenario, "batched", dropout)
    np.testing.assert_allclose(looped.test_error, batched.test_error, rtol=0, atol=1e-3)
    assert len(looped.good_mask_history) == len(batched.good_mask_history) == 5
    for gl, gb in zip(looped.good_mask_history, batched.good_mask_history):
        np.testing.assert_array_equal(gl, gb)
    np.testing.assert_array_equal(looped.blocked_round, batched.blocked_round)


@pytest.mark.parametrize("scenario", ["clean", "flipping"])
def test_looped_matches_jax(monkeypatch, scenario):
    parity_run(monkeypatch, "mnist", scenario, 3, engine="looped")


def test_leaf_layout_run_blocks_in_the_paper_round():
    data = make_mnist_like(n_train=1000, n_test=200, dim=64)
    sim = SimConfig(num_clients=K, scenario="byzantine", rounds=7, local_epochs=1,
                    batch_size=50, hidden=(32, 16), seed=3)
    for variant in ("iterative", "gram"):
        server = ServerConfig(num_clients=K, afa_variant=variant,
                              kernel_plan=resolve_kernel_plan(True, "leaf"))
        res = run(None, sim, server, data=data, device="cpu")
        np.testing.assert_array_equal(res.blocked_round,
                                      [min_rounds_to_block()] * 3 + [-1] * (K - 3))


# ---------------------------- stacked proposals ------------------------------


def _proposals(seed, n_bad=3):
    """One (K, ...) array per leaf of the small DNN: a benign cluster and
    ``n_bad`` byzantine rows (base + N(0, 20^2 I))."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i, (fi, fo) in enumerate(zip(SIZES[:-1], SIZES[1:])):
        for name, shape in ((f"w{i}", (fi, fo)), (f"b{i}", (fo,))):
            base = rng.normal(size=shape).astype(np.float32)
            leaf = base + 0.3 * rng.normal(size=(K,) + shape).astype(np.float32)
            leaf[:n_bad] = base + 20.0 * rng.normal(size=(n_bad,) + shape).astype(np.float32)
            tree[name] = leaf.astype(np.float32)
    n_k = rng.integers(50, 150, K).astype(np.float32)
    p_k = rng.uniform(0.3, 0.9, K).astype(np.float32)
    return tree, n_k, p_k


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


MASK = np.array([True, True, False, True, True, True, False, True, True, True])


@pytest.mark.parametrize("variant", ["iterative", "gram"])
@pytest.mark.parametrize("max_rounds", [0, 8])
def test_afa_tree_matches_jax(variant, max_rounds):
    tree, n_k, p_k = _proposals(7)
    jcfg = jcore.AFAConfig(variant=variant, max_rounds=max_rounds)
    tcfg = tcore.AFAConfig(variant=variant, max_rounds=max_rounds)
    jres = jcore.afa.afa_aggregate_tree(_j(tree), jnp.asarray(n_k), jnp.asarray(p_k),
                                        jnp.asarray(MASK), jcfg)
    tres = tcore.afa_aggregate_tree(_t(tree), torch.from_numpy(n_k), torch.from_numpy(p_k),
                                    torch.from_numpy(MASK), tcfg)
    np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))
    assert int(tres.rounds) == int(jres.rounds)
    assert (int(tres.rounds) == 0) == (max_rounds == 0)
    np.testing.assert_allclose(tres.similarities.numpy(), np.asarray(jres.similarities),
                               atol=SIM_TOL, rtol=0)
    assert np.abs(np.asarray(jres.similarities)).min() > 0  # round 0's, not zeros
    assert sorted(tres.aggregate) == sorted(jres.aggregate)
    for k, want in jres.aggregate.items():
        np.testing.assert_allclose(tres.aggregate[k].numpy(), np.asarray(want),
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)
    if max_rounds:
        assert not tres.good_mask[:3].any() and tres.good_mask[3:].sum() == MASK[3:].sum()


@pytest.mark.parametrize("use_kernels", [False, "cuda"])
@pytest.mark.parametrize("rule", RULES)
def test_leaf_layout_equals_packed(rule, use_kernels):
    tree, n_k, p_k = _proposals(3)
    m_sel = max(int(MASK.sum()) - 3 - 2, 1) if rule == "mkrum" else None
    opts = tcore.RuleOptions(num_selected=m_sel, use_kernels=use_kernels,
                             afa=tcore.AFAConfig(use_kernels=use_kernels))
    args = (_t(tree), torch.from_numpy(n_k), torch.from_numpy(p_k), torch.from_numpy(MASK),
            opts)
    pk = tcore.dispatch_rule_tree(rule, *args, layout="packed")
    lf = tcore.dispatch_rule_tree(rule, *args, layout="leaf")
    np.testing.assert_array_equal(pk.good_mask.numpy(), lf.good_mask.numpy())
    assert bool(pk.all_blocked) == bool(lf.all_blocked) is False
    assert sorted(pk.aggregate) == sorted(lf.aggregate) == sorted(tree)
    for k in tree:
        a, b = pk.aggregate[k].numpy(), lf.aggregate[k].numpy()
        assert a.shape == b.shape == tree[k].shape[1:]
        if tcore.RULES[rule].tree_fn is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=LEAF_RTOL, atol=LEAF_ATOL)


def test_leaf_layout_empty_participation_and_unknown_layout():
    tree, n_k, p_k = _proposals(3)
    args = (_t(tree), torch.from_numpy(n_k), torch.from_numpy(p_k))
    res = tcore.dispatch_rule_tree("afa", *args, torch.zeros(K, dtype=torch.bool),
                                   layout="leaf")
    assert bool(res.all_blocked)
    assert all(not leaf.any() for leaf in res.aggregate.values())
    with pytest.raises(ValueError, match="unknown layout"):
        tcore.dispatch_rule_tree("fa", *args, layout="tree")


# ------------------------------- server API ----------------------------------


def _step(fn, layout, tree, n_k, rule="afa"):
    cfg = ServerConfig(rule=rule, num_clients=K)
    state = init_server_state(K, device="cpu")
    proposals = (_t(tree) if layout in ("tree", "leaf")
                 else ttrees.pack_stack(_t(tree)))
    kw = dict(rule=rule, opts=make_rule_options(cfg, int(MASK.sum())), layout=layout)
    if fn is server_step_versioned:
        return fn(state, proposals, n_k, torch.from_numpy(MASK), torch.zeros(K, dtype=torch.int32),
                  **kw)
    return fn(state, proposals, n_k, torch.from_numpy(MASK), **kw)


@pytest.mark.parametrize("fn", [server_step, server_step_versioned])
@pytest.mark.parametrize("layout", ["tree", "leaf", "matrix", "packed"])
def test_server_step_layouts(fn, layout):
    tree, n_k, _ = _proposals(5)
    ref_state, ref = _step(fn, "matrix", tree, n_k)
    state, res = _step(fn, layout, tree, n_k)
    np.testing.assert_array_equal(res.good_mask.numpy(), ref.good_mask.numpy())
    for a, b in zip(state.reputation, ref_state.reputation):
        assert torch.equal(a, b)
    assert state.round == 1
    agg = (ttrees.pack_stack(ttrees.tree_map(lambda l: l[None], res.aggregate))[0]
           if layout in ("tree", "leaf") else res.aggregate)
    if layout == "leaf":  # AFA's tree form: the Gram summed leaf by leaf
        np.testing.assert_allclose(agg.numpy(), ref.aggregate.numpy(), rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL)
    else:
        assert torch.equal(agg, ref.aggregate)
    with pytest.raises(ValueError, match="unknown layout"):
        _step(fn, "rows", tree, n_k)


def test_kernel_plan_layout():
    assert KernelPlan().layout == "packed" == resolve_kernel_plan().layout
    for layout in ("packed", "tree", "leaf"):
        for use_kernels, launch in ((False, "fused"), ("cuda", "chained")):
            t = resolve_kernel_plan(use_kernels, layout, launch)
            j = jax_plan(use_kernels and "interpret", layout, launch)
            assert (t.layout, t.launch) == (j.layout, j.launch)
            assert t.mode == (use_kernels or False)
    with pytest.raises(ValueError, match="layout"):
        KernelPlan(layout="rows")
    with pytest.raises(ValueError, match="layout"):
        resolve_kernel_plan(True, "matrix")


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("blocked", [(), (0, 4, 5)])
def test_select_matches_jax(frac, blocked):
    tserver = FedServer(ServerConfig(num_clients=K), device="cpu")
    jserver = JFedServer(JServerConfig(num_clients=K))
    mask = np.zeros(K, bool)
    mask[list(blocked)] = True
    tserver.state = tserver.state._replace(reputation=tserver.reputation._replace(
        blocked=torch.from_numpy(mask)))
    jserver.state = jserver.state._replace(reputation=jserver.reputation._replace(
        blocked=jnp.asarray(mask)))
    trng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        got, want = tserver.select(trng, frac), jserver.select(jrng, frac)
        np.testing.assert_array_equal(got, want)
        assert not mask[got].any()
    np.testing.assert_array_equal(tserver.select(), np.nonzero(~mask)[0])
    assert trng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("rule", ["afa", "mkrum"])
def test_aggregate_equals_aggregate_tree(rule):
    tree, n_k, _ = _proposals(11)
    selected = np.array([0, 1, 2, 4, 5, 7, 8, 9])
    by_tree = FedServer(ServerConfig(rule=rule, num_clients=K), device="cpu")
    by_matrix = FedServer(ServerConfig(rule=rule, num_clients=K), device="cpu")
    for _ in range(2):
        agg_t, info_t = by_tree.aggregate_tree(_t(tree), n_k, selected)
        agg_m, info_m = by_matrix.aggregate(ttrees.pack_stack(_t(tree)), n_k, selected)
        assert torch.equal(ttrees.pack_stack(ttrees.tree_map(lambda l: l[None], agg_t))[0],
                           agg_m)
        assert sorted(info_t) == sorted(info_m)
        for key in info_t:
            np.testing.assert_array_equal(info_t[key], info_m[key])
    for a, b in zip(by_tree.reputation, by_matrix.reputation):
        assert torch.equal(a, b)


def test_tree_helpers_match_jax():
    tree, _, _ = _proposals(2)
    other, _, _ = _proposals(4)
    t, o, j, jo = _t(tree), _t(other), _j(tree), _j(other)

    def same(got, want):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                same(got[k], want[k])
            return
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)

    assert [tuple(p) for p in ttrees.tree_structure(t)] == [(k,) for k in
                                                           ("b0", "b1", "b2", "w0", "w1", "w2")]
    same(ttrees.tree_dot(t, o), jtrees.tree_dot(j, jo))
    same(ttrees.tree_dot(t, o, axes=1), jtrees.tree_dot(j, jo, axes=1))
    same(ttrees.tree_norm(t), jtrees.tree_norm(j))
    same(ttrees.tree_norm(t, axes=1), jtrees.tree_norm(j, axes=1))
    same(ttrees.tree_add(t, o), jtrees.tree_add(j, jo))
    same(ttrees.tree_sub(t, o), jtrees.tree_sub(j, jo))
    same(ttrees.tree_scale(0.3, t), jtrees.tree_scale(0.3, j))
    same(ttrees.tree_axpy(-1.5, t, o), jtrees.tree_axpy(-1.5, j, jo))
    same(ttrees.tree_zeros_like(t), jtrees.tree_zeros_like(j))
    mat = ttrees.flatten_to_matrix(t, K)
    same(mat, jtrees.flatten_to_matrix(j, K))
    template = ttrees.tree_map(lambda l: l[0], t)
    same(ttrees.unflatten_from_vector(mat[3], template),
         jtrees.unflatten_from_vector(jnp.asarray(mat[3].numpy()),
                                      {k: v[0] for k, v in j.items()}))
