"""``afa_aggregate``, the rule dispatch and ``server_step`` of the port
against the JAX package, on the same numpy inputs.

Every (variant, launch, use_kernels) combination of AFA runs against its
JAX counterpart (kernel routes in interpret mode there, through the CPU twins
here): aggregates and similarities to rtol 1e-5, ``good_mask`` and
``rounds`` exactly.  ``server_step`` is fed the same proposals for T rounds
and must agree on ``good_mask``, ``blocked`` and ``rounds_blocked``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import AFAConfig as JAFAConfig  # noqa: E402
from repro.core import afa_aggregate as jax_afa  # noqa: E402
from repro.core import dispatch_rule_tree as jax_dispatch_tree  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import init_server_state as jax_init_state  # noqa: E402
from repro.fed import make_rule_options as jax_rule_options  # noqa: E402
from repro.fed import server_step as jax_server_step  # noqa: E402
from repro.kernels.policy import resolve_kernel_plan as jax_plan  # noqa: E402
from repro_torch.convert import server_state_from_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AFAConfig,
    RuleOptions,
    afa_aggregate,
    dispatch_rule,
    dispatch_rule_tree,
)
from repro_torch.fed import (  # noqa: E402
    ServerConfig,
    init_server_state,
    make_rule_options,
    server_step,
)
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

RTOL = 1e-5

# (variant, launch, port use_kernels, JAX use_kernels)
ROUTES = [
    ("iterative", "fused", False, False),
    ("iterative", "fused", True, "interpret"),
    ("gram", "chained", False, False),
    ("gram", "chained", True, "interpret"),
    ("gram", "fused", False, False),
    ("gram", "fused", True, "interpret"),
]


def _proposals(K, D, n_bad, seed, spread=0.3, scale=20.0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=D).astype(np.float32)
    u = base + spread * rng.normal(size=(K, D)).astype(np.float32)
    u[:n_bad] = base + scale * rng.normal(size=(n_bad, D)).astype(np.float32)
    return u.astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("variant,launch,tk,jk", ROUTES)
@pytest.mark.parametrize("max_rounds,n_bad,seed", [(8, 3, 0), (0, 3, 1), (8, 0, 2)])
def test_afa_aggregate_matches_jax(variant, launch, tk, jk, max_rounds, n_bad, seed):
    K, D = 11, 233
    u = _proposals(K, D, n_bad, seed)
    rng = np.random.default_rng(seed + 100)
    n_k = rng.integers(50, 150, K).astype(np.float32)
    p_k = rng.uniform(0.3, 0.9, K).astype(np.float32)
    mask0 = rng.random(K) < 0.9
    jcfg = JAFAConfig(variant=variant, kernel_launch=launch, use_kernels=jk,
                      max_rounds=max_rounds)
    tcfg = AFAConfig(variant=variant, kernel_launch=launch, use_kernels=tk,
                     max_rounds=max_rounds)
    jres = jax_afa(jnp.asarray(u), jnp.asarray(n_k), jnp.asarray(p_k),
                   jnp.asarray(mask0), config=jcfg)
    tres = afa_aggregate(torch.from_numpy(u), torch.from_numpy(n_k), torch.from_numpy(p_k),
                         torch.from_numpy(mask0), config=tcfg)
    np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))
    assert int(tres.rounds) == int(jres.rounds)
    _close(tres.aggregate, jres.aggregate)
    _close(tres.similarities, jres.similarities)


def test_afa_config_is_validated():
    u = torch.ones((3, 4))
    n = torch.ones(3)
    with pytest.raises(ValueError, match="kernel_launch"):
        afa_aggregate(u, n, n, config=AFAConfig(kernel_launch="bogus"))
    with pytest.raises(ValueError, match="variant"):
        afa_aggregate(u, n, n, config=AFAConfig(variant="bogus"))


def test_floor_of_two_survivors():
    """Three clients, one far off: screening may never drop below two."""
    u = np.stack([np.ones(16), np.ones(16) * 1.01, -np.ones(16)]).astype(np.float32)
    for variant in ("iterative", "gram"):
        res = afa_aggregate(torch.from_numpy(u), torch.ones(3), torch.full((3,), 0.5),
                            config=AFAConfig(variant=variant))
        assert int(res.good_mask.sum()) >= 2


def _tree(u):
    """Split a (K, D) matrix into a two-leaf stacked tree (w0 (K, 5, 3), b0
    (K, D-15)); sorted leaf order puts b0 first."""
    K = u.shape[0]
    return {"w0": u[:, -15:].reshape(K, 5, 3), "b0": u[:, :-15]}


@pytest.mark.parametrize("rule", ["afa", "fa"])
def test_packed_tree_dispatch_matches_jax(rule):
    K, D = 7, 85
    u = _proposals(K, D, 2, 7)
    n_k = np.arange(1, K + 1, dtype=np.float32)
    p_k = np.full(K, 0.5, np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    jt = {k: jnp.asarray(v) for k, v in _tree(u).items()}
    tt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _tree(u).items()}
    from repro.core import RuleOptions as JRuleOptions

    jres = jax_dispatch_tree(rule, jt, jnp.asarray(n_k), jnp.asarray(p_k), jnp.asarray(mask),
                             JRuleOptions())
    tres = dispatch_rule_tree(rule, tt, torch.from_numpy(n_k), torch.from_numpy(p_k),
                              torch.from_numpy(mask), RuleOptions())
    for k in ("w0", "b0"):
        _close(tres.aggregate[k], jres.aggregate[k])
    np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))


def test_all_blocked_round_is_a_zero_update():
    u = torch.ones((3, 5))
    res = dispatch_rule("afa", u, torch.ones(3), torch.full((3,), 0.5),
                        torch.zeros(3, dtype=torch.bool), RuleOptions())
    assert bool(res.all_blocked)
    assert torch.equal(res.aggregate, torch.zeros(5))
    with pytest.raises(ValueError, match="unknown rule"):
        dispatch_rule("no_such_rule", u, torch.ones(3))


@pytest.mark.parametrize("variant,launch,tk,jk", [ROUTES[1], ROUTES[3], ROUTES[5]])
def test_server_step_matches_jax_over_rounds(variant, launch, tk, jk):
    K, D, T = 10, 150, 8
    n_k = np.full(K, 100.0, np.float32)
    jcfg = JServerConfig(num_clients=K, afa_variant=variant,
                         kernel_plan=jax_plan(jk, kernel_launch=launch))
    tcfg = ServerConfig(num_clients=K, afa_variant=variant,
                        kernel_plan=resolve_kernel_plan(tk, kernel_launch=launch))
    jstate = jax_init_state(K)
    tstate = init_server_state(K, device="cpu")
    for t in range(T):
        u = _proposals(K, D, 3, 50 + t, scale=100.0)
        jmask = ~np.asarray(jstate.reputation.blocked)
        tmask = ~tstate.reputation.blocked.numpy()
        np.testing.assert_array_equal(tmask, jmask)
        jstate, jres = jax_server_step(
            jstate, jnp.asarray(u), jnp.asarray(n_k), jnp.asarray(jmask), rule="afa",
            opts=jax_rule_options(jcfg, int(jmask.sum())), layout="matrix")
        tstate, tres = server_step(
            tstate, torch.from_numpy(u), torch.from_numpy(n_k), torch.from_numpy(tmask),
            rule="afa", opts=make_rule_options(tcfg, int(tmask.sum())), layout="matrix")
        np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))
        np.testing.assert_array_equal(tstate.reputation.blocked.numpy(),
                                      np.asarray(jstate.reputation.blocked))
        np.testing.assert_array_equal(tstate.rounds_blocked.numpy(),
                                      np.asarray(jstate.rounds_blocked))
        _close(tstate.reputation.alpha, jstate.reputation.alpha)
    assert (tstate.rounds_blocked.numpy()[:3] >= 6).all()
    assert (tstate.rounds_blocked.numpy()[3:] == -1).all()


def test_server_state_carries_over_from_numpy():
    jstate = jax_init_state(4)
    state = server_state_from_numpy(jstate._replace(
        rounds_blocked=np.asarray([2, -1, -1, -1], np.int32), round=np.int32(3)),
        device="cpu")
    assert state.round == 3
    assert state.rounds_blocked.dtype == torch.int32
    assert state.reputation.blocked.dtype == torch.bool
    np.testing.assert_array_equal(state.reputation.alpha.numpy(), [3.0] * 4)
