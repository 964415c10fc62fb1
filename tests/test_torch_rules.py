"""Every aggregation rule of the port against the JAX package, on the same
numpy inputs.

* each registered rule through ``dispatch_rule`` (with masks, an empty one
  included) and ``dispatch_rule_tree``, on the plain route and on the kernel
  route (the Pallas kernels in interpret mode there, the CPU twins here):
  ``good_mask`` and ``all_blocked`` exactly, aggregates to rtol 1e-5 of
  their own scale; ``geomed`` and ``centered_clip`` to ``ITER_RTOL``;
* ``zeno_aggregate``, which stays out of both registries;
* ``server_step`` over several rounds for ``mkrum``, whose ``num_selected``
  follows the round's participants;
* ``run`` end to end for every registered rule in the clean and flipping
  scenarios, with the JAX initial parameters carried over: per-round test
  error within ``ERR_TOL_PP`` and equal ``good_mask`` histories.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.data import make_mnist_like as jax_make_mnist_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed import init_server_state as jax_init_state  # noqa: E402
from repro.fed import make_rule_options as jax_rule_options  # noqa: E402
from repro.fed import run as jax_run  # noqa: E402
from repro.fed import server_step as jax_server_step  # noqa: E402
from repro.fed.workload import DnnWorkload as JDnnWorkload  # noqa: E402
from repro.kernels.policy import resolve_kernel_plan as jax_plan  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    DnnWorkload,
    ServerConfig,
    SimConfig,
    init_server_state,
    make_rule_options,
    run,
    server_step,
)
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

RTOL = 1e-5
# geomed and centered_clip iterate 8 and 5 f32 steps, each reweighting by
# distances computed from the previous step's result, so the two packages'
# rounding differences carry through every step (measured <= 2e-7 here)
ITER_RTOL = 1e-4
ERR_TOL_PP = 0.5      # percentage points: one test sample of 200
RULES = sorted(jcore.RULES)
ROUTES = [(False, False), (True, "interpret")]  # (port use_kernels, JAX use_kernels)
# (K, dead rows): every row live, two dead, one dead at a smaller K, none live
MASKS = [(10, ()), (10, (2, 5)), (7, (0,)), (4, (0, 1, 2, 3))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_registers_every_rule_of_the_jax_package():
    assert sorted(tcore.RULES) == RULES
    assert "zeno" not in tcore.RULES
    assert [n for n in RULES if tcore.RULES[n].updates_reputation] == ["afa"]


def _proposals(K, D, n_bad, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=D).astype(np.float32)
    u = base + 0.3 * rng.normal(size=(K, D)).astype(np.float32)
    u[:n_bad] = base + 20.0 * rng.normal(size=(n_bad, D)).astype(np.float32)
    return u.astype(np.float32)


def _inputs(K, dead, seed):
    u = _proposals(K, 233, min(3, K // 3), seed)
    rng = np.random.default_rng(seed + 1)
    n_k = rng.integers(50, 150, K).astype(np.float32)
    p_k = rng.uniform(0.3, 0.9, K).astype(np.float32)
    mask = np.ones(K, bool)
    mask[list(dead)] = False
    return u, n_k, p_k, mask


def _opts(rule, mask, tk, jk):
    """The same knobs for both packages; MKRUM's num_selected from the live
    count, as the servers set it."""
    m_sel = max(int(mask.sum()) - 3 - 2, 1) if rule == "mkrum" else None
    jo = jcore.RuleOptions(num_selected=m_sel, use_kernels=jk,
                           afa=jcore.AFAConfig(use_kernels=jk))
    to = tcore.RuleOptions(num_selected=m_sel, use_kernels=tk,
                           afa=tcore.AFAConfig(use_kernels=tk))
    return jo, to


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol, atol=rtol * scale)


def _rtol(rule):
    return ITER_RTOL if rule in ("geomed", "centered_clip") else RTOL


def _same_result(rule, tres, jres):
    np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))
    assert bool(tres.all_blocked) == bool(jres.all_blocked)
    if isinstance(jres.aggregate, dict):
        assert sorted(tres.aggregate) == sorted(jres.aggregate)
        for k in jres.aggregate:
            _close(tres.aggregate[k], jres.aggregate[k], _rtol(rule))
    else:
        _close(tres.aggregate, jres.aggregate, _rtol(rule))


@pytest.mark.parametrize("tk,jk", ROUTES)
@pytest.mark.parametrize("K,dead", MASKS)
@pytest.mark.parametrize("rule", RULES)
def test_dispatch_rule_matches_jax(rule, K, dead, tk, jk):
    u, n_k, p_k, mask = _inputs(K, dead, K + len(dead))
    jo, to = _opts(rule, mask, tk, jk)
    jres = jcore.dispatch_rule(rule, jnp.asarray(u), jnp.asarray(n_k), jnp.asarray(p_k),
                               jnp.asarray(mask), jo)
    tres = tcore.dispatch_rule(rule, torch.from_numpy(u), torch.from_numpy(n_k),
                               torch.from_numpy(p_k), torch.from_numpy(mask), to)
    _same_result(rule, tres, jres)
    if not mask.any():
        assert bool(tres.all_blocked) and not tres.aggregate.any()


def _tree(u):
    """A (K, D) matrix as a two-leaf stacked tree (w0 (K, 5, 3), b0 (K, D-15))."""
    K = u.shape[0]
    return {"w0": u[:, -15:].reshape(K, 5, 3), "b0": u[:, :-15]}


@pytest.mark.parametrize("tk,jk", ROUTES)
@pytest.mark.parametrize("rule", RULES)
def test_dispatch_rule_tree_matches_jax(rule, tk, jk):
    u, n_k, p_k, mask = _inputs(10, (4,), 21)
    jo, to = _opts(rule, mask, tk, jk)
    jt = {k: jnp.asarray(v) for k, v in _tree(u).items()}
    tt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _tree(u).items()}
    jres = jcore.dispatch_rule_tree(rule, jt, jnp.asarray(n_k), jnp.asarray(p_k),
                                    jnp.asarray(mask), jo)
    tres = tcore.dispatch_rule_tree(rule, tt, torch.from_numpy(n_k), torch.from_numpy(p_k),
                                    torch.from_numpy(mask), to)
    _same_result(rule, tres, jres)


def test_unmasked_rules_match_jax():
    """Without a participation mask: the unmasked median kernel for comed, the
    static full-participation num_selected for mkrum."""
    u, n_k, _, _ = _inputs(9, (), 5)
    for tk, jk in ROUTES:
        for rule in ("comed", "mkrum", "bulyan", "trimmed_mean"):
            jo, to = _opts("", np.ones(9, bool), tk, jk)
            jres = jcore.dispatch_rule(rule, jnp.asarray(u), jnp.asarray(n_k), opts=jo)
            tres = tcore.dispatch_rule(rule, torch.from_numpy(u), torch.from_numpy(n_k),
                                       opts=to)
            _same_result(rule, tres, jres)


def test_zeno_matches_jax():
    K, D = 8, 40
    u, _, _, mask = _inputs(K, (6,), 3)
    u = u[:, :D].copy()
    w_prev = np.random.default_rng(9).normal(size=D).astype(np.float32)
    target = np.linspace(-1, 1, D).astype(np.float32)

    jres = jcore.zeno_aggregate(
        jnp.asarray(u), mask=jnp.asarray(mask), loss_fn=lambda w: jnp.sum((w - target) ** 2),
        w_prev=jnp.asarray(w_prev), num_keep=4)
    tt = torch.from_numpy(target)
    tres = tcore.zeno_aggregate(
        torch.from_numpy(u), mask=torch.from_numpy(mask),
        loss_fn=lambda w: ((w - tt) ** 2).sum(), w_prev=torch.from_numpy(w_prev), num_keep=4)
    np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))
    assert int(tres.good_mask.sum()) == 4
    _close(tres.aggregate, jres.aggregate)


@pytest.mark.parametrize("tk,jk", ROUTES)
def test_mkrum_server_step_matches_jax_over_rounds(tk, jk):
    """num_selected follows each round's participants; MKRUM keeps no
    reputation, so nobody is blocked."""
    K, D, T = 10, 150, 5
    n_k = np.full(K, 100.0, np.float32)
    jcfg = JServerConfig(rule="mkrum", num_clients=K, kernel_plan=jax_plan(jk))
    tcfg = ServerConfig(rule="mkrum", num_clients=K, kernel_plan=resolve_kernel_plan(tk))
    jstate = jax_init_state(K)
    tstate = init_server_state(K, device="cpu")
    rng = np.random.default_rng(4)
    for t in range(T):
        u = _proposals(K, D, 3, 70 + t)
        mask = rng.random(K) < 0.8
        jo = jax_rule_options(jcfg, int(mask.sum()))
        to = make_rule_options(tcfg, int(mask.sum()))
        assert to.num_selected == jo.num_selected == max(int(mask.sum()) - 5, 1)
        assert (to.num_byzantine, to.trim) == (jo.num_byzantine, jo.trim)
        jstate, jres = jax_server_step(jstate, jnp.asarray(u), jnp.asarray(n_k),
                                       jnp.asarray(mask), rule="mkrum", opts=jo,
                                       layout="matrix")
        tstate, tres = server_step(tstate, torch.from_numpy(u), torch.from_numpy(n_k),
                                   torch.from_numpy(mask), rule="mkrum", opts=to,
                                   layout="matrix")
        _same_result("mkrum", tres, jres)
        assert not (tres.good_mask.numpy() & ~mask).any()
        assert tstate.round == int(jstate.round) == t + 1
    assert not tstate.reputation.blocked.any()
    assert make_rule_options(ServerConfig(rule="comed"), 7).num_selected is None


SIM_KW = dict(num_clients=6, bad_frac=1 / 3, rounds=4, local_epochs=1,
              batch_size=50, hidden=(32, 16), dropout=False)
DATA_KW = dict(n_train=600, n_test=200, dim=64)
# f = 1 keeps Bulyan well posed at 6 clients: theta = K - 2f = 4 selected and
# beta = theta - 2f = 2 values per coordinate, the two middle ones.  With
# f = 2, beta = 1 of theta = 2 picks per coordinate one of two values
# equidistant from their mean up to rounding, so f32 differences between the
# packages, not the rule, would decide it.
SERVER_KW = dict(num_clients=6, num_byzantine=1, trim=2)


@pytest.mark.parametrize("scenario", ["clean", "flipping"])
@pytest.mark.parametrize("rule", RULES)
def test_run_matches_jax(monkeypatch, rule, scenario):
    seed = 3
    jres = jax_run(None, JSimConfig(scenario=scenario, seed=seed, **SIM_KW),
                   JServerConfig(rule=rule, **SERVER_KW),
                   data=jax_make_mnist_like(seed=seed, **DATA_KW))

    sizes = (DATA_KW["dim"], *SIM_KW["hidden"], 10)
    p0 = JDnnWorkload(sizes).init_params(jax.random.PRNGKey(seed))
    p0_np = {k: np.asarray(v) for k, v in p0.items()}
    monkeypatch.setattr(DnnWorkload, "init_params",
                        lambda self, gen, device: params_from_numpy(p0_np, device=device))
    tres = run(None, SimConfig(scenario=scenario, seed=seed, **SIM_KW),
               ServerConfig(rule=rule, kernel_plan=resolve_kernel_plan(True), **SERVER_KW),
               data=make_mnist_like(seed=seed, **DATA_KW), device="cpu")

    np.testing.assert_allclose(tres.test_error, jres.test_error, atol=ERR_TOL_PP, rtol=0)
    assert len(tres.good_mask_history) == len(jres.good_mask_history) == SIM_KW["rounds"]
    for tg, jg in zip(tres.good_mask_history, jres.good_mask_history):
        np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_array_equal(tres.blocked_round, jres.blocked_round)
