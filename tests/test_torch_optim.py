"""The port's optimizers and schedules against the JAX package's.

Same numpy parameters and gradients into ``repro.optim`` and
``repro_torch.optim``: ``sgd_momentum`` with weight decay and a schedule,
``adamw`` with and without them, ``linear_warmup`` and ``cosine_schedule``,
10 steps within 1e-6 relative; the port's counterparts of
``tests/test_fed.py``'s optimizer checks; a float-lr ``sgd_momentum`` step
bit for bit the two ops the DNN and LoRA clients have always run; and the
three exports this slice adds (``core.block_probability``,
``attacks.ATTACKS``, ``models.layers.mlp_param_count``) against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import attacks as jattacks  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import reputation as jrep  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import attacks as tattacks  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core import ReputationState, block_probability  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU workloads: the suite
    runs several workers at once, and torch's thread pool oversubscribed by
    them runs these ~20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-6
STEPS = 10
SHAPES = {"a": (5, 3), "b": (7,)}


def _draws(seed):
    """Parameters and STEPS gradients of each leaf, float32 numpy."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _run_jax(opt, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    out = []
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, upd)
        out.append({k: np.asarray(v) for k, v in upd.items()})
    return out


def _run_torch(opt, params, grads):
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(p)
    out = []
    for g in grads:
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, p)
        p = {k: p[k] + upd[k] for k in p}
        out.append({k: v.numpy() for k, v in upd.items()})
    assert state.step == len(grads)
    return out


OPTIMIZERS = {
    "sgd-decay-warmup": lambda m: m.sgd_momentum(m.linear_warmup(0.1, 4), 0.9,
                                                 weight_decay=0.01),
    "sgd-decay-cosine": lambda m: m.sgd_momentum(m.cosine_schedule(0.1, 3, STEPS), 0.8,
                                                 weight_decay=0.05),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw-decay-cosine": lambda m: m.adamw(m.cosine_schedule(3e-2, 2, STEPS), b1=0.8,
                                            b2=0.99, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    params, grads = _draws(seed=sorted(OPTIMIZERS).index(name))
    want = _run_jax(OPTIMIZERS[name](joptim), params, grads)
    got = _run_torch(OPTIMIZERS[name](toptim), params, grads)
    for step, (w, g) in enumerate(zip(want, got)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0,
                                       err_msg=f"{name} step {step + 1} leaf {k}")


@pytest.mark.parametrize("schedule", [
    ("linear_warmup", (0.3, 7)),
    ("cosine_schedule", (0.3, 5, 40)),
    ("cosine_schedule", (1.0, 0, 17, 0.0)),
])
def test_schedule_matches_jax(schedule):
    name, args = schedule
    jfn, tfn = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in range(45):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=f"step {step}")


def _rosenbrock_ish(p):
    return torch.sum((p["a"] - 1.0) ** 2) + 10.0 * torch.sum((p["b"] - p["a"] ** 2) ** 2)


@pytest.mark.parametrize("optname", ["sgd", "adamw"])
def test_optimizers_descend(optname):
    """``tests/test_fed.py::test_optimizers_descend`` on the port."""
    params = {"a": torch.zeros((4,)), "b": torch.ones((4,))}
    opt = toptim.sgd_momentum(1e-2) if optname == "sgd" else toptim.adamw(5e-2)
    state = opt.init(params)
    loss0 = float(_rosenbrock_ish(params))
    for _ in range(60):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(_rosenbrock_ish(leaves), list(leaves.values()))))
        upd, state = opt.update(g, state, params)
        params = {k: params[k] + upd[k] for k in params}
    assert float(_rosenbrock_ish(params)) < 0.2 * loss0


def test_cosine_schedule_shape():
    """``tests/test_fed.py::test_cosine_schedule_shape`` on the port."""
    fn = toptim.cosine_schedule(1.0, warmup_steps=10, total_steps=100)
    assert fn(0) == 0.0
    assert abs(fn(10) - 1.0) < 1e-5
    assert fn(100) < 0.2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_lr_sgd_step_is_the_clients_two_ops(dtype):
    """A float lr and no decay: ``mu = momentum * mu + g`` and ``-lr * mu``,
    bit for bit, on a state carried over several steps, as the DNN and LoRA
    client steps (and their captured graphs) have always run them."""
    rng = np.random.default_rng(3)
    lr, momentum = 0.05, 0.9
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
              for k, s in SHAPES.items()}
    opt = toptim.sgd_momentum(lr, momentum)
    state = opt.init(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    for step in range(3):
        g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
             for k, s in SHAPES.items()}
        upd, state = opt.update(g, state, params)
        mu = {k: momentum * mu[k] + g[k] for k in g}
        for k in g:
            assert torch.equal(state.mu[k], mu[k]), (step, k)
            assert torch.equal(upd[k], -lr * mu[k]), (step, k)
            assert upd[k].dtype == dtype
        assert state.step == step + 1 and state.nu is None


def test_ported_exports_match_reference():
    alpha = np.asarray([3.0, 4.0, 3.0, 9.0, 1.0], np.float32)
    beta = np.asarray([3.0, 3.0, 9.0, 4.0, 1.0], np.float32)
    want = np.asarray(jrep.block_probability(jrep.ReputationState(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.zeros(5, bool))))
    got = block_probability(ReputationState(torch.from_numpy(alpha), torch.from_numpy(beta),
                                            torch.zeros(5, dtype=torch.bool)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)

    assert sorted(tattacks.ATTACKS) == sorted(jattacks.ATTACKS)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(6, 5)).astype(np.float32)
    y = rng.integers(0, 10, size=6)
    for name in tattacks.ATTACKS:
        xw, yw = jattacks.ATTACKS[name](x, y, np.random.default_rng(5))
        xg, yg = tattacks.ATTACKS[name](x, y, np.random.default_rng(5))
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)

    for args in [(576, 1536, "swiglu"), (64, 256, "geglu"), (96, 384, "gelu"),
                 (96, 384, "squared_relu")]:
        assert tlayers.mlp_param_count(*args) == jlayers.mlp_param_count(*args)
