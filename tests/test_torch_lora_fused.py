"""Federated LoRA on the port's fused engine, on the CPU, at the tiny dense
config ``TINY`` of ``tests/test_torch_lora.py`` (params carried over from
the JAX package with ``repro_torch.convert.lora_params_from_numpy``):

* the client-batched local update (``local_sgd_frozen_clients``, a
  ``torch.func.vmap`` over the adapters and batches) against the JAX
  package's ``local_sgd_frozen`` run one client at a time on the same numpy
  adapters and batches, within 1e-5 per row, and against the port's
  one-client ``local_sgd_frozen`` within 1e-6 (a partial attention block
  included);
* ``TransformerLoraWorkload.local_update_keyed`` equals ``local_update`` bit
  for bit;
* ``simulate_llm`` (the round program, looped on the CPU) equals a loop over
  ``make_fused_sim``'s ``round_fn`` bit for bit, on the plain and the
  gram/fused kernel route (its CPU twin);
* one LoRA round body on ``device="meta"``, where any host read raises.

The JAX package's ``simulate_llm`` and the port's block the same clients in
the same rounds: ``tests/test_torch_lora.py::
test_simulate_llm_blocks_byzantine_like_jax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fed import workload as jw  # noqa: E402
from repro.fed.client import local_sgd_frozen as jax_local_sgd_frozen  # noqa: E402
from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.convert import lora_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import ReputationState  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    EngineConfig,
    FusedData,
    ServerConfig,
    ServerState,
    fused_eager_run,
    fused_server_state,
    get_workload,
    local_sgd_frozen,
    local_sgd_frozen_clients,
    make_fused_sim,
    make_llm_fused_data,
    make_rule_options,
    simulate_llm,
)
from repro_torch.fed.workload import _lora_loss_fn  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_map  # noqa: E402

TINY = dict(name="t-lora", family="dense", num_layers=2, d_model=32, vocab_size=64,
            num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16)
K, S, B = 3, 2, 2
LR, MOMENTUM = 0.2, 0.9
# the end-to-end run of tests/test_torch_lora.py, cut to 7 rounds
E2E = dict(clients=6, byzantine=2, rounds=7, local_steps=2, batch=2, samples_per_client=8,
           seq=16, n_test=8, seed=0, scenario="byzantine")


@functools.lru_cache(maxsize=1)
def _workloads():
    return (jw.get_workload("lora", model_cfg=JaxModelConfig(**TINY), rank=2),
            get_workload("lora", model_cfg=ModelConfig(**TINY), rank=2))


@functools.lru_cache(maxsize=1)
def _jax_params():
    return jax.tree_util.tree_map(np.asarray, _workloads()[0].init_params(jax.random.PRNGKey(0)))


def _client_inputs(seq: int, seed: int = 4):
    """K rows of adapters (each its own perturbation of the init, B nonzero)
    and ``(K, S, B, seq)`` token/label batches, in numpy."""
    rng = np.random.default_rng(seed)
    adapters = _jax_params()["adapters"]
    rows = [jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), adapters)
        for _ in range(K)]
    x = rng.integers(0, TINY["vocab_size"], size=(K, S, B, seq)).astype(np.int32)
    y = rng.integers(0, TINY["vocab_size"], size=(K, S, B, seq)).astype(np.int32)
    y[1, 0, 0, :3] = -1  # masked labels take part too
    return rows, x, y


def _torch_loss():
    twl = _workloads()[1]
    return _lora_loss_fn(twl.model_cfg, twl.targets, twl.scaling)


def _batched(rows, x, y, base):
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *rows)
    return local_sgd_frozen_clients(
        _torch_loss(), base, params_from_numpy(stacked, device="cpu"),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, lr=LR, momentum=MOMENTUM)


def _row(tree, k):
    """Row k's leaves in numpy, in the JAX package's (sorted) leaf order."""
    return jax.tree_util.tree_leaves(tree_map(lambda l: l[k].numpy(), tree))


def test_client_batched_update_matches_jax_one_client_at_a_time():
    jwl, _ = _workloads()
    p = _jax_params()
    rows, x, y = _client_inputs(16)
    got = _batched(rows, x, y, lora_params_from_numpy(p, device="cpu")["base"])
    loss = jw._lora_loss_fn(jwl.model_cfg, jwl.targets, jwl.scaling)
    for k in range(K):
        want = jax_local_sgd_frozen(
            loss, p["base"], rows[k], {"x": jnp.asarray(x[k]), "y": jnp.asarray(y[k])},
            jax.random.PRNGKey(k), lr=LR, momentum=MOMENTUM, dropout=False)
        want = [np.asarray(l) for l in jax.tree_util.tree_leaves(want)]
        assert float(np.abs(want[1] - rows[k]["attn"]["wk"]["b"]).max()) > 1e-3  # it trained
        for g, w in zip(_row(got, k), want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"row {k}")
    assert all(not l.requires_grad for l in tree_leaves(got))


@pytest.mark.parametrize("seq", [16, 12], ids=["whole-blocks", "partial-block"])
def test_client_batched_update_matches_the_one_client_update(seq):
    """Against the port's ``local_sgd_frozen`` client by client; at seq 12
    the blocked attention pads its last 16-row block under ``vmap``."""
    rows, x, y = _client_inputs(seq, seed=seq)
    base = lora_params_from_numpy(_jax_params(), device="cpu")["base"]
    got = _batched(rows, x, y, base)
    for k in range(K):
        one = local_sgd_frozen(
            _torch_loss(), base, params_from_numpy(rows[k], device="cpu"),
            {"x": torch.from_numpy(x[k]), "y": torch.from_numpy(y[k])}, lr=LR,
            momentum=MOMENTUM)
        for g, w in zip(_row(got, k), jax.tree_util.tree_leaves(tree_map(np.asarray, one))):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"row {k}")


def test_keyed_update_equals_the_update_bit_for_bit():
    _, twl = _workloads()
    params = lora_params_from_numpy(_jax_params(), device="cpu")
    _, x, y = _client_inputs(16)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    cfg = EngineConfig(scenario="byzantine", lr=LR, momentum=MOMENTUM, dropout=False)
    plain = twl.local_update(cfg, params, batch, [0] * K)
    keyed = twl.local_update_keyed(cfg, params, batch, torch.tensor(5),
                                   torch.arange(K, dtype=torch.int64))
    for a, b in zip(tree_leaves(plain), tree_leaves(keyed)):
        assert a.shape[0] == K and torch.equal(a, b)
    # rows differ only by their batches: every row trained on its own
    first = tree_leaves(plain)[1]
    assert not torch.equal(first[0], first[1])


@pytest.mark.parametrize("variant,kernels", [("iterative", False), ("gram", True)],
                         ids=["iterative/plain", "gram/fused"])
def test_simulate_llm_equals_a_loop_over_round_fn(variant, kernels):
    """The round program (looped on the CPU, a CUDA graph on the card)
    against ``round_fn`` called once a round, on the same data and init."""
    _, twl = _workloads()
    plan = resolve_kernel_plan(kernels, kernel_launch="fused")
    data = make_llm_fused_data(twl.model_cfg, clients=E2E["clients"],
                               samples_per_client=E2E["samples_per_client"], seq=E2E["seq"],
                               n_test=E2E["n_test"], seed=E2E["seed"], device="cpu")
    kw = dict(E2E, afa_variant=variant, kernel_plan=plan, data=data, device="cpu")
    prog = simulate_llm(twl, **kw)
    eager = simulate_llm(twl, **kw, eager=True)
    for key in ("test_error", "good_mask", "blocked", "rounds_blocked"):
        np.testing.assert_array_equal(prog[key], eager[key], err_msg=key)
    for a, b in zip(tree_leaves(prog["params"]["adapters"]),
                    tree_leaves(eager["params"]["adapters"])):
        assert torch.equal(a, b)
    # the eager reference is make_fused_sim's round_fn, looped by hand here
    scfg = ServerConfig(rule="afa", num_clients=6, num_byzantine=2, trim=2,
                        afa_variant=variant, kernel_plan=plan)
    _, round_fn = make_fused_sim(
        twl, EngineConfig(scenario="byzantine", lr=0.2, momentum=0.9, dropout=False),
        rule="afa", opts=make_rule_options(scfg, 6), delta_block=scfg.delta_block,
        num_clients=6, num_rounds=E2E["rounds"], batch_s=2, batch_b=2,
        bad_mask=np.arange(6) < 2, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(E2E["seed"])
    params, state, traj = fused_eager_run(round_fn, twl.init_params(gen, "cpu"),
                                          fused_server_state(6, 3.0, 3.0, "cpu"),
                                          E2E["seed"], data, E2E["rounds"])
    np.testing.assert_array_equal(traj.test_error.numpy(), prog["test_error"])
    np.testing.assert_array_equal(traj.good_mask.numpy(), prog["good_mask"])
    np.testing.assert_array_equal(state.rounds_blocked.numpy(), prog["rounds_blocked"])
    assert (prog["rounds_blocked"][:2] > 0).all() and (prog["rounds_blocked"][2:] == -1).all()


@pytest.mark.parametrize("variant", ["iterative", "gram"])
def test_lora_round_body_runs_on_meta(variant):
    """A meta tensor has no data, so any bool(), .item(), .tolist() or
    nonzero in the round raises: the LoRA round has no host read that would
    break a CUDA graph's capture."""
    meta = torch.device("meta")
    _, twl = _workloads()
    Kc, n, seq, n_test = 6, 8, 16, 4
    server = ServerConfig(rule="afa", num_clients=Kc, afa_variant=variant)
    _, round_fn = make_fused_sim(
        twl, EngineConfig(scenario="byzantine", lr=LR, dropout=False), rule="afa",
        opts=make_rule_options(server, Kc), delta_block=0.95, num_clients=Kc, num_rounds=8,
        batch_s=S, batch_b=B, bad_mask=np.arange(Kc) < 2, device=meta)
    params = twl.init_params(None, meta)
    state = ServerState(
        ReputationState(torch.empty(Kc, device=meta), torch.empty(Kc, device=meta),
                        torch.empty(Kc, dtype=torch.bool, device=meta)),
        torch.empty(Kc, dtype=torch.int32, device=meta),
        torch.empty((), dtype=torch.int32, device=meta))
    i32 = dict(dtype=torch.int32, device=meta)
    i64 = dict(dtype=torch.int64, device=meta)
    data = FusedData(torch.empty((Kc, n, seq), **i32), torch.empty((Kc, n, seq), **i32),
                     torch.empty(Kc, **i64), torch.empty(Kc, device=meta),
                     torch.empty((n_test, seq), **i32), torch.empty((n_test, seq), **i32))
    (p, s), out = round_fn((params, state), torch.empty((), **i64), torch.empty((), **i64), data)
    assert out.test_error.shape == () and out.good_mask.shape == (Kc,)
    assert out.blocked.shape == (Kc,) and s.round.dtype == torch.int32
    assert all(l.device.type == "meta" for l in tree_leaves(p))
    shapes = tree_map(lambda l: tuple(l.shape), params["adapters"])
    assert tree_map(lambda l: tuple(l.shape), p["adapters"]) == shapes
