"""The port's federated LoRA path against the JAX package's, on the tiny
dense config of ``tests/test_workload.py:391``.

Token data must equal JAX's exactly (numpy on both sides).  Adapters and
bases come from the JAX package through numpy; merged weights and packed
adapter rows agree exactly, one client's ``local_sgd_frozen`` within 1e-5
(f32, no dropout), and a server step on the same packed adapter proposals
gives the same ``good_mask``.  End to end, ``simulate_llm`` is run with the
asserts of ``test_lora_simulation_blocks_byzantine_on_adapter_buffer``; torch
cannot replay ``jax.random``, so the two runs are compared on their blocking
decisions, which must be equal.
"""

import functools
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import make_token_stream as jax_token_stream  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import init_server_state as jax_init_state  # noqa: E402
from repro.fed import make_rule_options as jax_rule_options  # noqa: E402
from repro.fed import server_step as jax_server_step  # noqa: E402
from repro.fed import workload as jw  # noqa: E402
from repro.fed.client import local_sgd_frozen as jax_local_sgd_frozen  # noqa: E402
from repro.kernels.policy import resolve_kernel_plan as jax_plan  # noqa: E402
from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro.utils.trees import pack_stack as jax_pack_stack  # noqa: E402
from repro.utils.trees import tree_broadcast_clients as jax_broadcast  # noqa: E402
from repro_torch.convert import lora_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    ServerConfig,
    SimConfig,
    get_workload,
    init_lora_adapters,
    init_server_state,
    local_sgd_frozen,
    make_llm_fused_data,
    make_rule_options,
    merge_lora,
    run,
    server_step,
    simulate_llm,
)
from repro_torch.fed.workload import _lora_loss_fn  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.utils.trees import pack_stack, tree_broadcast_clients, tree_leaves  # noqa: E402

TINY = dict(name="t-lora", family="dense", num_layers=2, d_model=32, vocab_size=64,
            num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16)
# the end-to-end run of tests/test_workload.py:409
E2E = dict(clients=6, byzantine=2, rounds=8, local_steps=2, batch=2, samples_per_client=8,
           seq=16, n_test=8, seed=0, scenario="byzantine")


@functools.lru_cache(maxsize=1)
def _workloads():
    return (jw.get_workload("lora", model_cfg=JaxModelConfig(**TINY), rank=2),
            get_workload("lora", model_cfg=ModelConfig(**TINY), rank=2))


@functools.lru_cache(maxsize=1)
def _jax_params():
    return jax.tree_util.tree_map(np.asarray, _workloads()[0].init_params(jax.random.PRNGKey(0)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_e2e():
    """The JAX package's end-to-end run, once for the module."""
    return jw.simulate_llm(_workloads()[0], **E2E)


def test_token_stream_is_byte_identical():
    want = jax_token_stream(seed=3, vocab=100, n=3000)
    got = make_token_stream(seed=3, vocab=100, n=3000)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    for bj, bt in zip(want.batches(rj, 3, 10, 2), got.batches(rt, 3, 10, 2)):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(bt[key], bj[key])


def test_llm_fused_data_tokens_equal_jax():
    cfg = JaxModelConfig(**TINY)
    kw = dict(clients=3, samples_per_client=4, seq=8, n_test=5, seed=1)
    want = jw.make_llm_fused_data(cfg, **kw)
    got = make_llm_fused_data(ModelConfig(**TINY), **kw, device="cpu")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert got.x.dtype == torch.int32 and got.n_k.dtype == torch.float32


def test_lora_adapters_init_merge_and_pack_like_jax():
    jwl, twl = _workloads()
    p = _jax_params()
    tp = lora_params_from_numpy(p, device="cpu")
    # init: same sites, shapes and dtypes; B = 0; A ~ N(0, 1/d_in)
    gen = torch.Generator()
    gen.manual_seed(0)
    own = init_lora_adapters(gen, tp["base"]["layers"], twl.targets, twl.rank)
    assert [tuple(l.shape) for l in tree_leaves(own)] == \
        [tuple(l.shape) for l in jax.tree_util.tree_leaves(p["adapters"])]
    assert all(float(own["attn"][t]["b"].abs().max()) == 0.0 for t in twl.targets)
    big = init_lora_adapters(gen, {"w": torch.zeros((3, 400, 8))}, ("w",), 50)["w"]["a"]
    assert abs(float(big.std()) * np.sqrt(400) - 1.0) < 0.02
    # merge: the same adapters give the same effective weights
    rng = np.random.default_rng(5)
    adapters = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), p["adapters"])
    want = _np(jw.merge_lora(p["base"]["layers"], adapters, jwl.scaling))
    got = merge_lora(tp["base"]["layers"], params_from_numpy(adapters, device="cpu"),
                     twl.scaling)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6),
        jax.tree_util.tree_map(lambda t: t.numpy(), got), want)
    # packed rows: the adapter buffer lines up column for column
    jrow = np.asarray(jax_pack_stack(jax_broadcast(adapters, 2), jwl.delta_spec(p)))
    trow = pack_stack(tree_broadcast_clients(params_from_numpy(adapters, device="cpu"), 2),
                      twl.delta_spec(tp))
    np.testing.assert_array_equal(trow.numpy(), jrow)
    assert twl.proposal_dim(tp) == jwl.proposal_dim(p) == jrow.shape[1]
    assert twl.param_dim(tp) == jwl.param_dim(p)


def test_local_sgd_frozen_matches_jax():
    """One client's two SGD steps on the adapters, the base frozen."""
    jwl, twl = _workloads()
    p = _jax_params()
    tp = lora_params_from_numpy(p, device="cpu")
    data = jw.make_llm_fused_data(jwl.model_cfg, clients=1, samples_per_client=4, seq=16,
                                  n_test=2, seed=2)
    x = np.array(data.x)[0].reshape(2, 2, 16)
    y = np.array(data.y)[0].reshape(2, 2, 16)
    y[0, 0, :3] = -1  # masked labels take part too
    loss = jw._lora_loss_fn(jwl.model_cfg, jwl.targets, jwl.scaling)
    want = _np(jax_local_sgd_frozen(
        loss, p["base"], p["adapters"], {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        jax.random.PRNGKey(0), lr=0.2, momentum=0.9, dropout=False))
    got = local_sgd_frozen(
        _lora_loss_fn(twl.model_cfg, twl.targets, twl.scaling), tp["base"], tp["adapters"],
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, lr=0.2, momentum=0.9)
    assert float(np.abs(want["attn"]["wq"]["b"]).max()) > 0  # it trained
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5),
        jax.tree_util.tree_map(lambda t: t.numpy(), got), want)
    assert all(not l.requires_grad for l in tree_leaves(got))


@pytest.mark.parametrize("variant,launch,tk,jk", [
    ("iterative", "fused", False, False),
    ("gram", "fused", True, "interpret"),
])
def test_server_step_on_packed_adapter_proposals_matches_jax(variant, launch, tk, jk):
    jwl, twl = _workloads()
    p = _jax_params()
    K, n_bad = 6, 2
    spec = jwl.delta_spec(p)
    base = np.asarray(jax_pack_stack(jax_broadcast(p["adapters"], 1), spec))[0]
    rng = np.random.default_rng(9)
    u = base + 0.05 * rng.normal(size=(K, base.size)).astype(np.float32)
    u[:n_bad] = base + 20.0 * rng.normal(size=(n_bad, base.size)).astype(np.float32)
    u = u.astype(np.float32)
    n_k = np.full(K, 8.0, np.float32)
    mask0 = np.ones(K, bool)
    jcfg = JServerConfig(rule="afa", num_clients=K, afa_variant=variant,
                         kernel_plan=jax_plan(jk, kernel_launch=launch))
    tcfg = ServerConfig(rule="afa", num_clients=K, afa_variant=variant,
                        kernel_plan=resolve_kernel_plan(tk, kernel_launch=launch))
    _, jres = jax_server_step(jax_init_state(K), jnp.asarray(u), jnp.asarray(n_k),
                              jnp.asarray(mask0), rule="afa",
                              opts=jax_rule_options(jcfg, K), layout="packed")
    _, tres = server_step(init_server_state(K, device="cpu"), torch.from_numpy(u),
                          torch.from_numpy(n_k), torch.from_numpy(mask0), rule="afa",
                          opts=make_rule_options(tcfg, K), layout="matrix")
    np.testing.assert_array_equal(tres.good_mask.numpy(), np.asarray(jres.good_mask))
    assert not tres.good_mask[:n_bad].any()
    np.testing.assert_allclose(tres.aggregate.numpy(), np.asarray(jres.aggregate),
                               rtol=1e-5, atol=1e-5 * float(np.abs(base).max()))


def test_simulate_llm_blocks_byzantine_like_jax(jax_e2e):
    """The JAX test's asserts, and the same blocking decisions as JAX."""
    res = simulate_llm(_workloads()[1], **E2E, device="cpu")
    blocked = res["blocked"][-1]
    assert blocked[:2].all(), f"byzantine clients not blocked: {blocked}"
    assert not blocked[2:].any(), f"benign client blocked: {blocked}"
    assert (res["rounds_blocked"][:2] > 0).all()
    assert (res["good_frac"] <= 4.0 / 6.0 + 1e-6).all()
    assert res["adapter_fraction"] < 0.05, res["adapter_fraction"]
    err = res["test_error"]
    assert np.isfinite(err).all() and (err >= 0).all() and (err <= 1).all()
    np.testing.assert_array_equal(res["blocked"], np.asarray(jax_e2e["blocked"]))
    np.testing.assert_array_equal(res["rounds_blocked"], np.asarray(jax_e2e["rounds_blocked"]))
    np.testing.assert_array_equal(res["bad_mask"], jax_e2e["bad_mask"])
    assert res["adapter_dim"] == jax_e2e["adapter_dim"]
    assert res["param_dim"] == jax_e2e["param_dim"]
    # the fused engine has no per-phase timers: round_times spreads the run
    # evenly, and the CPU captures no graph
    assert len(res["round_times"]) == E2E["rounds"] and res["round_times"][0] > 0
    assert res["capture_time"] == 0.0
    np.testing.assert_array_equal(res["good_frac"],
                                  res["good_mask"].astype(np.float32).mean(axis=1))


def test_run_routes_the_lora_workload_like_jax():
    """``run`` maps the SimConfig onto ``simulate_llm`` as the JAX facade
    does; the gram/fused kernel route (the CPU twins here) blocks the same
    clients in the same round."""
    sim = SimConfig(num_clients=6, bad_frac=2 / 6, scenario="byzantine", rounds=7,
                    local_epochs=2, batch_size=2, seed=0, lr=0.2)
    extra = dict(samples_per_client=8, seq=16, n_test=8)
    direct = simulate_llm(_workloads()[1], clients=6, byzantine=2, rounds=7, local_steps=2,
                          batch=2, seed=0, lr=0.2, scenario="byzantine", device="cpu", **extra)
    res = run(_workloads()[1], sim, device="cpu", **extra)
    np.testing.assert_array_equal(res["test_error"], direct["test_error"])
    np.testing.assert_array_equal(res["rounds_blocked"], direct["rounds_blocked"])
    fused = run("lora", sim, ServerConfig(afa_variant="gram",
                                         kernel_plan=resolve_kernel_plan(True)),
                workload_kwargs=dict(model_cfg=ModelConfig(**TINY), rank=2), device="cpu",
                **extra)
    np.testing.assert_array_equal(fused["rounds_blocked"], direct["rounds_blocked"])
    # as in the JAX package, the LLM route takes no seed sweep
    with pytest.raises(ValueError, match="seed sweeps are not wired for the LLM route"):
        run(_workloads()[1], sim, seeds=[0, 1], device="cpu")


def test_lora_registry_matches_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jw.get_workload("lora", arch="smollm-135m", reduced=True, rank=4)
    got = get_workload("lora", arch="smollm-135m", reduced=True, rank=4)
    assert (got.rank, got.alpha, got.targets, got.scaling) == \
        (want.rank, want.alpha, want.targets, want.scaling)
    assert got.model_cfg.num_layers == want.model_cfg.num_layers == 2
    assert got.model_cfg.param_dtype == want.model_cfg.param_dtype == "float32"
    full = get_workload("lora", arch="smollm-135m", reduced=False, rank=4)
    shapes = full.init_params(None, "meta")
    assert full.proposal_dim(shapes) == 460_800
    assert full.proposal_dim(shapes) / full.param_dim(shapes) < 0.05
    with pytest.raises(ValueError, match="unknown workload"):
        get_workload("nope")


def test_llm_path_imports_no_jax_and_no_repro():
    """The model forward on both attention routes and a LoRA run import
    neither JAX nor the JAX package."""
    code = (
        "import sys, torch\n"
        "import repro_torch.configs, repro_torch.models\n"
        "from repro_torch.fed import SimConfig, get_workload, run\n"
        "from repro_torch.models import ModelConfig, build_model\n"
        f"cfg = ModelConfig(**{TINY!r})\n"
        "params = build_model(cfg).init(torch.Generator(), 'cpu')\n"
        "tok = torch.zeros((1, 8), dtype=torch.int32)\n"
        "with torch.no_grad():\n"
        "    for pallas in (False, True):\n"
        "        build_model(cfg.with_(use_pallas_attention=pallas)).forward(\n"
        "            params, {'tokens': tok})\n"
        "run(get_workload('lora', model_cfg=cfg, rank=2), SimConfig(num_clients=3,\n"
        "    bad_frac=1 / 3, scenario='byzantine', rounds=2, local_epochs=1, batch_size=2),\n"
        "    samples_per_client=4, seq=8, n_test=2, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
