"""Serving under a model axis on the port's data x model grid, against the
JAX package, on the CPU (4 gloo ranks of a (data 2, model 2) grid, spawned
once for the module):

* four reduced configs: a dense one with GQA 4 / 2 (whole kv heads a rank),
  a dense one with 3 kv heads (every head gathered, the cache split by
  slot), a MoE with 4 kv heads and 4 experts (heads and experts split), and
  the GQA one in ``fed_mode="scan"`` (FSDP leaves gathered at their use);
* each through a linear prefill (18 slots, and for the 3-kv config 17,
  which ``cache_pspec`` leaves whole over ``model``), and a ring prefill
  whose window (8) is shorter than the prompt (12), then 5 greedy decode
  steps past the window; held to the reference's single-device jitted
  ``prefill`` and ``decode_step`` on the same weights (numpy, converted)
  and prompts: each rank's rows' logits within 1e-5 (the serving tests'
  ``TOL``), the greedy tokens equal, each rank's cache block equal to the
  reference cache's ``cache_pspec`` block within 1e-5 after the prefill and
  after the last step, ``launch.serve.generate`` on the grid (eager under
  gloo) giving the same tokens, and the all-reduces a decode step as
  counted;
* ``build_step`` on a grid model: ``input_specs(model, "decode_32k", grid)``
  on a reduced smollm (whole heads, and one kv head, whose slots split and
  whose window leaves rank (*, 0)'s slots all masked) gives each rank the
  rows of the one-card bundle's seeded cache, and its decode step the
  one-card step's logits on those rows; the prefill and forward steps too;
* a (data 1, model 1) grid serves as one card, bit for bit;
* a rank's blocks at ``decode_32k`` on ``meta`` for smollm-135m (slots
  split) and llama3-8b (heads split) are ``rank_bytes(arg_specs)``;
* the SSM, hybrid, VLM and audio families still raise on a grid.

The reference's steps and the one-rank group run in a pool of their own
processes beside the 4 ranks.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.shards import spawn  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402

BASE = dict(family="dense", num_layers=2, vocab_size=64, block_q=8, block_k=8,
            sliding_window=8, fed_clients=4)
CONFIGS = {
    "gqa": dict(BASE, name="serve-gqa", d_model=32, num_heads=4, num_kv_heads=2, d_ff=64),
    "kv3": dict(BASE, name="serve-kv3", d_model=48, num_heads=6, num_kv_heads=3, d_ff=64),
    "moe": dict(BASE, name="serve-moe", family="moe", d_model=32, num_heads=4, num_kv_heads=4,
                d_ff=32, num_experts=4, top_k=2),
    "scan": dict(BASE, name="serve-scan", d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                 fed_mode="scan"),
}
B, P, STEPS = 4, 12, 5
LAYOUTS = {"linear": (18, False), "ring": (8, True), "odd": (17, False)}  # slots, ring
CASES = [(name, lay) for name in CONFIGS for lay in LAYOUTS if lay != "odd" or name == "kv3"]
IDS = ["-".join(c) for c in CASES]
TOL = 1e-5
F32 = dict(param_dtype="float32", compute_dtype="float32")
STEP_KVS = (2, 1)   # reduced smollm's kv heads in the build_step check
OTHER_FAMILIES = ("mamba2-1.3b", "zamba2-1.2b", "paligemma-3b", "hubert-xlarge")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _unpaths(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


@functools.lru_cache(maxsize=None)
def _params(name):
    """Seeded numpy weights in the config's tree: normal / sqrt(fan-in),
    the embedding and head at 0.02, the norms 0."""
    rng = np.random.default_rng(1)
    flat = {}
    for path, t in _paths(build_model(ModelConfig(**CONFIGS[name])).init(None, "meta")).items():
        shape = tuple(t.shape)
        if "norm" in path:
            flat[path] = np.zeros(shape, np.float32)
            continue
        scale = 0.02 if path in ("embed", "head") else shape[-2] ** -0.5
        flat[path] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return _unpaths(flat)


def _prompts():
    return np.random.default_rng(2).integers(0, 64, (B, P)).astype(np.int64)


def _np(t):
    return t.detach().cpu().numpy().copy()   # a decode step writes the cache in place


def _cache_np(cache):
    return {"k": _np(cache["layers"][0]), "v": _np(cache["layers"][1]), "pos": _np(cache["pos"])}


def _serve_case(grid, name, lay, params_np, prompts):
    """One case on this rank: prefill, then greedy decode steps fed the
    rank's own argmax (the linear layout feeds the whole batch's tokens,
    gathered over data, the others this rank's rows), and ``generate``."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.serve import generate

    size, ring = LAYOUTS[lay]
    model = build_model(ModelConfig(**CONFIGS[name]), grid=grid)
    whole = model_params_from_numpy(params_np, device="cpu")
    params = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(
        whole, grid, fsdp=model.fsdp))
    tok = torch.from_numpy(prompts)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok}, cache_size=size, use_window=ring)
        row = {"logits": [_np(logits)], "prefill_cache": _cache_np(cache), "tokens": []}
        for step in range(STEPS):
            nxt = torch.argmax(logits, -1)
            row["tokens"].append(_np(nxt))
            if lay == "linear":
                nxt = grid.gather_rows(nxt, B, "data")
            grid.clear_counts()
            logits, cache = model.decode_step(params, cache, nxt, ring=ring, cache_size=size)
            if step == 0:
                row["collectives"] = (dict(grid.all_reduces), dict(grid.all_gathers))
            row["logits"].append(_np(logits))
        row["tokens"].append(_np(torch.argmax(logits, -1)))
        row["cache"] = _cache_np(cache)
        gen = generate(model, params, tok, gen=STEPS + 1, ring=ring, cache_size=size)
        row["generate_tokens"] = _np(gen.tokens)
    return row


def _step_case(grid, kv):
    """``build_step`` on a grid model against one card on a reduced smollm
    with ``kv`` kv heads: the decode step of ``input_specs(..., "decode_32k",
    grid, global_batch=4)``, and prefill and forward steps on 4 prompts."""
    from repro_torch.launch.steps import build_step

    cfg = get_config("smollm-135m").reduced().with_(num_kv_heads=kv, **F32)
    out = {}
    with torch.no_grad():
        for model in (build_model(cfg), build_model(cfg, grid=grid)):
            on_grid = model.grid is not None
            bundle = tspecs.input_specs(model, "decode_32k", grid if on_grid else 1,
                                        device="cpu", global_batch=4)
            seeded = _np(bundle.args[1]["layers"][0])
            logits, cache = build_step(model, bundle)(*bundle.args)
            tok = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (4, 24)))
            pre = tspecs.SpecBundle("prefill", (bundle.args[0], {"tokens": tok}),
                                    {"cache_size": 32})
            fwd = tspecs.SpecBundle("forward", (bundle.args[0], {"tokens": tok}), {})
            out["grid" if on_grid else "one"] = {
                "decode": _np(logits), "cache_k": seeded,
                "tokens": _np(bundle.args[2]), "k_written": _np(cache["layers"][0]),
                "prefill": _np(build_step(model, pre)(*pre.args)[0]),
                "forward": _np(build_step(model, fwd)(*fwd.args))}
    return out


def _grid_worker(params_np, prompts):
    """On each of 4 gloo ranks of a (data 2, model 2) grid: every case and
    the build_step checks.  Returns every rank's results (rank 0's
    list)."""
    import torch.distributed as dist

    torch.set_num_threads(1)   # the ranks and the reference's processes share the cores
    grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=2, model=2), "cpu")
    mine = {"coords": dict(grid.coords), "cases": {}, "steps": {}}
    for name, lay in CASES:
        mine["cases"][(name, lay)] = _serve_case(grid, name, lay, params_np[name], prompts)
    for kv in STEP_KVS:
        mine["steps"][kv] = _step_case(grid, kv)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    dist.barrier()
    return ranks


def _one_rank_job(params_np, prompts, store):
    """A (data 1, model 1) grid's prefill and decode steps and the one-card
    model's on the same inputs, on a gloo group of one rank."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=1, model=1), "cpu")
        cfg = ModelConfig(**CONFIGS["kv3"])
        params = model_params_from_numpy(params_np, device="cpu")
        runs = []
        for model in (build_model(cfg, grid=grid), build_model(cfg)):
            with torch.no_grad():
                logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompts)},
                                              cache_size=18)
                steps = [_np(logits)]
                for _ in range(STEPS):
                    logits, cache = model.decode_step(params, cache, torch.argmax(logits, -1),
                                                      cache_size=18)
                    steps.append(_np(logits))
            runs.append((steps, _cache_np(cache)))
        return runs, dict(grid.all_reduces)
    finally:
        dist.destroy_process_group()


def _jax_cases(cases, params_np, prompts):
    """The reference's jitted prefill and greedy decode of each case, in one
    process of one XLA thread (the gloo ranks share the cores)."""
    import os

    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    return {case: _jax_case(*case, params_np[case[0]], prompts) for case in cases}


def _jax_case(name, lay, params_np, prompts):
    import jax
    import jax.numpy as jnp

    from repro.models import ModelConfig as JCfg
    from repro.models import build_model as jbuild

    size, ring = LAYOUTS[lay]
    model = jbuild(JCfg(**CONFIGS[name]))
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prefill = jax.jit(model.prefill, static_argnames=("cache_size", "use_window"))
    decode = jax.jit(functools.partial(model.decode_step, ring=ring))

    def as_np(cache):
        return {"k": np.asarray(cache["layers"][0]), "v": np.asarray(cache["layers"][1]),
                "pos": np.asarray(cache["pos"])}

    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts, jnp.int32)}, cache_size=size,
                            use_window=ring)
    out = {"logits": [np.asarray(logits)], "prefill_cache": as_np(cache), "tokens": [],
           "margins": []}
    for step in range(STEPS + 1):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        out["margins"].append(float((top2[:, 1] - top2[:, 0]).min()))
        out["tokens"].append(np.asarray(jnp.argmax(logits, -1)))
        if step < STEPS:
            logits, cache = decode(params, cache, jnp.asarray(out["tokens"][-1], jnp.int32))
            out["logits"].append(np.asarray(logits))
    out["cache"] = as_np(cache)
    return out


@pytest.fixture(autouse=True, scope="module")
def _pool(tmp_path_factory):
    """The reference's cases and the one-rank group, in a pool of their own
    processes started with the module's first test."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    store = tmp_path_factory.mktemp("one_rank") / "store"
    params = {name: _params(name) for name in CONFIGS}
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield {"refs": [pool.submit(_jax_cases, CASES[i::2], params, _prompts())
                        for i in range(2)],
               "one": pool.submit(_one_rank_job, params["kv3"], _prompts(), str(store))}


@pytest.fixture(scope="module")
def runs(_pool):
    ranks = spawn(_grid_worker, 4, backend="gloo", device="cpu",
                  args=({name: _params(name) for name in CONFIGS}, _prompts()))
    refs = {}
    for f in _pool["refs"]:
        refs.update(f.result())
    return {"ranks": ranks, "refs": refs, "one": _pool["one"].result()}


def _placed(coords):
    return tmesh.make_test_mesh(data=2, model=2).at(coords)


def _block(want: np.ndarray, spec, mesh) -> np.ndarray:
    return tsharding.take_shard(torch.from_numpy(want), spec, mesh).numpy()


def _close(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grid_serving_equals_the_reference(runs, case):
    ref = runs["refs"][case]
    assert min(ref["margins"]) > 1e-4, "a greedy tie would decide the tokens"
    for rank in runs["ranks"]:
        got, mesh = rank["cases"][case], _placed(rank["coords"])
        rows = slice(rank["coords"]["data"] * (B // 2), (rank["coords"]["data"] + 1) * (B // 2))
        for t, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            _close(g, w[rows], f"{case} rank {rank['coords']} logits step {t}")
        for g, w in zip(got["tokens"], ref["tokens"]):
            np.testing.assert_array_equal(g, w[rows])
        np.testing.assert_array_equal(got["generate_tokens"],
                                      np.stack(ref["tokens"], axis=1)[rows])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_holds_its_cache_pspec_block(runs, case):
    """After the prefill and after the last decode step each rank's cache
    is the reference cache's block under ``cache_pspec`` (its ``pos`` a
    plain batch's): its kv heads (gqa, moe, scan) or slots (kv3) over
    model, its rows over data; a cache of 17 slots stays whole over
    model."""
    ref = runs["refs"][case]
    size = LAYOUTS[case[1]][0]
    for rank in runs["ranks"]:
        mesh = _placed(rank["coords"])
        for when in ("prefill_cache", "cache"):
            want = ref[when]
            specs = tsharding.cache_tree_pspecs(
                {"layers": (torch.empty(want["k"].shape, device="meta"),
                            torch.empty(want["v"].shape, device="meta")),
                 "pos": torch.empty(want["pos"].shape, device="meta")}, mesh)
            got = rank["cases"][case][when]
            for key, spec in (("k", specs["layers"][0]), ("v", specs["layers"][1]),
                              ("pos", specs["pos"])):
                block = _block(want[key], spec, mesh)
                assert got[key].shape == block.shape, (case, when, key)
                if key == "pos":
                    np.testing.assert_array_equal(got[key], block)
                else:
                    _close(got[key], block, f"{case} rank {rank['coords']} {when} {key}")
        split = specs["layers"][0]
        assert split[1] == "data"
        if case[0] == "kv3":
            assert split[2] == ("model" if size % 2 == 0 else None) and split[3] is None
        else:
            assert split[3] == "model" and split[2] is None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collectives_a_decode_step(runs, case):
    """A decode step's all-reduces over ``model``: the embedding's sum and
    the head's gather, and a layer's ``wo`` and MLP (MoE) sums; where the
    heads are gathered, also one packed gather of q, k and v, and on a
    slot-split cache the softmax merge's ``pmax`` and packed ``psum``.
    Under FSDP the layers', embedding's and head's data-split leaves are
    all-gathered over ``data``, a layer's in one."""
    name, lay = case
    layers = CONFIGS[name]["num_layers"]
    per_layer = 2 + (name == "kv3") + 2 * (name == "kv3" and LAYOUTS[lay][0] % 2 == 0)
    gathers = {"data": layers + 2} if name == "scan" else {}
    for rank in runs["ranks"]:
        assert rank["cases"][case]["collectives"] == ({"model": 2 + layers * per_layer}, gathers)


@pytest.mark.parametrize("kv", STEP_KVS)
def test_build_step_on_a_grid_model(runs, kv):
    """``input_specs(model, "decode_32k", grid, device="cpu")`` gives each
    rank its block of the one-card bundle's seeded cache and its rows of the
    tokens, and the grid's decode, prefill and forward steps the one-card
    steps' logits on its rows."""
    for rank in runs["ranks"]:
        got = rank["steps"][kv]
        one, grid = got["one"], got["grid"]
        mesh = _placed(rank["coords"])
        spec = tsharding.cache_pspec(one["cache_k"].shape, mesh)
        assert spec[2 if kv == 1 else 3] == "model"
        np.testing.assert_array_equal(grid["cache_k"], _block(one["cache_k"], spec, mesh))
        rows = slice(rank["coords"]["data"] * 2, rank["coords"]["data"] * 2 + 2)
        np.testing.assert_array_equal(grid["tokens"], one["tokens"][rows])
        _close(grid["k_written"], _block(one["k_written"], spec, mesh), f"kv {kv} k written")
        for key in ("decode", "prefill"):
            _close(grid[key], one[key][rows], f"kv {kv} {key} rank {rank['coords']}")
        _close(grid["forward"], one["forward"], f"kv {kv} forward")


def test_one_rank_grid_serves_as_one_card_bit_for_bit(runs):
    (grid_run, card_run), counts = runs["one"]
    for a, b in zip(grid_run[0], card_run[0]):
        np.testing.assert_array_equal(a, b)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(grid_run[1][key], card_run[1][key])
    assert counts == {}


@pytest.mark.parametrize("arch,split_dim", [("smollm-135m", 2), ("llama3-8b", 3)])
def test_rank_blocks_at_decode_32k_are_rank_bytes(arch, split_dim):
    """On ``meta``: the arguments a rank of a (data 2, model 2) grid holds
    at ``decode_32k`` (a grid model's ``input_specs``) take exactly
    ``rank_bytes`` of the whole bundle under ``arg_specs``; the cache is
    split by slot (smollm's 3 kv heads) or by head (llama's 8)."""
    cfg = get_config(arch)
    mesh = _placed({"data": 1, "model": 1})
    whole = tspecs.input_specs(build_model(cfg), "decode_32k", mesh)
    mine = tspecs.input_specs(build_model(cfg, grid=mesh), "decode_32k", mesh)
    want = tspecs.rank_bytes(whole.args, tspecs.arg_specs(cfg, whole, mesh), mesh)
    held = sum(t.numel() * t.element_size() for t in _leaves(mine.args))
    assert held == want
    k_whole, k_mine = whole.args[1]["layers"][0], mine.args[1]["layers"][0]
    assert k_mine.shape[1] == k_whole.shape[1] // 2
    assert k_mine.shape[split_dim] == k_whole.shape[split_dim] // 2
    cache = sum(t.numel() * t.element_size() for t in mine.args[1]["layers"])
    assert cache * 4 == sum(t.numel() * t.element_size() for t in whole.args[1]["layers"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_still_raise_on_a_grid(arch):
    with pytest.raises(NotImplementedError, match="Open item 1"):
        build_model(get_config(arch).reduced(), grid=_placed({"data": 0, "model": 0}))
