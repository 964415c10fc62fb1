"""The client axis beside the model axis: whole-model rounds and serving on
the port's (client, data, model) grid, against the JAX package, on the CPU
(8 gloo ranks of a (client 2, data 2, model 2) grid, spawned once for the
module):

* the reference test's aligned dense config (``ALIGNED``,
  ``tests/test_torch_model_shards.py``) in ``vmap``, ``scan`` storing
  float32, bfloat16 or int8 deltas, and ``remat``, and a reduced olmoe (4
  experts, top-2, split over ``model``) in ``vmap`` and ``scan``, K = 4,
  client 0 byzantine (the train CLI's attack), each held to the
  reference's single-device jitted ``make_fed_round`` of the same mode on
  the same weights (numpy, converted) and batch: the posteriors, blocked
  bits, good_frac and AFA rounds equal on every rank, the aggregate within
  2e-4 / 2e-5 (bf16: a stored proposal rounded to its neighbour; int8: one
  quantization step of the leaf's scale beyond), the similarities within
  1e-5.  K rides the client rows: a rank trains its row's 2 clients (vmap
  under ``torch.func.vmap`` over ``model`` alone, the data ranks of a row
  alike; scan and remat one at a time under FSDP over ``data``, each
  client's 4 rows split over the data ranks);
* every rank holds exactly its spec blocks (``fsdp`` off and on, the
  client axis splitting no leaf) and its client row's 2 clients' batches;
* the collectives a round on each group (``model``, ``data``,
  ``data+model``, ``client``; all-gathers and reduce-scatters over
  ``data``) equal the counts of ``_collectives`` below;
* a prefill and 5 greedy decode steps of the dense model on the grid (the
  client axis idle: the rows split over ``data``, the kv heads over
  ``model``) within 1e-5 of the reference's, the tokens equal, and
  ``generate``'s; ``build_step``'s decode step of a grid model's
  ``input_specs(..., "decode_32k", grid)`` bundle within 1e-5 of one
  card's on the rank's rows;
* a (client 1, data 1, model 1) grid runs the one-card rounds bit for bit,
  and a (client 2, model 2) grid's vmap round is the (data 2, model 2)
  grid's bit for bit on every rank (4 gloo ranks, spawned once): a rank
  holds the same blocks and sums over the same ranks, under another name;
* the refusals: a foreign ``client_axes`` under scan and vmap, K that does
  not split over the client rows under scan and remat, the gram variant
  over several rows, a batch that is not the rank's client row's;
* ``input_specs(model, "train_4k", grid)`` on a client-axis grid: K is
  ``num_client_rows`` under vmap and ``fed_clients`` otherwise, a rank's
  batch is its ``batch_pspec`` block (the one-card bundle's rows) and its
  arguments take ``rank_bytes`` of the one-card bundle under ``arg_specs``;
  the train step's round config puts vmap's clients on ``("client",)``.

The reference's rounds and steps and the one-rank group run in a pool of
their own processes beside the 8 ranks.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.shards import spawn  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402

GRID = dict(client=2, data=2, model=2)
# the reference test's tiny dense config (tests/test_distributed_equivalence.py)
ALIGNED = dict(name="eq", family="dense", num_layers=2, d_model=32, vocab_size=64,
               num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16, fed_clients=4)
MOE = dict(name="olmoe-grid", family="moe", num_layers=2, d_model=64, vocab_size=64,
           num_heads=4, num_kv_heads=4, d_ff=64, num_experts=4, top_k=2, block_q=16,
           block_k=16, fed_clients=4)
CONFIGS = {"dense": ALIGNED, "moe": MOE}
CASES = [("dense", "vmap", "float32"), ("dense", "scan", "float32"),
         ("dense", "scan", "bfloat16"), ("dense", "scan", "int8"),
         ("dense", "remat", "float32"), ("moe", "vmap", "float32"), ("moe", "scan", "float32")]
IDS = ["-".join(c) for c in CASES]
K, STEPS, ROWS, SEQ, LR = 4, 2, 4, 16, 0.05
# remat retrains every client in each of its three passes: one local step
LOCAL_STEPS = {"vmap": STEPS, "scan": STEPS, "remat": 1}
RTOL, ATOL = 2e-4, 2e-5        # the reference's sharded test's bounds
B, P, GEN, CACHE = 4, 12, 5, 18   # serving: prompts, prompt length, greedy steps, slots
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(mode="scan"):
    """(K, steps, 4 rows, 16) tokens and labels; client 0 gets the train
    CLI's attack; row 0 of every other client masks 11 of its labels, so the
    data ranks (rows 0-1, 2-3) count different labels."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 64, (K, STEPS, ROWS, SEQ)).astype(np.int32)
    lab = rng.integers(0, 64, (K, STEPS, ROWS, SEQ)).astype(np.int32)
    tok[0], lab[0] = 0, 0
    lab[1:, :, 0, 5:] = -1
    return {"tokens": tok[:, :LOCAL_STEPS[mode]], "labels": lab[:, :LOCAL_STEPS[mode]]}


def _prompts():
    return np.random.default_rng(2).integers(0, 64, (B, P)).astype(np.int64)


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


def _round_config(mode, pdt, client_axes=None, num_clients=K, variant="iterative"):
    from repro_torch.core import AFAConfig
    from repro_torch.fed.distributed import FedRoundConfig

    return FedRoundConfig(num_clients=num_clients, local_steps=LOCAL_STEPS[mode], lr=LR,
                          mode=mode, proposal_dtype=pdt, client_axes=client_axes,
                          afa=AFAConfig(variant=variant))


def _row_batch(grid, batch):
    """This rank's block of a federated batch: its client row's clients."""
    from repro_torch.models.model import tree_apply

    return tsharding.shard_tree(batch, grid, tree_apply(lambda t: tsharding.batch_pspec(
        tuple(t.shape), grid, client_axis=True, per_client_batch=True), batch))


def _np(t):
    return t.detach().cpu().numpy().copy()   # a decode step writes the cache in place


def _grid_worker(params_np, prompts):
    """On each of 8 gloo ranks of a (client 2, data 2, model 2) grid: the
    blocks drawn, every case's round, the greedy serving run, the refusals.
    Returns every rank's results."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round

    torch.set_num_threads(1)   # the ranks and the reference's processes share the cores
    grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(**GRID), "cpu")
    mine = {"coords": dict(grid.coords), "held": {}, "cases": {}}
    for name in CONFIGS:
        for mode in ("vmap", "scan"):
            cfg = ModelConfig(**CONFIGS[name]).with_(fed_mode=mode)
            drawn = build_model(cfg, grid=grid).init(torch.Generator().manual_seed(3), "cpu")
            whole = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
            specs = tsharding.shard_params_tree(whole, grid, fsdp=mode == "scan")
            mine["held"][(name, mode)] = {
                "shapes": {p: tuple(t.shape) for p, t in _paths(drawn).items()},
                "init_is_the_block": all(torch.equal(a, b) for a, b in zip(
                    _paths(drawn).values(),
                    _paths(tsharding.shard_tree(whole, grid, specs)).values()))}
    for name, mode, pdt in CASES:
        model = build_model(ModelConfig(**CONFIGS[name]).with_(fed_mode=mode), grid=grid)
        whole = model_params_from_numpy(params_np[name], device="cpu")
        specs = tsharding.shard_params_tree(whole, grid, fsdp=mode != "vmap")
        params = tsharding.shard_tree(whole, grid, specs)
        batch = {k: torch.from_numpy(v) for k, v in _batch(mode).items()}
        local = _row_batch(grid, batch)
        grid.clear_counts()
        agg, rep, m = make_fed_round(model, _round_config(mode, pdt), grid=grid)(
            params, init_reputation(K, device="cpu"), torch.ones(K), local)
        row = {"collectives": (dict(grid.all_reduces), dict(grid.all_gathers),
                               dict(grid.reduce_scatters)),
               "decisions": (rep.alpha.tolist(), rep.beta.tolist(), rep.blocked.tolist(),
                             float(m["good_frac"]), int(m["afa_rounds"])),
               "similarities": _np(m["similarities"]),
               "batch_rows": int(local["tokens"].shape[0]),
               "batch_is_the_row": all(torch.equal(local[k], v[grid.block(K, "client")])
                                       for k, v in batch.items())}
        if grid.coords["client"] == 0:   # one client row's copy of the aggregate
            row["agg"] = {p: _np(t) for p, t in
                          _paths(tsharding.unshard_tree(agg, grid, specs)).items()}
        if "scales" in m:
            row["scales"] = {p: _np(t) for p, t in m["scales"].items()}
        mine["cases"][(name, mode, pdt)] = row
    mine["serve"] = _serve(grid, params_np["dense"], prompts)
    mine["refusals"] = _refusals(grid, params_np["dense"])
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    dist.barrier()
    return ranks


def _serve(grid, params_np, prompts):
    """The dense model's prefill and ``GEN`` greedy decode steps on this
    rank's rows (the whole batch's tokens gathered over data each step),
    ``generate``'s tokens, and ``_decode_step_case``."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.serve import generate

    model = build_model(ModelConfig(**ALIGNED), grid=grid)
    whole = model_params_from_numpy(params_np, device="cpu")
    params = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(whole, grid))
    out = {"logits": [], "tokens": []}
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompts)},
                                      cache_size=CACHE)
        out["cache_k"] = tuple(cache["layers"][0].shape)
        for step in range(GEN + 1):
            out["logits"].append(_np(logits))
            nxt = torch.argmax(logits, -1)
            out["tokens"].append(_np(nxt))
            if step < GEN:
                logits, cache = model.decode_step(params, cache, grid.gather_rows(nxt, B, "data"),
                                                  cache_size=CACHE)
        out["generate_tokens"] = _np(generate(model, params, torch.from_numpy(prompts),
                                              gen=GEN + 1, ring=False, cache_size=CACHE).tokens)
    out["decode_32k"] = _decode_step_case(grid)
    return out


def _decode_step_case(grid):
    """``build_step`` on a reduced smollm built on the grid against the
    one-card model: the decode step of ``input_specs(..., "decode_32k",
    grid, global_batch=4)``, this rank's rows of its seeded tokens and its
    logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_step

    cfg = get_config("smollm-135m").reduced().with_(num_kv_heads=2, param_dtype="float32",
                                                    compute_dtype="float32")
    out = {}
    with torch.no_grad():
        for model in (build_model(cfg), build_model(cfg, grid=grid)):
            on_grid = model.grid is not None
            bundle = tspecs.input_specs(model, "decode_32k", grid if on_grid else 1,
                                        device="cpu", global_batch=4)
            logits, _ = build_step(model, bundle)(*bundle.args)
            out["grid" if on_grid else "one"] = {"logits": _np(logits),
                                                 "tokens": _np(bundle.args[2])}
    return out


def _refusals(grid, params_np):
    """name -> the exception type each call raises on the grid."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round

    vmap = build_model(ModelConfig(**ALIGNED), grid=grid)
    scan = build_model(ModelConfig(**ALIGNED).with_(fed_mode="scan"), grid=grid)
    remat = build_model(ModelConfig(**ALIGNED).with_(fed_mode="remat"), grid=grid)
    whole = model_params_from_numpy(params_np, device="cpu")
    params = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(whole, grid,
                                                                           fsdp=True))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    calls = {
        "scan_foreign_client_axes": lambda: make_fed_round(
            scan, _round_config("scan", "float32", ("data",)), grid=grid),
        "vmap_foreign_client_axes": lambda: make_fed_round(
            vmap, _round_config("vmap", "float32", ("data",)), grid=grid),
        "scan_rows_do_not_split": lambda: make_fed_round(
            scan, _round_config("scan", "float32", num_clients=3), grid=grid),
        "remat_rows_do_not_split": lambda: make_fed_round(
            remat, _round_config("remat", "float32", num_clients=3), grid=grid),
        "scan_gram_over_rows": lambda: make_fed_round(
            scan, _round_config("scan", "float32", variant="gram"), grid=grid),
        "scan_whole_batch": lambda: make_fed_round(
            scan, _round_config("scan", "float32", ("client",)), grid=grid)(
            params, init_reputation(K, device="cpu"), torch.ones(K), batch),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 -- the type is what the test reads
            out[name] = type(e).__name__
    return out


def _rows_worker(params_np):
    """On each of 4 gloo ranks: the dense vmap round on a (data 2, model 2)
    grid and on a (client 2, model 2) grid from the same blocks; True where
    the aggregates, posteriors and similarities are the same bits on every
    rank."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round

    torch.set_num_threads(1)
    whole = model_params_from_numpy(params_np, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch("vmap").items()}
    runs = []
    for shape in (dict(data=2, model=2), dict(client=2, data=0, model=2)):
        grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(**shape), "cpu")
        params = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(whole, grid))
        agg, rep, m = make_fed_round(build_model(ModelConfig(**ALIGNED), grid=grid),
                                     _round_config("vmap", "float32"), grid=grid)(
            params, init_reputation(K, device="cpu"), torch.ones(K), _row_batch(grid, batch))
        runs.append(list(_paths(agg).values()) + [rep.alpha, rep.beta, m["similarities"]])
    same = [None] * dist.get_world_size()
    dist.all_gather_object(same, all(torch.equal(a, b) for a, b in zip(*runs)))
    return all(same)


def _one_rank_job(params_np, store):
    """A (client 1, data 1, model 1) grid's vmap and int8 scan rounds and
    the one-card rounds on the same inputs, on a gloo group of one rank."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(client=1, data=1, model=1), "cpu")
        params = model_params_from_numpy(params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
        out = {}
        for mode, pdt in (("vmap", "float32"), ("scan", "int8")):
            model = build_model(ModelConfig(**ALIGNED).with_(fed_mode=mode), grid=grid)
            runs = []
            for g in (grid, None):
                agg, rep, m = make_fed_round(model, _round_config(mode, pdt), grid=g)(
                    params, init_reputation(K, device="cpu"), torch.ones(K), batch)
                runs.append(({p: _np(t) for p, t in _paths(agg).items()}, _np(rep.alpha),
                             _np(rep.beta), _np(m["similarities"])))
            out[mode] = runs
        return out, dict(grid.all_reduces)
    finally:
        dist.destroy_process_group()


def _jax_jobs(cases, params_np, serve=False):
    """The reference's round of each case (and its greedy serving run if
    asked), in one process of one XLA thread at the lowest priority (the
    gloo ranks share the cores)."""
    import os

    os.nice(19)
    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    out = {case: _jax_round(*case, params_np[case[0]]) for case in cases}
    if serve:
        out["serve"] = _jax_serve(params_np["dense"], _prompts())
    return out


def _jax_model(name):
    from repro.models import ModelConfig as JCfg
    from repro.models import build_model as jbuild

    return jbuild(JCfg(**CONFIGS[name]))


def _jax_round(name, mode, pdt, params_np):
    """The reference's single-device jitted round on the numpy weights."""
    import jax
    import jax.numpy as jnp

    from repro.core.reputation import init_reputation as jinit
    from repro.fed.distributed import FedRoundConfig as JFed
    from repro.fed.distributed import make_fed_round as jmake

    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    fr = jax.jit(jmake(_jax_model(name), JFed(num_clients=K, local_steps=LOCAL_STEPS[mode], lr=LR,
                                              mode=mode, proposal_dtype=pdt)))
    agg, rep, m = fr(params, jinit(K), jnp.ones((K,), jnp.float32),
                     {k: jnp.asarray(v) for k, v in _batch(mode).items()})
    return ({p: np.asarray(t) for p, t in _paths(agg).items()},
            (np.asarray(rep.alpha).tolist(), np.asarray(rep.beta).tolist(),
             np.asarray(rep.blocked).tolist(), float(m["good_frac"]), int(m["afa_rounds"])),
            np.asarray(m["similarities"]))


def _jax_serve(params_np, prompts):
    """The reference's jitted prefill and greedy decode steps."""
    import jax
    import jax.numpy as jnp

    model = _jax_model("dense")
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    prefill = jax.jit(model.prefill, static_argnames=("cache_size",))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts, jnp.int32)}, cache_size=CACHE)
    out = {"logits": [], "tokens": [], "margins": []}
    for step in range(GEN + 1):
        out["logits"].append(np.asarray(logits))
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        out["margins"].append(float((top2[:, 1] - top2[:, 0]).min()))
        out["tokens"].append(np.asarray(jnp.argmax(logits, -1)))
        if step < GEN:
            logits, cache = decode(params, cache, jnp.asarray(out["tokens"][-1], jnp.int32))
    return out


@pytest.fixture(autouse=True, scope="module")
def _pool(tmp_path_factory):
    """The reference's jobs and the one-rank group, in a pool of their own
    processes started with the module's first test."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    store = tmp_path_factory.mktemp("one_rank") / "store"
    params = {name: _params(name) for name in CONFIGS}
    jobs = [CASES[0:2], CASES[2:4], CASES[4:6], CASES[6:]]
    with ProcessPoolExecutor(len(jobs) + 1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        yield {"refs": [pool.submit(_jax_jobs, cases, params, n == len(jobs) - 1)
                        for n, cases in enumerate(jobs)],
               "one": pool.submit(_one_rank_job, params["dense"], str(store))}


@pytest.fixture(scope="module")
def runs(_pool):
    ranks = spawn(_grid_worker, 8, backend="gloo", device="cpu",
                  args=({name: _params(name) for name in CONFIGS}, _prompts()))
    rows = spawn(_rows_worker, 4, backend="gloo", device="cpu", args=(_params("dense"),))
    refs = {}
    for f in _pool["refs"]:
        refs.update(f.result())
    return {"ranks": ranks, "serve": refs.pop("serve"), "refs": refs,
            "one": _pool["one"].result(), "client_rows_are_data_rows": rows}


def _placed(coords):
    return tmesh.make_test_mesh(**GRID).at(coords)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_client_grid_round_equals_the_reference(runs, case):
    agg, decisions, sims = runs["refs"][case]
    assert decisions[3] == 0.75 and decisions[1][0] == 4.0   # client 0 screened out
    for rank in runs["ranks"]:
        got = rank["cases"][case]
        assert got["decisions"] == decisions, (case, rank["coords"], got["decisions"])
        np.testing.assert_allclose(got["similarities"], sims, rtol=1e-5, atol=1e-5)
        if "agg" not in got:
            continue
        for path, want in agg.items():
            rtol, atol = RTOL, ATOL
            if case[2] == "int8":   # one quantization step of the leaf's scale
                atol += float(got["scales"][path].max())
            elif case[2] == "bfloat16":   # a stored proposal rounded to its neighbour
                rtol = 2.0 ** -7
            np.testing.assert_allclose(got["agg"][path], want, rtol=rtol, atol=atol,
                                       err_msg=f"{case} {rank['coords']} {path}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_trains_its_client_row(runs, case):
    """A rank's batch is its client row's K / 2 clients, its block under
    ``batch_pspec``; the int8 scales come back for all K clients, the same
    on every rank."""
    for rank in runs["ranks"]:
        got = rank["cases"][case]
        assert got["batch_rows"] == K // GRID["client"] and got["batch_is_the_row"]
        if "scales" in got:
            first = runs["ranks"][0]["cases"][case]["scales"]
            for path, s in got["scales"].items():
                assert s.shape == (K,)
                np.testing.assert_array_equal(s, first[path])


@pytest.mark.parametrize("mode", ["vmap", "scan"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_its_spec_blocks(runs, name, mode):
    """The blocks drawn on each rank are its ``shard_params_tree`` blocks
    of the one-card draw (FSDP under scan); no leaf is split over the client
    axis, and the two client rows hold the same blocks."""
    full = _paths(build_model(ModelConfig(**CONFIGS[name])).init(None, "meta"))
    for rank in runs["ranks"]:
        held = rank["held"][(name, mode)]
        mesh = _placed(rank["coords"])
        specs = _paths(tsharding.shard_params_tree(_unpaths(full), mesh, fsdp=mode == "scan"))
        for path, t in full.items():
            assert not tsharding.uses_axis(specs[path], "client"), path
            assert held["shapes"][path] == tsharding.block_shape(tuple(t.shape), specs[path],
                                                                  mesh), path
        assert held["init_is_the_block"]
        twin = next(r for r in runs["ranks"] if r["coords"] == dict(rank["coords"], client=0))
        assert held["shapes"] == twin["held"][(name, mode)]["shapes"]
    if mode == "scan":
        assert tsharding.uses_axis(specs["layers/attn/wq"], "data")


def _collectives(name, mode, pdt, passes):
    """The collectives one round issues on each group of a rank of (client
    2, data 2, model 2), c = 2 clients a row, L = 2 layers, S local steps
    of each client, none blocked yet.

    A local step over ``model``: the dense model sums the embedding, each
    layer's ``wo`` and MLP and the loss's max and (sum of exponentials, gold
    logit) forward (7), and the gradient entering each layer's attention and
    MLP and the head backward (5); the MoE's expert block takes one sum
    forward and two backward (its tokens and gates entering the split
    experts): 14.  Under FSDP, over ``data``: the loss's global label count
    (the MoE also its router's means, one all-reduce a layer) forward, and
    the gradients
    of the unsplit leaves (each layer's norms, the final norm) summed
    backward; one all-gather and one reduce-scatter for each layer, the
    embedding and the head.  AFA's tree form: the row norms and a pass's
    dots and |agg|^2 summed over each group of axes that splits leaves (one
    all-reduce a group), a pass's weighted sum (a leaf each) and
    similarities' gather over ``client``, and the final weighted sum; int8
    storage adds a scale maximum a client and group, and the scales' one
    gather.  remat: its accumulators summed over ``client`` a leaf each in
    passes 1 and 3, a client's norm and dot and |agg|^2 over each group, and
    the norms' and dots' gathers."""
    cfg = ModelConfig(**CONFIGS[name])
    mesh = tmesh.make_test_mesh(**GRID)
    specs = tsharding.shard_params_tree(build_model(cfg).init(None, "meta"), mesh,
                                        fsdp=mode != "vmap")
    from repro_torch.utils.trees import tree_leaves

    groups = {"+".join(a for a in mesh.axis_names if tsharding.uses_axis(s, a))
              for s in tree_leaves(specs)} - {""}
    leaves, L, c = len(tree_leaves(specs)), cfg.num_layers, K // GRID["client"]
    step_model = 12 if name == "dense" else 14
    steps = {"vmap": STEPS, "scan": c * STEPS, "remat": 3 * c}[mode]
    reduces = {"model": steps * step_model}
    if mode == "remat":
        reduces["client"] = 2 * leaves + 2
        afa = 2 * c + 1
    else:
        reduces["client"] = passes * (leaves + 1) + leaves + (pdt == "int8")
        afa = 1 + passes + c * (pdt == "int8")
    if mode != "vmap":
        step_data = 1 + L + 1 + (L if name == "moe" else 0)
        reduces["data"] = steps * step_data
    for g in groups:
        reduces[g] = reduces.get(g, 0) + afa
    fsdp = {} if mode == "vmap" else {"data": steps * (L + 2)}
    return reduces, fsdp, fsdp


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collectives_a_round(runs, case):
    for rank in runs["ranks"]:
        got = rank["cases"][case]
        assert got["collectives"] == _collectives(*case, got["decisions"][4]), \
            (case, rank["coords"], got["collectives"])


def test_serving_on_the_client_grid_equals_the_reference(runs):
    """The client axis idles: the 4 prompts' rows split over ``data`` (2 a
    rank), the kv heads over ``model``; both client rows serve alike."""
    ref = runs["serve"]
    assert min(ref["margins"]) > 1e-4, "a greedy tie would decide the tokens"
    for rank in runs["ranks"]:
        got = rank["serve"]
        rows = slice(rank["coords"]["data"] * (B // 2), (rank["coords"]["data"] + 1) * (B // 2))
        assert got["cache_k"] == (2, B // 2, CACHE, 1, 8)
        for t, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            np.testing.assert_allclose(g, w[rows], rtol=TOL, atol=TOL,
                                       err_msg=f"{rank['coords']} step {t}")
        for g, w in zip(got["tokens"], ref["tokens"]):
            np.testing.assert_array_equal(g, w[rows])
        np.testing.assert_array_equal(got["generate_tokens"],
                                      np.stack(ref["tokens"], axis=1)[rows])


def test_decode_32k_build_step_on_the_client_grid(runs):
    """``input_specs(model, "decode_32k", grid)`` gives each rank its data
    rows of the one-card bundle's tokens (the client axis idle), and its
    ``build_step`` decode step the one-card step's logits on those rows."""
    for rank in runs["ranks"]:
        got = rank["serve"]["decode_32k"]
        rows = slice(rank["coords"]["data"] * 2, rank["coords"]["data"] * 2 + 2)
        np.testing.assert_array_equal(got["grid"]["tokens"], got["one"]["tokens"][rows])
        np.testing.assert_allclose(got["grid"]["logits"], got["one"]["logits"][rows], rtol=TOL,
                                   atol=TOL, err_msg=str(rank["coords"]))


def test_one_rank_grid_is_the_one_card_round_bit_for_bit(runs):
    out, counts = runs["one"]
    for mode, (grid_run, card_run) in out.items():
        for path, want in card_run[0].items():
            np.testing.assert_array_equal(grid_run[0][path], want, err_msg=f"{mode} {path}")
        for a, b in zip(grid_run[1:], card_run[1:]):
            np.testing.assert_array_equal(a, b)
    assert counts == {}


def test_client_rows_equal_data_rows_bit_for_bit(runs):
    assert runs["client_rows_are_data_rows"]


def test_client_grid_refusals(runs):
    for rank in runs["ranks"]:
        assert rank["refusals"] == {
            "scan_foreign_client_axes": "ValueError", "vmap_foreign_client_axes": "ValueError",
            "scan_rows_do_not_split": "ValueError", "remat_rows_do_not_split": "ValueError",
            "scan_gram_over_rows": "ValueError", "scan_whole_batch": "ValueError"}


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_train_input_specs_on_a_client_grid(mode):
    """``input_specs(model, "train_4k", grid)`` for smollm-135m on ``meta``
    at each rank of (client 2, data 2, model 2): K is ``num_client_rows``
    (2) under vmap and ``fed_clients`` otherwise; a rank's batch is its
    client row's K / 2 clients; its arguments take exactly ``rank_bytes`` of
    the one-card bundle under ``arg_specs``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import train_round_config

    cfg = get_config("smollm-135m").with_(fed_mode=mode)
    mesh = tmesh.make_test_mesh(**GRID)
    whole = tspecs.input_specs(build_model(cfg), "train_4k", mesh)
    K_want = 2 if mode == "vmap" else cfg.fed_clients
    assert whole.meta["num_clients"] == K_want == tspecs.fed_client_count(cfg, mesh)
    want = tspecs.rank_bytes(whole.args, tspecs.arg_specs(cfg, whole, mesh), mesh)
    for coords in ({"client": 0, "data": 0, "model": 0}, {"client": 1, "data": 1, "model": 1}):
        placed = mesh.at(coords)
        mine = tspecs.input_specs(build_model(cfg, grid=placed), "train_4k", placed)
        tok = mine.args[3]["tokens"]
        assert tuple(tok.shape) == (K_want // 2,) + tuple(whole.args[3]["tokens"].shape[1:])
        held = sum(t.numel() * t.element_size() for t in _leaves(mine.args))
        assert held == want
    fr = train_round_config(cfg, mesh)
    assert fr.num_clients == K_want
    assert fr.client_axes == (("client",) if mode == "vmap" else None)


def test_train_batch_on_a_client_grid_is_the_one_card_rows():
    """On the CPU, with the batch cut: a rank's seeded batch is its client
    row's rows of the one-card bundle's batch."""
    cfg = ModelConfig(**ALIGNED).with_(fed_mode="scan")
    mesh = tmesh.make_test_mesh(**GRID)
    one = tspecs.input_specs(build_model(cfg), "train_4k", device="cpu", global_batch=2,
                             local_steps=1)
    for row in range(GRID["client"]):
        placed = mesh.at({"client": row, "data": 1, "model": 0})
        mine = tspecs.input_specs(build_model(cfg, grid=placed), "train_4k", placed,
                                  device="cpu", global_batch=2, local_steps=1)
        for key, t in one.args[3].items():
            np.testing.assert_array_equal(mine.args[3][key].numpy(),
                                          t[row * 2:(row + 1) * 2].numpy())


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
