"""FSDP for the ``scan`` and ``remat`` rounds and MoE expert parallelism on
the port's data x model grid, against the JAX package, on the CPU (4 gloo
ranks of a (data 2, model 2) grid, spawned once for the module):

* ``scan`` storing float32, bfloat16 or int8 deltas, and ``remat``, on a
  reduced smollm (swiglu, GQA 4 / 2 heads of 16; every dim the FSDP rule
  splits divides 2), and a reduced olmoe (4 experts, top-2) in ``vmap`` and
  ``scan``, each held to the reference's single-device jitted
  ``make_fed_round`` of the same mode on the same weights (numpy, converted)
  and batch: the posteriors, blocked bits, good_frac, AFA rounds equal on
  every rank, the aggregate within 2e-4 / 2e-5 (int8: one quantization step
  of the leaf's scale beyond), the similarities within 1e-5.  The batch's 4
  rows a client split over the data ranks, with masks that differ between
  them, so the cross-entropy's global count is exercised;
* the MoE loss (its ``ce``, ``lb_loss`` and ``z_loss``) with the batch split
  over data equals the reference's loss on the whole batch;
* every rank holds exactly its ``fsdp=True`` blocks, drawn from the
  one-card stream, with the MLP and expert leaves split over data;
* the int8 scales are the same bits on every rank and equal the one-card
  round's within 1e-6 (a scale of the rank's block alone would not be);
* a (data 1, model 1) grid runs the one-card ``scan`` round bit for bit;
* the refusals: an encoder's decode step and an SSM scan round given
  client axes on the grid, a batch whose rows do not split over data, and
  rounds whose model was built for another mode
  (``tests/test_torch_grid_families.py`` runs the SSM, hybrid, VLM and audio
  families on the grid);
* the dry run's ``--mesh test`` report of a rank's parameter bytes at
  ``train_4k`` for phi3.5-moe and nemotron-4-340b equals the bytes under the
  reference's FSDP specs.

The reference's rounds, the reference's loss and the one-rank group run in
a pool of their own processes beside the 4 ranks.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch.shards import spawn  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402

DENSE = dict(name="smollm-fsdp", family="dense", num_layers=2, d_model=64, vocab_size=64,
             num_heads=4, num_kv_heads=2, d_ff=128, block_q=16, block_k=16, fed_clients=4)
MOE = dict(name="olmoe-fsdp", family="moe", num_layers=2, d_model=64, vocab_size=64,
           num_heads=4, num_kv_heads=4, d_ff=64, num_experts=4, top_k=2, block_q=16,
           block_k=16, fed_clients=4)
CONFIGS = {"dense": DENSE, "moe": MOE}
CASES = [("dense", "scan", "float32"), ("dense", "scan", "bfloat16"), ("dense", "scan", "int8"),
         ("dense", "remat", "float32"), ("moe", "vmap", "float32"), ("moe", "scan", "float32")]
IDS = ["-".join(c) for c in CASES]
K, STEPS, ROWS, SEQ, LR = 4, 2, 4, 16, 0.05
# remat retrains every client in each of its three passes: one local step
LOCAL_STEPS = {"vmap": STEPS, "scan": STEPS, "remat": 1}
RTOL, ATOL = 2e-4, 2e-5        # the reference's sharded test's bounds
ARCHS = ("phi3.5-moe-42b-a6.6b", "nemotron-4-340b")


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


def _round_config(mode, pdt, client_axes=None):
    from repro_torch.fed.distributed import FedRoundConfig

    return FedRoundConfig(num_clients=K, local_steps=LOCAL_STEPS[mode], lr=LR, mode=mode,
                          proposal_dtype=pdt, client_axes=client_axes)


def _grid_worker(params_np):
    """On each of 4 gloo ranks of a (data 2, model 2) grid: every case's
    round, the MoE loss on split rows, the blocks held, the refusals.
    Returns rank 0's dict with every rank's decisions."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round

    torch.set_num_threads(1)   # the ranks and the reference's processes share the cores
    grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=2, model=2), "cpu")
    out = {"cases": {}, "held": {}}
    for name in CONFIGS:
        cfg = ModelConfig(**CONFIGS[name]).with_(fed_mode="scan")
        drawn = build_model(cfg, grid=grid).init(torch.Generator().manual_seed(3), "cpu")
        whole = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
        specs = tsharding.shard_params_tree(whole, grid, fsdp=True)
        out["held"][name] = {
            "shapes": {p: tuple(t.shape) for p, t in _paths(drawn).items()},
            "init_is_the_block": all(torch.equal(a, b) for a, b in zip(
                _paths(drawn).values(), _paths(tsharding.shard_tree(whole, grid, specs)).values()))}
    mine = {}
    for name, mode, pdt in CASES:
        cfg = ModelConfig(**CONFIGS[name]).with_(fed_mode=mode)
        model = build_model(cfg, grid=grid)
        whole = model_params_from_numpy(params_np[name], device="cpu")
        specs = tsharding.shard_params_tree(whole, grid, fsdp=mode != "vmap")
        params = tsharding.shard_tree(whole, grid, specs)
        batch = {k: torch.from_numpy(v) for k, v in _batch(mode).items()}
        local, axes = batch, None
        if mode == "vmap":   # the clients ride the data rows
            local, axes = {k: v[grid.block(K, "data")] for k, v in batch.items()}, ("data",)
        grid.clear_counts()
        agg, rep, m = make_fed_round(model, _round_config(mode, pdt, axes), grid=grid)(
            params, init_reputation(K, device="cpu"), torch.ones(K), local)
        row = {"agg": {p: t.numpy() for p, t in
                       _paths(tsharding.unshard_tree(agg, grid, specs)).items()},
               "similarities": m["similarities"].numpy(),
               "all_gathers": dict(grid.all_gathers), "reduce_scatters": dict(grid.reduce_scatters)}
        if "scales" in m:
            s = torch.stack(list(m["scales"].values()))
            hi = grid.pmax(grid.pmax(s, "data"), "model")
            lo = -grid.pmax(grid.pmax(-s, "data"), "model")
            row["scales"] = {p: t.numpy() for p, t in m["scales"].items()}
            row["scales_same_on_every_rank"] = bool(torch.equal(hi, s) and torch.equal(lo, s))
        out["cases"][(name, mode, pdt)] = row
        mine[(name, mode, pdt)] = (rep.alpha.tolist(), rep.beta.tolist(), rep.blocked.tolist(),
                                   float(m["good_frac"]), int(m["afa_rounds"]))
    # the MoE loss: client 1's first step, its rows split over data
    model = build_model(ModelConfig(**MOE).with_(fed_mode="scan"), grid=grid)
    params = tsharding.shard_tree(model_params_from_numpy(params_np["moe"], device="cpu"), grid,
                                  tsharding.shard_params_tree(
                                      model_params_from_numpy(params_np["moe"], device="cpu"),
                                      grid, fsdp=True))
    mb = {k: torch.from_numpy(v[1, 0]) for k, v in _batch().items()}
    loss, metrics = model.loss_fn(params, mb)
    mine["loss"] = [float(loss)] + [float(metrics[k]) for k in ("ce", "lb_loss", "z_loss")]
    mine["refusals"] = _refusals(grid, params, model)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    dist.barrier()
    return out


def _refusals(grid, params, moe_model):
    """name -> the exception type each call raises on the grid."""
    from repro_torch.configs import get_config
    from repro_torch.fed.distributed import make_fed_round

    dense_vmap = build_model(ModelConfig(**DENSE), grid=grid)
    dense_scan = build_model(ModelConfig(**DENSE).with_(fed_mode="scan"), grid=grid)
    three = {"tokens": torch.zeros((3, SEQ), dtype=torch.int32),
             "labels": torch.zeros((3, SEQ), dtype=torch.int32)}
    audio = build_model(get_config("hubert-xlarge").reduced().with_(fed_mode="scan"), grid=grid)
    calls = {
        "encoder_decode": lambda: audio.decode_step(
            {}, {"pos": torch.zeros(1, dtype=torch.int32)}, torch.zeros(1, dtype=torch.int64)),
        "ssm_scan_client_axes": lambda: make_fed_round(
            build_model(get_config("mamba2-1.3b").reduced().with_(fed_mode="scan"), grid=grid),
            _round_config("scan", "float32", ("data",)), grid=grid),
        "rows_do_not_split": lambda: moe_model.loss_fn(params, three),
        "scan_without_fsdp": lambda: make_fed_round(dense_vmap, _round_config("scan", "int8"),
                                                    grid=grid),
        "remat_without_fsdp": lambda: make_fed_round(dense_vmap, _round_config("remat", "float32"),
                                                     grid=grid),
        "vmap_with_fsdp": lambda: make_fed_round(dense_scan, _round_config("vmap", "float32"),
                                                 grid=grid),
        "scan_client_axes": lambda: make_fed_round(
            dense_scan, _round_config("scan", "float32", ("data",)), grid=grid),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 -- the type is what the test reads
            out[name] = type(e).__name__
    return out


def _one_rank_job(params_np, bnp, store):
    """A (data 1, model 1) grid's int8 scan round and the one-card round on
    the same inputs, on a gloo group of one rank."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import make_fed_round

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=1, model=1), "cpu")
        model = build_model(ModelConfig(**DENSE).with_(fed_mode="scan"), grid=grid)
        params = model_params_from_numpy(params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in bnp.items()}
        runs = []
        for g in (grid, None):
            agg, rep, m = make_fed_round(model, _round_config("scan", "int8"), grid=g)(
                params, init_reputation(K, device="cpu"), torch.ones(K), batch)
            runs.append(({p: t.numpy() for p, t in _paths(agg).items()}, rep.alpha.numpy(),
                         rep.beta.numpy(), {p: t.numpy() for p, t in m["scales"].items()}))
        return runs, dict(grid.all_reduces)
    finally:
        dist.destroy_process_group()


def _jax_model(name):
    from repro.models import ModelConfig as JCfg
    from repro.models import build_model as jbuild

    return jbuild(JCfg(**CONFIGS[name]))


def _jax_rounds(cases, params_np, extra=None):
    """``_jax_round`` of each case, and ``_jax_loss`` or ``_jax_fsdp_bytes``
    if asked (``extra``), in one process of one XLA thread (the gloo ranks
    share the cores)."""
    import os

    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    out = {case: _jax_round(*case, params_np[case[0]]) for case in cases}
    if extra == "loss":
        out["loss"] = _jax_loss(params_np)
    elif extra == "bytes":
        out["bytes"] = {arch: _jax_fsdp_bytes(arch) for arch in ARCHS}
    return out


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


def _jax_loss(params_np):
    """The reference's MoE loss on client 1's first step, all its rows."""
    import jax
    import jax.numpy as jnp

    params = jax.tree_util.tree_map(jnp.asarray, params_np["moe"])
    loss, m = jax.jit(_jax_model("moe").loss_fn)(params, {k: jnp.asarray(v[1, 0])
                                                          for k, v in _batch().items()})
    return [float(loss)] + [float(m[k]) for k in ("ce", "lb_loss", "z_loss")]


def _jax_fsdp_bytes(arch):
    """The bytes a rank of (data 2, model 2) holds of ``arch``'s parameters
    under the reference's ``fsdp=True`` specs."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.launch.sharding import shard_params_tree
    from repro.models import build_model as jbuild

    shapes = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    specs = shard_params_tree(shapes, AbstractMesh((2, 2), ("data", "model")), fsdp=True)
    grid = tmesh.make_test_mesh(data=2, model=2)
    return sum(tsharding.shard_bytes(tuple(s.shape), s.dtype.itemsize, tuple(s.sharding.spec),
                                     grid) for s in jax.tree_util.tree_leaves(specs))


@pytest.fixture(autouse=True, scope="module")
def _pool(tmp_path_factory):
    """The reference's rounds and loss and the one-rank group, in a pool of
    their own processes started with the module's first test."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    store = tmp_path_factory.mktemp("one_rank") / "store"
    params = {name: _params(name) for name in CONFIGS}
    # three processes of the reference (each imports jax once), two
    # compiles each, the MoE loss with the MoE rounds
    extras = {0: "bytes", 4: "loss"}
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield {"refs": [pool.submit(_jax_rounds, CASES[i:i + 2], params, extras.get(i))
                        for i in range(0, len(CASES), 2)],
               "one": pool.submit(_one_rank_job, params["dense"], _batch(), str(store))}


@pytest.fixture(scope="module")
def runs(_pool):
    four = spawn(_grid_worker, 4, backend="gloo", device="cpu",
                 args=({name: _params(name) for name in CONFIGS},))
    refs = {}
    for f in _pool["refs"]:
        refs.update(f.result())
    return {"four": four, "loss": refs.pop("loss"), "bytes": refs.pop("bytes"), "refs": refs,
            "one": _pool["one"].result()}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grid_round_equals_the_reference(runs, case):
    agg, decisions, sims = runs["refs"][case]
    got = runs["four"]["cases"][case]
    for rank in runs["four"]["ranks"]:
        assert rank[case] == decisions, (case, rank[case], decisions)
    assert decisions[3] == 0.75 and decisions[1][0] == 4.0   # client 0 screened out
    np.testing.assert_allclose(got["similarities"], sims, rtol=1e-5, atol=1e-5)
    for path, want in agg.items():
        rtol, atol = RTOL, ATOL
        if case[2] == "int8":   # one quantization step of the leaf's scale
            atol += float(got["scales"][path].max())
        elif case[2] == "bfloat16":   # a stored proposal rounded to its neighbour
            rtol = 2.0 ** -7
        np.testing.assert_allclose(got["agg"][path], want, rtol=rtol, atol=atol,
                                   err_msg=f"{case} {path}")


def test_moe_loss_on_split_rows_equals_the_reference(runs):
    want = runs["loss"]
    for rank in runs["four"]["ranks"]:
        np.testing.assert_allclose(rank["loss"], want, rtol=1e-5, atol=1e-6)
    assert want[2] > 0 and want[3] > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_its_fsdp_blocks(runs, name):
    held = runs["four"]["held"][name]
    full = _paths(build_model(ModelConfig(**CONFIGS[name])).init(None, "meta"))
    grid = tmesh.make_test_mesh(data=2, model=2)
    specs = _paths(tsharding.shard_params_tree(_unpaths(full), grid, fsdp=True))
    for path, t in full.items():
        want = tuple(n // (1 if e is None else 2) for n, e in zip(t.shape, specs[path]))
        assert held["shapes"][path] == want, path
    on_data = {p for p, s in specs.items() if tsharding.uses_axis(s, "data")}
    experts = {f"layers/moe/{w}" for w in ("gate", "up", "down")}
    must = ({f"layers/mlp/{w}" for w in ("gate", "up", "down")} if name == "dense"
            else experts | {"layers/moe/router"})
    assert must <= on_data, sorted(on_data)
    if name == "moe":   # the expert dim over model, the router replicated over it
        assert all(specs[p][1] == "model" for p in experts)
        assert not tsharding.uses_axis(specs["layers/moe/router"], "model")
    assert held["init_is_the_block"]


def test_int8_scales_are_the_whole_leaf_s(runs):
    got = runs["four"]["cases"][("dense", "scan", "int8")]
    assert got["scales_same_on_every_rank"]
    (_, (_, _, _, one_card)), _ = runs["one"]
    for path, want in one_card.items():
        # a client whose delta is rounding noise (the byzantine one's
        # attention keys) has a scale ~1e-12: held to the leaf's largest
        np.testing.assert_allclose(got["scales"][path], want, rtol=1e-6,
                                   atol=1e-6 * float(want.max()), err_msg=path)


def test_fsdp_gathers_and_scatters_each_split_leaf(runs):
    """A local step gathers the data-split leaves over ``data`` in one
    all-gather a layer (the dense model's 7 leaves of a layer travel
    together), one for the embedding and one for the head, and
    reduce-scatters their gradients alike: 4 a step; 4 clients x 2 steps
    under scan (none blocked yet), 3 passes x 4 clients x 1 step under
    remat."""
    cases = runs["four"]["cases"]
    for (name, mode, pdt), got in cases.items():
        if name != "dense":
            continue
        trained = {"scan": K, "remat": 3 * K}[mode] * LOCAL_STEPS[mode]
        assert got["all_gathers"] == got["reduce_scatters"] == {"data": 4 * trained}, (mode, pdt)


def test_grid_refusals(runs):
    for rank in runs["four"]["ranks"]:
        assert rank["refusals"] == {
            "encoder_decode": "ValueError", "ssm_scan_client_axes": "ValueError",
            "rows_do_not_split": "ValueError", "scan_without_fsdp": "ValueError",
            "remat_without_fsdp": "ValueError", "vmap_with_fsdp": "ValueError",
            "scan_client_axes": "ValueError"}


def test_one_rank_grid_is_the_one_card_scan_bit_for_bit(runs):
    (grid_run, card_run), counts = runs["one"]
    for path, want in card_run[0].items():
        np.testing.assert_array_equal(grid_run[0][path], want)
    for a, b in zip(grid_run[1:3], card_run[1:3]):
        np.testing.assert_array_equal(a, b)
    for path, want in card_run[3].items():
        np.testing.assert_array_equal(grid_run[3][path], want)
    assert counts == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_reports_a_rank_s_fsdp_bytes(monkeypatch, tmp_path, runs, arch):
    """``dryrun --mesh test`` at ``train_4k``: a rank's parameter bytes are
    the sum of ``shard_bytes`` under the reference's ``fsdp=True`` specs
    (``_jax_fsdp_bytes``; the FLOP count, which the test does not read, is
    skipped)."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "count_step", lambda *a, **kw: {"output_bytes": 0})
    rec = dryrun.run_one(arch, "train_4k", tmp_path, mesh="test")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["per_rank_param_bytes"] == runs["bytes"][arch]
