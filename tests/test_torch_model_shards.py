"""The port's model axis (``repro_torch.launch.{mesh,sharding}``, the
tensor-parallel dense model, AFA's tree form on a grid and the vmap round on
a data x model mesh) against the JAX package, on the CPU (gloo ranks):

* the mesh helpers equal ``repro/launch/mesh.py``'s; ``param_pspec`` over
  every registry arch's parameters (built on the meta device) equals the
  reference's ``shard_params_tree`` over ``jax.eval_shape`` of its init, at
  (data, model) (2, 2), (1, 4), (16, 16), (pod, data, model) (2, 16, 16)
  and (client, data, model) (2, 2, 2), (4, 1, 4), (16, 16, 16), with
  ``client_axis`` and ``fsdp`` on and off; ``specs.arg_specs``
  (``batch_pspec``, ``cache_pspec``) equals the shardings of the
  reference's ``input_specs`` on every arch and shape at those meshes
  (shape-only ``AbstractMesh``es), ``specs.fed_client_count`` the
  reference's, and ``specs.rank_bytes`` the bytes of the reference's shard
  shapes (``NamedSharding.shard_shape``);
* the vmap round on 4 gloo ranks of a (data 2, model 2) grid equals the
  reference's single-device jitted ``make_fed_round``: its own test's tiny
  dense config (whole heads a rank) and a variant whose split cuts a head
  (3 heads of 16 over 2 ranks), at K = 2 (``make_train_step``, as the
  reference's test) and K = 4 (client 0 byzantine), the weights carried
  across by ``repro_torch.convert``: aggregate within 2e-4 / 2e-5, the
  posteriors and blocked bits equal; every rank holds exactly its spec's
  blocks; the all-reduces a round on each group, as counted;
* the sharded loss's gradient, gathered, equals the one-card gradient;
* a (data 1, model 1) grid runs the one-card round bit for bit; the grid
  refuses scan and remat on a model built without FSDP, an encoder's decode
  step, an SSM round of K not divisible by the rows, the gram variant over
  several rows, foreign client axes and K not divisible by the rows
  (``tests/test_torch_fsdp_experts.py`` runs scan, remat and the MoE family
  on the grid, ``tests/test_torch_grid_serving.py`` serves dense and MoE
  models on it, ``tests/test_torch_grid_families.py`` trains and serves the
  SSM, hybrid, VLM and audio families there);
* the dry run's ``--mesh``: a rank's bytes under the specs.

The ranks are spawned once a module (the fixtures); they import this
module, so the JAX package is imported only inside the tests that use it.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ALIASES, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.shards import spawn  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.model import tree_apply  # noqa: E402

ARCHS = list(ALIASES)
MESHES = {"2x2": (("data", "model"), (2, 2)), "1x4": (("data", "model"), (1, 4)),
          "pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16)),
          # a dedicated client axis before data and model
          "c2x2x2": (("client", "data", "model"), (2, 2, 2)),
          "c4x1x4": (("client", "data", "model"), (4, 1, 4)),
          "c16x16x16": (("client", "data", "model"), (16, 16, 16))}
# the reference test's tiny dense config (tests/test_distributed_equivalence.py)
ALIGNED = dict(name="eq", family="dense", num_layers=2, d_model=32, vocab_size=64,
               num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16,
               fed_mode="vmap", fed_clients=2)
CUT = dict(ALIGNED, d_model=48, num_heads=3, num_kv_heads=3)   # 1.5 heads a rank
CONFIGS = {"aligned": ALIGNED, "cut": CUT}
KS = (2, 4)
RTOL, ATOL = 2e-4, 2e-5        # the reference's sharded test's bounds
STEPS, LR = 2, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract(name):
    from jax.sharding import AbstractMesh

    axes, sizes = MESHES[name]
    return AbstractMesh(sizes, axes)


def _shape_mesh(name):
    axes, sizes = MESHES[name]
    return tmesh.MeshShape(axes, sizes)


# ------------------------------- mesh helpers --------------------------------


def test_mesh_helpers_equal_the_reference():
    from repro.launch import mesh as rmesh

    for kw in (dict(), dict(data=1, model=4), dict(data=2, model=2, pod=2),
               dict(data=0, model=2, client=4), dict(data=2, model=2, pod=2, client=2)):
        got = tmesh.make_test_mesh(**kw)
        shape = tuple(n for a, n in (("client", kw.get("client", 0)), ("pod", kw.get("pod", 0)),
                                     ("data", kw.get("data", 2)), ("model", kw.get("model", 2)))
                      if n)

        class Fake:   # the attributes the reference's helpers read
            axis_names = got.axis_names
            shape = dict(got.shape)

        assert tuple(got.shape.values()) == shape
        assert tmesh.client_axis(got) == rmesh.client_axis(Fake)
        assert tmesh.data_axes(got) == rmesh.data_axes(Fake)
        assert tmesh.client_row_axes(got) == rmesh.client_row_axes(Fake)
        assert tmesh.num_client_rows(got) == rmesh.num_client_rows(Fake)
    with pytest.raises(ValueError, match="at least one non-zero axis"):
        tmesh.make_test_mesh(data=0, model=0)
    pod, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert (pod.axis_names, tuple(pod.shape.values())) == (("data", "model"), (16, 16))
    assert (multi.axis_names, tuple(multi.shape.values())) == (("pod", "data", "model"),
                                                               (2, 16, 16))
    assert tmesh.num_client_rows(multi) == 32 and multi.devices == 512
    at = multi.at({"pod": 1, "data": 3, "model": 5})
    assert at.index(("pod", "data")) == 19 and at.index("model") == 5


# ----------------------------------- specs -----------------------------------


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    import jax

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    return jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _meta_params(arch):
    return build_model(get_config(arch)).init(None, "meta")


def _paths(tree, prefix=""):
    """path -> leaf of a nested dict (the reference's ``_path_str``)."""
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    import jax

    from repro.launch.sharding import shard_params_tree

    amesh, smesh = _abstract(mesh), _shape_mesh(mesh)
    K = 2 * tmesh.num_client_rows(smesh)
    for client in (False, True):
        ref_shapes = _jax_shapes(arch)
        ours = _meta_params(arch)
        if client:
            ref_shapes = jax.tree_util.tree_map(
                lambda l: jax.ShapeDtypeStruct((K,) + l.shape, l.dtype), ref_shapes)
            ours = tree_apply(lambda t: torch.empty((K,) + tuple(t.shape), device="meta"), ours)
        for fsdp in (False, True):
            ref = _paths(jax.tree_util.tree_map(
                lambda s: tuple(s.sharding.spec),
                shard_params_tree(ref_shapes, amesh, client_axis=client, fsdp=fsdp)))
            got = _paths(tsharding.shard_params_tree(ours, smesh, client_axis=client, fsdp=fsdp))
            assert got == ref, (arch, mesh, client, fsdp)


def _flat_specs(args, specs):
    """(shape, spec) of every tensor of ``args`` in the JAX package's leaf
    order (dict keys sorted), with its spec from the parallel ``specs``."""
    if isinstance(args, torch.Tensor):
        return [(tuple(args.shape), specs)]
    if isinstance(args, dict):
        return [x for k in sorted(args) for x in _flat_specs(args[k], specs[k])]
    return [x for a, s in zip(args, specs) for x in _flat_specs(a, s)]


@functools.lru_cache(maxsize=None)
def _jax_input_specs(mesh):
    """The reference's ``input_specs`` of every arch and shape on ``mesh``."""
    from repro.configs import get_config as jget
    from repro.launch.specs import input_specs as jax_input_specs
    from repro.models import build_model as jbuild

    amesh = _abstract(mesh)
    return {(arch, shape): jax_input_specs(jbuild(jget(arch)), shape, amesh)
            for arch in ARCHS for shape in tspecs.INPUT_SHAPES}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_arg_specs_equal_the_reference_input_specs(mesh):
    """Every arch and shape: ``batch_pspec``, ``cache_pspec`` and the
    parameter specs as the reference's ``input_specs`` annotates them."""
    import jax

    smesh = _shape_mesh(mesh)
    refs = _jax_input_specs(mesh)
    for arch in ARCHS:
        model = build_model(get_config(arch))
        for shape in tspecs.INPUT_SHAPES:
            ref = refs[(arch, shape)]
            got = tspecs.input_specs(model, shape, smesh)
            assert got.step_kind == ref.step_kind, (arch, shape)
            want = [(tuple(l.shape), tuple(l.sharding.spec))
                    for l in jax.tree_util.tree_leaves(ref.args)]
            have = _flat_specs(got.args, tspecs.arg_specs(model.config, got, smesh))
            assert have == want, (arch, shape, mesh)
            assert got.meta.get("mesh") == ref.meta.get("mesh"), (arch, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_client_count_and_rank_bytes_equal_the_reference(mesh):
    """Every arch: ``fed_client_count`` in each fed mode equals the
    reference's on the mesh; at every shape ``rank_bytes`` of the arguments
    under ``arg_specs`` equals the bytes of the reference's shard shapes."""
    import jax

    from repro.configs import get_config as jget
    from repro.launch.specs import fed_client_count as jax_fed_client_count

    amesh, smesh = _abstract(mesh), _shape_mesh(mesh)
    refs = _jax_input_specs(mesh)
    for arch in ARCHS:
        for mode in ("vmap", "scan", "remat"):
            assert (tspecs.fed_client_count(get_config(arch).with_(fed_mode=mode), smesh)
                    == jax_fed_client_count(jget(arch).with_(fed_mode=mode), amesh)), (arch, mode)
        model = build_model(get_config(arch))
        for shape in tspecs.INPUT_SHAPES:
            got = tspecs.input_specs(model, shape, smesh)
            want = sum(math.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
                       for l in jax.tree_util.tree_leaves(refs[(arch, shape)].args))
            have = tspecs.rank_bytes(got.args, tspecs.arg_specs(model.config, got, smesh), smesh)
            assert have == want, (arch, shape, mesh)
            if got.step_kind == "train":
                assert got.meta["num_clients"] == refs[(arch, shape)].meta["num_clients"]


def test_train_config_on_a_mesh():
    from repro_torch.launch.steps import train_round_config

    grid = tmesh.make_test_mesh(data=2, model=2)
    cfg = get_config("smollm-135m")
    assert tspecs.fed_client_count(cfg, grid) == 2 == tspecs.fed_client_count(cfg, 2)
    fr = train_round_config(cfg, grid)
    assert (fr.num_clients, fr.client_axes) == (2, ("data",))
    assert train_round_config(cfg, 2).client_axes is None
    scan = train_round_config(cfg.with_(fed_mode="scan"), grid)
    assert (scan.num_clients, scan.client_axes) == (cfg.fed_clients, None)


def test_dryrun_reports_a_rank_s_bytes(tmp_path):
    from repro_torch.launch import dryrun

    rec = dryrun.run_one("smollm-135m", "decode_32k", tmp_path, mesh="test")
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("smollm-135m")
    params = _meta_params("smollm-135m")
    specs = tsharding.shard_params_tree(params, tmesh.make_test_mesh())
    want = sum(t.numel() * t.element_size() // (2 if tsharding.uses_axis(s, "model") else 1)
               for t, s in zip(_paths(params).values(), _paths(specs).values()))
    assert rec["memory"]["per_rank_param_bytes"] == want
    # the (30, 128, 32,768, 3, 64) bf16 k and v: batch over data, positions
    # over model (3 kv heads do not split over 2); the cache's pos, the
    # tokens and pos (128,) int32 over data
    kv = 30 * 128 * 32768 * 3 * 64 * 2
    assert rec["memory"]["per_rank_argument_bytes"] == want + 2 * kv // 4 + 3 * 128 * 4 // 2
    assert rec["mesh_axes"] == {"data": 2, "model": 2} and rec["num_chips"] == 4
    assert rec["meta"]["client_rows"] == 2
    assert rec["analytic"] == dryrun.analytic_report(cfg, "decode_32k", 2)
    with pytest.raises(ValueError, match="meta"):
        dryrun.run_one("smollm-135m", "train_4k", tmp_path, mesh="test", device="cuda")


# ------------------------------- the sharded round ---------------------------


def _batch(K, byzantine, seed=0):
    """The reference test's batch: (K, 2 steps, 4, 16) tokens and labels;
    the first ``byzantine`` clients get the train CLI's attack."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 64, (K, STEPS, 4, 16)).astype(np.int32)
    lab = rng.integers(0, 64, (K, STEPS, 4, 16)).astype(np.int32)
    tok[:byzantine], lab[:byzantine] = 0, 0
    return {"tokens": tok, "labels": lab}


def _byzantine(K):
    return 1 if K > 2 else 0


@functools.lru_cache(maxsize=None)
def _params(name):
    """Seeded numpy weights in the shape of the config's parameter tree
    (the same for both packages): normal / sqrt(fan-in), the embedding and
    head at 0.02, the norms 0."""
    rng = np.random.default_rng(0)
    shapes = _paths(build_model(ModelConfig(**CONFIGS[name])).init(None, "meta"))
    flat = {}
    for path, t in shapes.items():
        shape = tuple(t.shape)
        if "norm" in path:
            flat[path] = np.zeros(shape, np.float32)
            continue
        scale = 0.02 if path in ("embed", "head") else shape[-2] ** -0.5
        flat[path] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return _unpaths(flat)


def _grid_worker(params_np, cases):
    """On each of 4 gloo ranks of a (data 2, model 2) grid: every case's
    round, the gathered gradient, the blocks held, the all-reduces, the
    refusals.  Returns rank 0's dict; the rows' results are checked equal on
    every rank through an all-reduce."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import AFAConfig, init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round
    from repro_torch.launch.steps import make_train_step

    grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=2, model=2), "cpu")
    out = {"rank": grid.rank, "coords": grid.coords, "cases": {}, "grads": {}, "held": {}}
    for name, K in cases:
        cfg = ModelConfig(**CONFIGS[name])
        model = build_model(cfg, grid=grid)
        whole = model_params_from_numpy(params_np[name], device="cpu")
        specs = tsharding.shard_params_tree(whole, grid)
        params = tsharding.shard_tree(whole, grid, specs)
        drawn = model.init(torch.Generator().manual_seed(3), "cpu")
        one_card = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
        out["held"][name] = {
            "shapes": {p: tuple(t.shape) for p, t in _paths(params).items()},
            "init_is_the_block": all(torch.equal(a, b) for a, b in zip(
                _paths(drawn).values(),
                _paths(tsharding.shard_tree(one_card, grid, specs)).values()))}
        bnp = _batch(K, _byzantine(K))
        batch = {k: torch.from_numpy(v) for k, v in bnp.items()}
        bspecs = tree_apply(lambda t: tsharding.batch_pspec(
            tuple(t.shape), grid, client_axis=True, per_client_batch=True), batch)
        local = tsharding.shard_tree(batch, grid, bspecs)
        if K == tmesh.num_client_rows(grid):
            step = make_train_step(model, grid, local_steps=STEPS, lr=LR)
        else:
            step = make_fed_round(model, FedRoundConfig(
                num_clients=K, local_steps=STEPS, lr=LR, client_axes=("data",)), grid=grid)
        grid.all_reduces.clear()
        agg, rep, metrics = step(params, init_reputation(K, device="cpu"),
                                 torch.ones(K), local)
        counts = dict(grid.all_reduces)
        gathered = tsharding.unshard_tree(agg, grid, specs)
        out["cases"][(name, K)] = {
            "agg": tree_apply(lambda t: t.numpy(), gathered),
            "alpha": rep.alpha.numpy(), "beta": rep.beta.numpy(),
            "blocked": rep.blocked.numpy(), "rounds": int(metrics["afa_rounds"]),
            "all_reduces": counts,
            # every rank the same posteriors: their sum over the 4 ranks is 4x
            "alpha_sum": grid.psum(grid.psum(rep.alpha, "data"), "model").numpy()}
        if K == 2:
            # the gradient of the sharded loss on client 1's first step
            mb = {k: torch.from_numpy(v[1, 0]) for k, v in bnp.items()}
            leaves = {p: t.detach().requires_grad_(True) for p, t in _paths(params).items()}
            tree = _unpaths(leaves)
            g = torch.autograd.grad(model.loss_fn(tree, mb)[0], list(leaves.values()))
            grads = tsharding.unshard_tree(_unpaths(dict(zip(leaves, g))), grid, specs)
            out["grads"][name] = tree_apply(lambda t: t.numpy(), grads)
    out["refusals"] = _refusals(grid)
    dist.barrier()
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


def _refusals(grid):
    """name -> the exception type each call raises on the grid."""
    from repro_torch.core import AFAConfig, TreeShards, afa_aggregate_tree
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round

    model = build_model(ModelConfig(**ALIGNED), grid=grid)
    plain = build_model(ModelConfig(**ALIGNED))
    audio = build_model(get_config("hubert-xlarge").reduced(), grid=grid)
    ssm = build_model(get_config("mamba2-1.3b").reduced(), grid=grid)
    calls = {
        "scan": lambda: make_fed_round(model, FedRoundConfig(num_clients=2, mode="scan"),
                                       grid=grid),
        "remat": lambda: make_fed_round(model, FedRoundConfig(num_clients=2, mode="remat"),
                                        grid=grid),
        "encoder_decode": lambda: audio.decode_step(
            {}, {"pos": torch.zeros(1, dtype=torch.int32)}, torch.zeros(1, dtype=torch.int64)),
        "ssm_divisible": lambda: make_fed_round(ssm, FedRoundConfig(num_clients=3), grid=grid),
        "gram_rows": lambda: afa_aggregate_tree(
            {"w": torch.ones((1, 3))}, torch.ones(2), torch.ones(2),
            config=AFAConfig(variant="gram"), shards=TreeShards(grid, ("data",), ((),))),
        "client_axes": lambda: make_fed_round(model, FedRoundConfig(
            num_clients=2, client_axes=("model",)), grid=grid),
        "divisible": lambda: make_fed_round(model, FedRoundConfig(num_clients=3), grid=grid),
        "unsharded_model": lambda: make_fed_round(plain, FedRoundConfig(num_clients=2),
                                                  grid=grid),
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
    """A (data 1, model 1) grid's round and the one-card round on the same
    inputs, on a gloo group of one rank."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=1, model=1), "cpu")
        model = build_model(ModelConfig(**ALIGNED), grid=grid)
        params = model_params_from_numpy(params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in bnp.items()}
        cfg = FedRoundConfig(num_clients=4, local_steps=STEPS, lr=LR)
        runs = []
        for g in (grid, None):
            agg, rep, _ = make_fed_round(model, cfg, grid=g)(
                params, init_reputation(4, device="cpu"), torch.ones(4), batch)
            runs.append((tree_apply(lambda t: t.numpy(), agg), rep.alpha.numpy(),
                         rep.beta.numpy()))
        return runs, dict(grid.all_reduces)
    finally:
        dist.destroy_process_group()


def _jax_round(name, K, params_np):
    """The reference's single-device jitted round on the numpy weights."""
    import jax
    import jax.numpy as jnp

    from repro.core.reputation import init_reputation as jinit
    from repro.fed.distributed import FedRoundConfig as JFed
    from repro.fed.distributed import make_fed_round as jmake
    from repro.models import ModelConfig as JCfg
    from repro.models import build_model as jbuild

    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    fr = jax.jit(jmake(jbuild(JCfg(**CONFIGS[name])),
                       JFed(num_clients=K, local_steps=STEPS, lr=LR)))
    batch = {k: jnp.asarray(v) for k, v in _batch(K, _byzantine(K)).items()}
    agg, rep, m = fr(params, jinit(K), jnp.ones((K,), jnp.float32), batch)
    return (jax.tree_util.tree_map(np.asarray, agg), np.asarray(rep.alpha),
            np.asarray(rep.beta), np.asarray(rep.blocked), int(m["afa_rounds"]))


@pytest.fixture(autouse=True, scope="module")
def _pool(tmp_path_factory):
    """The reference's rounds and the one-rank group, started in a pool of
    their own processes with the module's first test, so that they run
    while the others do."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cases = [(name, K) for name in CONFIGS for K in KS]
    store = tmp_path_factory.mktemp("one_rank") / "store"
    with ProcessPoolExecutor(len(cases) + 1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        yield {"refs": {(n, K): pool.submit(_jax_round, n, K, _params(n)) for n, K in cases},
               "one": pool.submit(_one_rank_job, _params("aligned"), _batch(4, 1), str(store))}


@pytest.fixture(scope="module")
def runs(_pool):
    """The 4 gloo ranks' results, the reference's rounds and the one-rank
    grid's runs."""
    cases = [(name, K) for name in CONFIGS for K in KS]
    four = spawn(_grid_worker, 4, backend="gloo", device="cpu",
                 args=({name: _params(name) for name in CONFIGS}, cases))
    return {"four": four, "refs": {k: f.result() for k, f in _pool["refs"].items()},
            "one": _pool["one"].result()}


@pytest.fixture(scope="module")
def four_ranks(runs):
    return runs["four"]


def _assert_close_tree(got, want, rtol, atol, what):
    for path, w in _paths(want).items():
        np.testing.assert_allclose(_paths(got)[path], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_round_equals_the_reference(runs, name, K):
    agg, alpha, beta, blocked, rounds = runs["refs"][(name, K)]
    got = runs["four"]["cases"][(name, K)]
    _assert_close_tree(got["agg"], agg, RTOL, ATOL, f"{name} K={K}")
    np.testing.assert_array_equal(got["alpha"], alpha)
    np.testing.assert_array_equal(got["beta"], beta)
    np.testing.assert_array_equal(got["blocked"], blocked)
    assert got["rounds"] == rounds
    np.testing.assert_array_equal(got["alpha_sum"], 4 * got["alpha"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_gradient_equals_the_one_card_gradient(four_ranks, name):
    from repro_torch.convert import model_params_from_numpy

    params = model_params_from_numpy(_params(name), device="cpu")
    model = build_model(ModelConfig(**CONFIGS[name]))
    mb = {k: torch.from_numpy(v[1, 0]) for k, v in _batch(2, 0).items()}
    flat = {p: t.requires_grad_(True) for p, t in _paths(params).items()}
    g = torch.autograd.grad(model.loss_fn(_unpaths(flat), mb)[0], list(flat.values()))
    want = {p: t.numpy() for p, t in zip(flat, g)}
    got = _paths(four_ranks["grads"][name])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_its_blocks(four_ranks, name):
    held = four_ranks["held"][name]
    full = _paths(build_model(ModelConfig(**CONFIGS[name])).init(None, "meta"))
    grid = tmesh.make_test_mesh(data=2, model=2)
    specs = _paths(tsharding.shard_params_tree(_unpaths(full), grid))
    for path, t in full.items():
        want = tuple(n // (2 if e == "model" else 1) for n, e in
                     zip(t.shape, specs[path] + (None,) * (t.ndim - len(specs[path]))))
        assert held["shapes"][path] == want, path
    split = [p for p, s in specs.items() if tsharding.uses_axis(s, "model")]
    assert sorted(split) == sorted(["embed", "head"] + [f"layers/{p}" for p in (
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/gate", "mlp/up", "mlp/down")])
    assert held["init_is_the_block"]


def _all_reduces_a_round(name, passes):
    """The collectives of one round (L = 2 layers, S = 2 steps, 12 leaves,
    every leaf but the 5 norms split): a local step's forward sums the
    embedding, each layer's attention (whole heads: 1; a cut head: one
    gather of q, k and v together and wo's sum) and MLP, and the loss's max and
    (sum of exponentials, gold logit); its backward sums the gradient
    entering each layer's attention (whole heads: 1; a cut head: also the
    output's), its MLP and the head.  AFA: the row norms, then a pass's dots
    and |agg|^2 over ``model``; a pass's 12 leaves of the weighted sum and
    the similarities' gather over ``data``, and the final 12."""
    L, S, leaves = 2, 2, 12
    attn_fwd, attn_bwd = (1, 1) if name == "aligned" else (2, 2)
    step = 1 + L * (attn_fwd + 1) + 2 + L * (attn_bwd + 1) + 1
    return {"model": S * step + 1 + passes, "data": passes * (leaves + 1) + leaves}


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_all_reduces_a_round(four_ranks, name, K):
    got = four_ranks["cases"][(name, K)]
    assert got["all_reduces"] == _all_reduces_a_round(name, got["rounds"])


def test_grid_refusals(four_ranks):
    assert four_ranks["refusals"] == {
        "scan": "ValueError", "remat": "ValueError",
        "encoder_decode": "ValueError", "ssm_divisible": "ValueError",
        "gram_rows": "ValueError", "client_axes": "ValueError", "divisible": "ValueError",
        "unsharded_model": "ValueError"}


def test_one_rank_grid_is_the_one_card_round_bit_for_bit(runs):
    (grid_run, card_run), counts = runs["one"]
    for a, b in zip(_paths(grid_run[0]).values(), _paths(card_run[0]).values()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grid_run[1], card_run[1])
    np.testing.assert_array_equal(grid_run[2], card_run[2])
    assert counts == {}
