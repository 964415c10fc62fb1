"""The SSM, hybrid, VLM and audio families on the port's data x model grid,
training and serving, against the JAX package, on the CPU (4 gloo ranks of a
(data 2, model 2) grid, spawned once for the module):

* the reduced configs of mamba2-1.3b, zamba2-1.2b, paligemma-3b and
  hubert-xlarge in f32 (``in_proj``'s 1,104 columns split at 552, inside
  [x, B, C], past d_inner = 512; zamba2's 4 whole heads, paligemma's one kv
  head, hubert's 4 whole non-causal heads), on seeded numpy weights given to
  both packages;
* training: a vmap round of each family (K = 4, client 0 byzantine, 2
  rounds), and scan and remat rounds of mamba2 and zamba2 (FSDP, each
  client's 2 rows split over data with masks that differ between the data
  ranks), each held to the reference's single-device jitted
  ``make_fed_round`` of the same mode: the posteriors, blocked bits,
  good_frac and AFA rounds equal on every rank, the aggregate within 2e-4 /
  2e-5 (``tests/test_torch_fsdp_experts.py``'s bounds), every rank's
  weights exactly its spec blocks of the one-card draw;
* serving: mamba2 on a linear cache, zamba2 and paligemma on a linear and a
  ring cache (the ring prefill's prompt, 72 tokens, longer than the window
  of 64; the linear decodes below it, ROADMAP C.10; the VLM's linear cache
  sized ``prefix_len + prompt + steps``, C.11), then 5 greedy decode steps:
  each rank's rows' logits within 1e-5 of the reference's ``prefill`` and
  ``decode_step``, the tokens equal, ``launch.serve.generate`` on the grid
  giving the same tokens, each rank's cache its ``cache_pspec`` block of the
  reference's cache after the prefill and the last step (the SSM state's N
  block and the conv window whole on both model ranks, paligemma's slots,
  zamba2's shared caches' kv heads);
* hubert's ``forward`` and ``loss_fn`` on the grid within 1e-5 of the
  reference's; its ``decode_step`` raises;
* ``input_specs(model, "decode_32k", grid)`` on reduced mamba2, zamba2 and
  paligemma: each rank's cache its block of the one-card bundle's seeded
  cache (an SSM state's N block drawn alone), its tokens the bundle's rows,
  its decode step the one-card step's logits on them;
* ``rank_bytes(arg_specs)`` at ``decode_32k`` on ``meta`` equals what a
  rank of zamba2-1.2b and paligemma-3b at full size holds;
* a (data 1, model 1) grid serves and trains mamba2 and zamba2 as one card,
  bit for bit;
* the all-reduces of a decode step and of a round, as ``_decode_reduces``
  and ``_round_reduces`` count them.

The reference's steps and the one-rank group run in a pool of their own
processes beside the 4 ranks.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.shards import spawn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import hybrid_segments  # noqa: E402

ARCHS = {"ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b", "vlm": "paligemma-3b",
         "audio": "hubert-xlarge"}
F32 = dict(param_dtype="float32", compute_dtype="float32")
K, ROWS, SEQ, LR = 4, 2, 8, 0.05
LOCAL_STEPS = {"vmap": 2, "scan": 2, "remat": 1}
VMAP_ROUNDS = 2
TRAIN_CASES = [(name, "vmap") for name in ARCHS] + [
    (name, mode) for name in ("ssm", "hybrid") for mode in ("scan", "remat")]
TRAIN_IDS = ["-".join(c) for c in TRAIN_CASES]
B, STEPS = 4, 5
PROMPT = {"linear": 12, "ring": 72}   # the ring's prompt past the reduced window of 64
SERVE_CASES = [("ssm", "linear"), ("hybrid", "linear"), ("hybrid", "ring"), ("vlm", "linear"),
               ("vlm", "ring")]
SERVE_IDS = ["-".join(c) for c in SERVE_CASES]
STEP_FAMILIES = ("ssm", "hybrid", "vlm")
STEP_B = 2   # decode_32k's sequences in the build_step checks: one a data rank
ONE_RANK = ("ssm", "hybrid")
AUDIO_L = 16
RTOL, ATOL = 2e-4, 2e-5        # the reference's sharded test's bounds
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, mode="vmap"):
    return get_config(ARCHS[name]).reduced().with_(fed_mode=mode, **F32)


def _cfg_dict(name, mode="vmap"):
    return dataclasses.asdict(_cfg(name, mode))


def _size(name, lay):
    """A case's cache slots: the window (ring), else prefix, prompt and the
    decoded positions (even, so that a slot-split cache splits)."""
    cfg = _cfg(name)
    if lay == "ring":
        return cfg.sliding_window
    return cfg.prefix_len + PROMPT[lay] + STEPS + 1


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
    """Seeded numpy weights in the config's tree: a matrix normal /
    sqrt(its second-to-last dim), the embedding and head at 0.02; Mamba-2's
    ``A_log`` near log(1..16), ``D`` near 1, its other vectors and the norms'
    gains small normals."""
    rng = np.random.default_rng(1)
    flat = {}
    for path, t in _paths(build_model(_cfg(name)).init(None, "meta")).items():
        shape = tuple(t.shape)
        noise = rng.standard_normal(shape).astype(np.float32)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "A_log":
            flat[path] = np.log(np.linspace(1.0, 16.0, shape[-1], dtype=np.float32)) + 0.1 * noise
        elif leaf == "D":
            flat[path] = 1.0 + 0.1 * noise
        elif len(shape) - path.startswith("layers/") < 2:   # a vector of a layer or the model
            flat[path] = 0.1 * noise
        else:
            scale = 0.02 if path in ("embed", "head") else shape[-2] ** -0.5
            flat[path] = (scale * noise).astype(np.float32)
    return _unpaths({p: v.astype(np.float32) for p, v in flat.items()})


def _batch(name, mode, rnd=0):
    """(K, S, 2 rows, ...) of client data; client 0 gets the train CLI's
    attack (its tokens and labels 0, a VLM's patches and audio's frames
    zero); row 0 of every other client masks 5 of its labels, so that the
    data ranks (one row each under FSDP) count different labels."""
    cfg = _cfg(name)
    rng = np.random.default_rng(10 + rnd)
    lead = (K, LOCAL_STEPS[mode], ROWS)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            lead + (cfg.prefix_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        out = {"frame_embeds": rng.standard_normal(lead + (SEQ, cfg.frontend_dim)).astype(
            np.float32), "labels": out["labels"]}
    for v in out.values():
        v[0] = 0
    out["labels"][1:, :, 0, 3:] = -1
    return out


def _prompts(name, lay):
    cfg = _cfg(name)
    rng = np.random.default_rng(2 if lay == "linear" else 3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT[lay])).astype(np.int64)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _frames():
    rng = np.random.default_rng(4)
    cfg = _cfg("audio")
    return {"frame_embeds": rng.standard_normal((B, AUDIO_L, cfg.frontend_dim)).astype(
        np.float32), "labels": rng.integers(0, cfg.vocab_size, (B, AUDIO_L)).astype(np.int64)}


def _np(t):
    return t.detach().cpu().numpy().copy()   # a decode step writes the cache in place


def _cache_np(cache):
    """A cache's leaves by path (``layers/0``, ``layers/state``,
    ``shared/1``, ``pos``), copied to numpy."""
    return {path: _np(t) for path, t in _cache_flat(cache).items()}


def _whole_specs(flat, mesh):
    """``cache_tree_pspecs`` of a cache given by ``_cache_np``'s paths."""
    tree = {}
    for path, a in flat.items():
        key, _, sub = path.partition("/")
        meta = torch.empty(a.shape, device="meta")
        if not sub:
            tree[key] = meta
        elif sub.isdigit():
            tree.setdefault(key, [None, None])[int(sub)] = meta
        else:
            tree.setdefault(key, {})[sub] = meta
    tree = {k: tuple(v) if isinstance(v, list) else v for k, v in tree.items()}
    specs = tsharding.cache_tree_pspecs(tree, mesh)
    return {path: _at(specs, path) for path in flat}


def _at(specs, path):
    key, _, sub = path.partition("/")
    node = specs[key]
    return node if not sub else node[int(sub) if sub.isdigit() else sub]


# ------------------------------- the 4 ranks --------------------------------


def _held(grid, name, mode):
    """This rank's weights drawn on the grid: their shapes, and whether they
    equal the one-card draw's spec blocks."""
    model = build_model(_cfg(name, mode), grid=grid)
    drawn = model.init(torch.Generator().manual_seed(3), "cpu")
    whole = build_model(_cfg(name, mode)).init(torch.Generator().manual_seed(3), "cpu")
    blocks = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(
        whole, grid, fsdp=model.fsdp))
    return {"shapes": {p: tuple(t.shape) for p, t in _paths(drawn).items()},
            "init_is_the_block": all(torch.equal(a, b) for a, b in zip(
                _paths(drawn).values(), _paths(blocks).values()))}


def _train_case(grid, name, mode, params_np):
    """The case's rounds on this rank: the aggregates gathered whole, the
    decisions, the all-reduces of each round."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round

    model = build_model(_cfg(name, mode), grid=grid)
    whole = model_params_from_numpy(params_np, device="cpu")
    specs = tsharding.shard_params_tree(whole, grid, fsdp=model.fsdp)
    params = tsharding.shard_tree(whole, grid, specs)
    fed_round = make_fed_round(model, FedRoundConfig(
        num_clients=K, local_steps=LOCAL_STEPS[mode], lr=LR, mode=mode,
        proposal_dtype="float32", client_axes=("data",) if mode == "vmap" else None), grid=grid)
    rep = init_reputation(K, device="cpu")
    rounds = []
    for rnd in range(VMAP_ROUNDS if mode == "vmap" else 1):
        batch = {k: torch.from_numpy(v) for k, v in _batch(name, mode, rnd).items()}
        if mode == "vmap":   # the clients ride the data rows
            batch = {k: v[grid.block(K, "data")] for k, v in batch.items()}
        grid.clear_counts()
        params, rep, m = fed_round(params, rep, torch.ones(K), batch)
        counts = dict(grid.all_reduces)
        rounds.append({
            "agg": {p: t.numpy() for p, t in
                    _paths(tsharding.unshard_tree(params, grid, specs)).items()},
            "decisions": (rep.alpha.tolist(), rep.beta.tolist(), rep.blocked.tolist(),
                          float(m["good_frac"]), int(m["afa_rounds"])),
            "all_reduces": counts})
    return rounds


def _serve_case(grid, name, lay, params_np):
    """Prefill, then greedy decode steps fed the rank's own argmax (the
    linear layout feeds the whole batch's tokens, gathered over data, the
    ring this rank's rows), and ``generate``."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.serve import generate

    ring, size = lay == "ring", _size(name, lay)
    model = build_model(_cfg(name), grid=grid)
    whole = model_params_from_numpy(params_np, device="cpu")
    params = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(whole, grid))
    batch = {k: torch.from_numpy(v) for k, v in _prompts(name, lay).items()}
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cache_size=size, use_window=ring)
        row = {"logits": [_np(logits)], "prefill_cache": _cache_np(cache), "tokens": []}
        for step in range(STEPS):
            nxt = torch.argmax(logits, -1)
            row["tokens"].append(_np(nxt))
            if lay == "linear":
                nxt = grid.gather_rows(nxt, B, "data")
            grid.clear_counts()
            logits, cache = model.decode_step(params, cache, nxt, ring=ring, cache_size=size)
            if step == 0:
                row["all_reduces"] = dict(grid.all_reduces)
            row["logits"].append(_np(logits))
        row["tokens"].append(_np(torch.argmax(logits, -1)))
        row["cache"] = _cache_np(cache)
        gen = generate(model, params, batch["tokens"], gen=STEPS + 1, ring=ring, cache_size=size,
                       patch_embeds=batch.get("patch_embeds"))
        row["generate_tokens"] = _np(gen.tokens)
    return row


def _audio_case(grid, params_np):
    from repro_torch.convert import model_params_from_numpy

    model = build_model(_cfg("audio"), grid=grid)
    whole = model_params_from_numpy(params_np, device="cpu")
    params = tsharding.shard_tree(whole, grid, tsharding.shard_params_tree(whole, grid))
    batch = {k: torch.from_numpy(v) for k, v in _frames().items()}
    with torch.no_grad():
        out = {"forward": _np(model.forward(params, batch)),
               "loss": float(model.loss_fn(params, batch)[0])}
        try:
            model.decode_step(params, {"pos": torch.zeros(B // 2, dtype=torch.int32)},
                              torch.zeros(B // 2, dtype=torch.int64))
            out["decode"] = None
        except ValueError as e:
            out["decode"] = str(e)
    return out


def _step_case(grid, name):
    """``build_step`` on a grid model against one card: the decode step of
    ``input_specs(..., "decode_32k", grid, global_batch=2)``.  The caches
    (0.13 GB for zamba2's) are compared here, on the rank, a leaf at a time:
    whether its seeded block is the one-card bundle's block bit for bit, and
    how far the block the step wrote lies from the one-card step's, in each
    leaf's largest magnitude."""
    from repro_torch.launch.steps import build_step

    cfg = _cfg(name)
    with torch.no_grad():
        one_model, model = build_model(cfg), build_model(cfg, grid=grid)
        one = tspecs.input_specs(one_model, "decode_32k", 1, device="cpu", global_batch=STEP_B)
        specs = tsharding.cache_tree_pspecs(one.args[1], grid)
        seeded = tsharding.shard_tree(one.args[1], grid, specs)
        one_logits, written = build_step(one_model, one)(*one.args)
        scale = {path: max(1.0, float(t.abs().max())) for path, t in _cache_flat(written).items()}
        written = tsharding.shard_tree(written, grid, specs)
        one_tokens = _np(one.args[2])
        del one
        mine = tspecs.input_specs(model, "decode_32k", grid, device="cpu", global_batch=STEP_B)
        seeded_is_the_block = {path: bool(torch.equal(t, _cache_flat(seeded)[path]))
                               for path, t in _cache_flat(mine.args[1]).items()}
        tokens = _np(mine.args[2])
        logits, cache = build_step(model, mine)(*mine.args)
        written_off = {path: float((t - _cache_flat(written)[path]).abs().max()) / scale[path]
                       for path, t in _cache_flat(cache).items()}
    return {"specs": {path: _at(specs, path) for path in scale}, "tokens": tokens,
            "one_tokens": one_tokens, "decode": _np(logits), "one_decode": _np(one_logits),
            "seeded_is_the_block": seeded_is_the_block, "written_off": written_off}


def _cache_flat(cache):
    """A cache's tensors by ``_cache_np``'s paths."""
    out = {}
    for key, node in cache.items():
        if isinstance(node, dict):
            out.update({f"{key}/{k}": v for k, v in node.items()})
        elif isinstance(node, (tuple, list)):
            out.update({f"{key}/{i}": v for i, v in enumerate(node)})
        else:
            out[key] = node
    return out


def _grid_worker(params_np):
    """On each of 4 gloo ranks of a (data 2, model 2) grid: every case.
    Returns every rank's results (rank 0's list)."""
    import torch.distributed as dist

    torch.set_num_threads(1)   # the ranks and the reference's processes share the cores
    grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=2, model=2), "cpu")
    mine = {"coords": dict(grid.coords), "held": {}, "train": {}, "serve": {}, "steps": {}}
    for name, mode in TRAIN_CASES:
        if mode != "remat":   # remat's blocks are scan's (fsdp=True)
            mine["held"][(name, mode)] = _held(grid, name, mode)
        mine["train"][(name, mode)] = _train_case(grid, name, mode, params_np[name])
    for name, lay in SERVE_CASES:
        mine["serve"][(name, lay)] = _serve_case(grid, name, lay, params_np[name])
    mine["audio"] = _audio_case(grid, params_np["audio"])
    for name in STEP_FAMILIES:
        mine["steps"][name] = _step_case(grid, name)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    dist.barrier()
    return ranks


def _one_rank_job(params_np, store):
    """On a gloo group of one rank: a (data 1, model 1) grid's prefill,
    decode steps and vmap round of each ``ONE_RANK`` family, and the
    one-card model's on the same inputs."""
    import torch.distributed as dist

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=1, model=1), "cpu")
        out = {}
        for name in ONE_RANK:
            params = model_params_from_numpy(params_np[name], device="cpu")
            prompts = {k: torch.from_numpy(v) for k, v in _prompts(name, "linear").items()}
            batch = {k: torch.from_numpy(v) for k, v in _batch(name, "vmap").items()}
            size = _size(name, "linear")
            runs = []
            for g in (grid, None):
                model = build_model(_cfg(name), grid=g)
                with torch.no_grad():
                    logits, cache = model.prefill(params, prompts, cache_size=size)
                    steps = [_np(logits)]
                    for _ in range(STEPS):
                        logits, cache = model.decode_step(params, cache,
                                                          torch.argmax(logits, -1))
                        steps.append(_np(logits))
                agg, rep, _ = make_fed_round(model, FedRoundConfig(
                    num_clients=K, local_steps=LOCAL_STEPS["vmap"], lr=LR), grid=g)(
                    params, init_reputation(K, device="cpu"), torch.ones(K), batch)
                runs.append((steps, _cache_np(cache), {p: t.numpy() for p, t in
                                                       _paths(agg).items()},
                             rep.alpha.numpy(), rep.beta.numpy()))
            out[name] = runs
        return out, dict(grid.all_reduces)
    finally:
        dist.destroy_process_group()


# ------------------------------ the reference ------------------------------


def _jax_jobs(jobs, params_np):
    """The reference's side of ``jobs`` (("train", name, mode), ("serve",
    name, lay) or ("audio",)) in one process of one XLA thread, at the
    lowest scheduling priority: the gloo ranks share the cores and wait on
    each other at every collective, so a rank held off its core holds up
    all four."""
    import os

    os.nice(19)
    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    fns = {"train": _jax_train, "serve": _jax_serve, "audio": _jax_audio}
    return {job: fns[job[0]](*job[1:], params_np) for job in jobs}


def _jax_model(name, mode="vmap"):
    from repro.models import ModelConfig as JCfg
    from repro.models import build_model as jbuild

    return jbuild(JCfg(**_cfg_dict(name, mode)))


def _jax_train(name, mode, params_np):
    """The reference's single-device jitted rounds of the case."""
    import jax
    import jax.numpy as jnp

    from repro.core.reputation import init_reputation as jinit
    from repro.fed.distributed import FedRoundConfig as JFed
    from repro.fed.distributed import make_fed_round as jmake

    params = jax.tree_util.tree_map(jnp.asarray, params_np[name])
    fr = jax.jit(jmake(_jax_model(name, mode), JFed(
        num_clients=K, local_steps=LOCAL_STEPS[mode], lr=LR, mode=mode,
        proposal_dtype="float32")))
    rep, rounds = jinit(K), []
    for rnd in range(VMAP_ROUNDS if mode == "vmap" else 1):
        params, rep, m = fr(params, rep, jnp.ones((K,), jnp.float32),
                            {k: jnp.asarray(v) for k, v in _batch(name, mode, rnd).items()})
        rounds.append({"agg": {p: np.asarray(t) for p, t in _paths(params).items()},
                       "decisions": (np.asarray(rep.alpha).tolist(),
                                     np.asarray(rep.beta).tolist(),
                                     np.asarray(rep.blocked).tolist(), float(m["good_frac"]),
                                     int(m["afa_rounds"]))})
    return rounds


def _jax_serve(name, lay, params_np):
    """The reference's jitted prefill and greedy decode of the case."""
    import jax
    import jax.numpy as jnp

    ring, size = lay == "ring", _size(name, lay)
    model = _jax_model(name)
    params = jax.tree_util.tree_map(jnp.asarray, params_np[name])
    prefill = jax.jit(model.prefill, static_argnames=("cache_size", "use_window"))
    decode = jax.jit(functools.partial(model.decode_step, ring=ring))

    def as_np(cache):
        return _cache_np(jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                                                cache))

    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
             for k, v in _prompts(name, lay).items()}
    logits, cache = prefill(params, batch, cache_size=size, use_window=ring)
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


def _jax_audio(params_np):
    import jax
    import jax.numpy as jnp

    model = _jax_model("audio")
    params = jax.tree_util.tree_map(jnp.asarray, params_np["audio"])
    batch = {"frame_embeds": jnp.asarray(_frames()["frame_embeds"]),
             "labels": jnp.asarray(_frames()["labels"], jnp.int32)}
    forward, loss = jax.jit(lambda p, b: (model.forward(p, b), model.loss_fn(p, b)[0]))(
        params, batch)
    return {"forward": np.asarray(forward), "loss": float(loss)}


# the reference's jobs in five processes, their compiles (~130 s on one
# thread) spread evenly over them
JAX_JOBS = [
    [("train", "hybrid", "remat"), ("serve", "ssm", "linear")],
    [("train", "hybrid", "vmap"), ("serve", "hybrid", "linear"), ("audio",)],
    [("train", "vlm", "vmap"), ("train", "ssm", "scan"), ("serve", "vlm", "linear")],
    [("train", "hybrid", "scan"), ("train", "ssm", "vmap"), ("serve", "hybrid", "ring")],
    [("train", "ssm", "remat"), ("train", "audio", "vmap"), ("serve", "vlm", "ring")],
]


@pytest.fixture(autouse=True, scope="module")
def _pool(tmp_path_factory):
    """The reference's jobs and the one-rank group, in a pool of their own
    processes started with the module's first test."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    store = tmp_path_factory.mktemp("one_rank") / "store"
    params = {name: _params(name) for name in ARCHS}
    with ProcessPoolExecutor(len(JAX_JOBS) + 1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        yield {"refs": [pool.submit(_jax_jobs, jobs, params) for jobs in JAX_JOBS],
               "one": pool.submit(_one_rank_job, params, str(store))}


@pytest.fixture(scope="module")
def runs(_pool):
    ranks = spawn(_grid_worker, 4, backend="gloo", device="cpu",
                  args=({name: _params(name) for name in ARCHS},))
    refs = {}
    for f in _pool["refs"]:
        refs.update(f.result())
    return {"ranks": ranks, "refs": refs, "one": _pool["one"].result()}


def _placed(coords):
    return tmesh.make_test_mesh(data=2, model=2).at(coords)


def _block(want: np.ndarray, spec, mesh) -> np.ndarray:
    return tsharding.take_shard(torch.from_numpy(want), spec, mesh).numpy()


def _close(got, want, msg, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def _rows(coords):
    d = coords["data"]
    return slice(d * (B // 2), (d + 1) * (B // 2))


# --------------------------------- training ---------------------------------


def _layer_reduces(cfg):
    """(forward, backward) all-reduces over ``model`` of one layer, and of
    the shared block where the model has one.  A Mamba-2 layer: its
    projection's gather, ``conv_w``'s gather and ``out_proj``'s sum
    forward; the gradients entering ``out_proj``'s block and the projection
    summed backward.  An attention block on whole heads: ``wo``'s sum and
    the MLP's forward, the gradients entering q, k, v and the MLP backward;
    where a head is cut, also the one gather of q, k and v forward and the
    output's gradient backward."""
    if cfg.family in ("ssm", "hybrid"):
        return (3, 2)
    cut = cfg.num_kv_heads % 2 != 0
    return (2 + cut, 2 + cut)


def _round_reduces(cfg, mode, passes) -> dict:
    """The all-reduces of one round on (data 2, model 2): a local step's
    forward sums the embedding (token families), gathers the frontend's
    projection (VLM, audio), each layer's and shared application's as
    ``_layer_reduces`` counts them, and the loss's max and (sum of
    exponentials, gold logit); its backward the layers' and the head's.  A
    vmap round trains its rank's 2 clients at once and then AFA: the row
    norms and a pass's dots over ``model``, a pass's weighted sum (a leaf
    each) and the similarities' gather over ``data``, and the final
    weighted sum.  Under FSDP (scan: K clients, remat: 3K) the leaves split
    over data and model, so AFA's sums run over both: the ``model`` count is
    the local steps'."""
    fwd, bwd = _layer_reduces(cfg)
    L = cfg.num_layers
    f, b = L * fwd, L * bwd
    if cfg.family == "hybrid":
        nseg, _, _ = hybrid_segments(cfg)
        f, b = f + 2 * nseg, b + 2 * nseg   # the shared block: whole heads
    step = (cfg.frontend == "none" or cfg.family == "vlm") + (cfg.frontend != "none") + f + 2 \
        + b + 1
    S = LOCAL_STEPS[mode]
    if mode != "vmap":
        return {"model": (K if mode == "scan" else 3 * K) * S * step}
    leaves = len(_paths(build_model(cfg).init(None, "meta")))
    return {"model": S * step + 1 + passes, "data": passes * (leaves + 1) + leaves}


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_grid_round_equals_the_reference(runs, case):
    want = runs["refs"][("train",) + case]
    for rank in runs["ranks"]:
        for rnd, (got, ref) in enumerate(zip(rank["train"][case], want)):
            assert got["decisions"] == ref["decisions"], (case, rnd, rank["coords"])
    for rnd, ref in enumerate(want):   # client 0 screened out, every round
        alpha, beta, blocked, good_frac, _ = ref["decisions"]
        assert good_frac == 0.75 and beta[0] == 4.0 + rnd and not any(blocked), (case, rnd)
    got = runs["ranks"][0]["train"][case]
    for rnd, (g, ref) in enumerate(zip(got, want)):
        for path, w in ref["agg"].items():
            np.testing.assert_allclose(g["agg"][path], w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} round {rnd} {path}")


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_each_rank_holds_its_spec_blocks(runs, case):
    """Every rank's drawn weights are the one-card draw's blocks under the
    reference's specs (``fsdp=True`` for scan and remat): ``in_proj`` and
    ``conv_w`` by column and ``out_proj`` by row over ``model``, the
    frontend's projection by column, the shared block's leaves as a dense
    block's."""
    name, mode = case
    cfg = _cfg(name, mode)
    full = _paths(build_model(cfg).init(None, "meta"))
    specs = _paths(tsharding.shard_params_tree(_unpaths(full), _placed({"data": 0, "model": 0}),
                                               fsdp=mode != "vmap"))
    for rank in runs["ranks"]:
        held = rank["held"][(name, "scan" if mode == "remat" else mode)]
        assert held["init_is_the_block"], (case, rank["coords"])
        for path, t in full.items():
            spec = specs[path] + (None,) * (t.ndim - len(specs[path]))
            want = tuple(n // (1 if e is None else 2) for n, e in zip(t.shape, spec))
            assert held["shapes"][path] == want, (case, path)
    on_model = {p for p, s in specs.items() if tsharding.uses_axis(s, "model")}
    must = {"ssm": {"layers/mamba/in_proj", "layers/mamba/conv_w", "layers/mamba/out_proj"},
            "vlm": {"frontend_proj"}, "audio": {"frontend_proj"}}.get(name, set())
    if name == "hybrid":
        must = {"layers/mamba/in_proj", "shared/attn/wq", "shared/attn/wo", "shared/mlp/down"}
    assert must <= on_model, sorted(on_model)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_all_reduces_a_round(runs, case):
    name, mode = case
    cfg = _cfg(name, mode)
    for rank in runs["ranks"]:
        for got in rank["train"][case]:
            want = _round_reduces(cfg, mode, got["decisions"][4])
            counts = got["all_reduces"] if mode == "vmap" else {
                "model": got["all_reduces"].get("model", 0)}
            assert counts == want, (case, rank["coords"])


# --------------------------------- serving ----------------------------------


def _decode_reduces(cfg, size) -> dict:
    """The all-reduces over ``model`` of one decode step: the embedding's
    sum and the head's gather; a Mamba-2 layer's projection and ``conv_w``
    gathers, its ``y`` summed over the state's N blocks and ``out_proj``'s
    sum; a shared application on whole heads ``wo``'s and the MLP's sums;
    a paligemma layer the one gather of q, k and v, ``wo``'s and the MLP's
    sums and, on a slot-split cache, the softmax merge's ``pmax`` and
    packed ``psum``."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        per = 4 * L
    elif cfg.family == "hybrid":
        per = 4 * L + 2 * hybrid_segments(cfg)[0]
    else:
        per = L * (3 + 2 * (size % 2 == 0))
    return {"model": 2 + per}


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_grid_serving_equals_the_reference(runs, case):
    ref = runs["refs"][("serve",) + case]
    assert min(ref["margins"]) > 1e-4, "a greedy tie would decide the tokens"
    for rank in runs["ranks"]:
        got, rows = rank["serve"][case], _rows(rank["coords"])
        for t, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            _close(g, w[rows], f"{case} rank {rank['coords']} logits step {t}")
        for g, w in zip(got["tokens"], ref["tokens"]):
            np.testing.assert_array_equal(g, w[rows])
        np.testing.assert_array_equal(got["generate_tokens"],
                                      np.stack(ref["tokens"], axis=1)[rows])
        assert got["all_reduces"] == _decode_reduces(_cfg(case[0]), _size(*case)), case


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_each_rank_holds_its_cache_pspec_block(runs, case):
    """After the prefill and after the last decode step each rank's cache
    is the reference cache's block under ``cache_pspec``: an SSM state's N
    block over model (dim 3 of (L, B, H, N, P)), its conv window whole over
    model, zamba2's shared caches' kv heads, paligemma's slots; the rows
    over data.  The state and the shared caches within 1e-5 of each leaf's
    largest magnitude (the SSD's f32 sums carry a few ulps)."""
    ref = runs["refs"][("serve",) + case]
    for rank in runs["ranks"]:
        mesh = _placed(rank["coords"])
        for when in ("prefill_cache", "cache"):
            want = ref[when]
            specs = _whole_specs(want, mesh)
            got = rank["serve"][case][when]
            assert sorted(got) == sorted(want)
            for path, w in want.items():
                block = _block(w, specs[path], mesh)
                assert got[path].shape == block.shape, (case, when, path)
                if path == "pos":
                    np.testing.assert_array_equal(got[path], block)
                else:
                    _close(got[path], block, f"{case} rank {rank['coords']} {when} {path}",
                           TOL * max(1.0, float(np.abs(w).max())))
    specs = _whole_specs(ref["cache"], _placed({"data": 0, "model": 0}))
    if case[0] in ("ssm", "hybrid"):
        assert specs["layers/state"] == (None, "data", None, "model", None)
        assert specs["layers/conv"] == (None, "data", None, None)
    if case[0] == "hybrid":
        assert specs["shared/0"] == (None, "data", None, "model", None)
    if case[0] == "vlm":
        assert specs["layers/0"] == (None, "data", "model", None, None)


def test_audio_forward_and_loss_equal_the_reference(runs):
    want = runs["refs"][("audio",)]
    for rank in runs["ranks"]:
        got = rank["audio"]
        _close(got["forward"], want["forward"], f"hubert forward rank {rank['coords']}")
        _close(got["loss"], want["loss"], "hubert loss")
        assert "encoder-only" in got["decode"]


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_build_step_on_a_grid_model(runs, name):
    """``input_specs(model, "decode_32k", grid, device="cpu")`` gives each
    rank its block of the one-card bundle's seeded cache bit for bit (an SSM
    state's N block drawn alone) and its rows of the tokens, and the grid's
    decode step the one-card step's logits on its rows and its block of the
    cache the step wrote (within 1e-5 of each leaf's largest magnitude)."""
    for rank in runs["ranks"]:
        got = rank["steps"][name]
        assert all(got["seeded_is_the_block"].values()), (name, got["seeded_is_the_block"])
        assert max(got["written_off"].values()) <= TOL, (name, got["written_off"])
        rows = slice(rank["coords"]["data"], rank["coords"]["data"] + 1)
        np.testing.assert_array_equal(got["tokens"], got["one_tokens"][rows])
        _close(got["decode"], got["one_decode"][rows], f"{name} decode rank {rank['coords']}")
    specs = runs["ranks"][0]["steps"][name]["specs"]
    if name == "vlm":
        assert specs["layers/0"] == (None, "data", "model", None, None)
    else:
        assert specs["layers/state"] == (None, "data", None, "model", None)


def test_one_rank_grid_is_one_card_bit_for_bit(runs):
    out, counts = runs["one"]
    for name in ONE_RANK:
        (grid_run, card_run) = out[name]
        for a, b in zip(grid_run[0], card_run[0]):
            np.testing.assert_array_equal(a, b)
        for part in (1, 2):
            for path, want in card_run[part].items():
                np.testing.assert_array_equal(grid_run[part][path], want, err_msg=path)
        for a, b in zip(grid_run[3:], card_run[3:]):
            np.testing.assert_array_equal(a, b)
    assert counts == {}


@pytest.mark.parametrize("arch,split", [("zamba2-1.2b", "heads"), ("paligemma-3b", "slots")])
def test_rank_blocks_at_decode_32k_are_rank_bytes(arch, split):
    """On ``meta``: the arguments a rank of a (data 2, model 2) grid holds
    at ``decode_32k`` (a grid model's ``input_specs``) take exactly
    ``rank_bytes`` of the whole bundle under ``arg_specs``: zamba2-1.2b's
    shared caches (206.2 GB whole) a quarter, by row and kv head, its SSM
    state by row and N; paligemma-3b's cache (77.3 GB whole) a quarter, by
    row and slot."""
    cfg = get_config(arch)
    mesh = _placed({"data": 1, "model": 1})
    whole = tspecs.input_specs(build_model(cfg), "decode_32k", mesh)
    mine = tspecs.input_specs(build_model(cfg, grid=mesh), "decode_32k", mesh)
    want = tspecs.rank_bytes(whole.args, tspecs.arg_specs(cfg, whole, mesh), mesh)
    held = sum(t.numel() * t.element_size() for t in _leaves(mine.args))
    assert held == want

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    key = "shared" if split == "heads" else "layers"
    kv_whole, kv_mine = whole.args[1][key], mine.args[1][key]
    assert nbytes(kv_mine) * 4 == nbytes(kv_whole)   # rows over data, heads or slots over model
    assert round(nbytes(kv_whole) / 1e9, 1) == {"zamba2-1.2b": 206.2, "paligemma-3b": 77.3}[arch]
    dim = 3 if split == "heads" else 2
    assert kv_mine[0].shape[1] == kv_whole[0].shape[1] // 2
    assert kv_mine[0].shape[dim] == kv_whole[0].shape[dim] // 2
    if split == "heads":   # the SSM state's N, and the conv window whole over model
        layers_whole, layers_mine = whole.args[1]["layers"], mine.args[1]["layers"]
        assert layers_mine["state"].shape[3] * 2 == layers_whole["state"].shape[3]
        assert layers_mine["conv"].shape[2:] == layers_whole["conv"].shape[2:]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
