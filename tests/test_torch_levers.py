"""The reference's three mesh levers on the port's data x model grid, on the
CPU, against the JAX package (4 gloo ranks of a (data 2, model 2) grid,
spawned once for the module; every case's ``model`` axis has 2 ranks):

* ``activation_sharding``: a reduced paligemma-3b (4 q heads, one kv head,
  which the axis cuts) attends on each rank's 2 q heads with k and v
  repeated to them; reduced mamba2-1.3b and zamba2-1.2b run the SSD on each
  rank's half of their 4 and 8 heads (``models/ssm.py``);
* ``seq_par_attention``: a smollm-like model with 3 q and 3 kv heads (the
  axis cuts one) attends with each rank's block of the query blocks;
* ``fsdp_activations``: a dense and an MoE model split each client's rows
  over ``model`` (beside the data axes under FSDP), every leaf gathered
  whole at its use, in ``vmap`` and, where the lever meets FSDP, ``scan``
  and ``remat`` (the dense model) or ``scan`` (the MoE);

each case's round (K = 4, client 0 byzantine) held to the reference's
single-device jitted ``make_fed_round`` of the same config and mode, and to
the same grid's round with the lever off: the posteriors, blocked bits,
good_frac and AFA rounds equal on every rank, the aggregate within 2e-4 /
2e-5 (``tests/test_torch_grid_families.py``'s f32 bounds); each case's
forward within 1e-5 of the reference's and of the lever-off grid's
(``seq_par_attention``'s bit for bit: each query block is computed as
without the lever).  Then:

* where the sizes do not divide (3 q heads, one query block, one SSD head,
  2 rows over data x model), a lever changes nothing: the forward and the
  loss's gradients equal the lever-off grid's bit for bit; so on one card
  (no grid: forward, gradients and prefill) and in a prefill on the grid
  (logits and cache), where the port takes no lever;
* ``flash_attention(parallel_q=True)`` is the loop over the query blocks
  bit for bit, within 1e-6 of the reference's ``parallel_q`` attention
  (causal, prefix-LM, full, ``q_offset``, a ragged last block);
* under ``fsdp_activations`` no gathered leaf outlives the loss's forward:
  autograd saves the rank's blocks, and the backward gathers them again
  over ``model``;
* per rank, traced with ``repro_torch.analysis.trace``: the attention's
  ``dot_flops`` (the ``"attention"`` spans) fall by m = 2 under
  ``activation_sharding`` on the cut head and under ``seq_par_attention``,
  the SSD's per-head products (the ``"ssd"`` spans, less the heads' shared
  C . B products) by 2; the forward's collectives by kind and axes
  (``launch.mesh.recording()``): under ``fsdp_activations`` no all-reduce
  over ``model``, only one bucketed all-gather a layer (and the embedding's
  and the head's).

The reference's rounds and forwards run in a pool of single-thread
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
from repro_torch.launch.shards import spawn  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402

K, SEQ, B, LR = 4, 16, 4, 0.05
LOCAL_STEPS = {"vmap": 2, "scan": 2, "remat": 1}
ROWS = {"vmap": 2, "scan": 4, "remat": 4}   # a client's rows: 1 a rank over model (x data)
RTOL, ATOL = 2e-4, 2e-5        # tests/test_torch_grid_families.py's f32 rounds
TOL = 1e-5
M = 2                          # the grid's model axis
F32 = dict(param_dtype="float32", compute_dtype="float32", fed_clients=K)
TINY = dict(d_model=64, vocab_size=64, block_q=16, block_k=16, **F32)
DENSE = dict(name="smollm-levers", family="dense", num_layers=2, num_heads=4, num_kv_heads=2,
             d_ff=128, **TINY)
MOE = dict(name="olmoe-levers", family="moe", num_layers=2, num_heads=4, num_kv_heads=4,
           d_ff=64, num_experts=4, top_k=2, **TINY)
# 3 q and 3 kv heads of 16: a model axis of 2 cuts a head and not the q heads
CUT = dict(DENSE, name="smollm-cut", num_heads=3, num_kv_heads=3, head_dim=16, block_q=8,
           block_k=8)


def _family(arch, **kw) -> dict:
    cfg = get_config(arch).reduced().with_(**TINY, **kw)
    return dataclasses.asdict(cfg)


def _configs():
    return {
        "vlm": _family("paligemma-3b", head_dim=16, d_ff=128, frontend_dim=64),
        "ssm": _family("mamba2-1.3b", ssm_chunk=8, ssm_head_dim=32),
        "hybrid": _family("zamba2-1.2b", head_dim=16, d_ff=128, ssm_chunk=8, ssm_head_dim=16),
        "cut": CUT, "dense": DENSE, "moe": MOE,
        # the sizes that do not divide: one query block, one SSD head
        "cut-one-block": dict(CUT, block_q=16),
        "ssm-one-head": _family("mamba2-1.3b", ssm_chunk=8, ssm_head_dim=128),
    }


CONFIGS = _configs()
# (config, lever, mode)
TRAIN_CASES = [("vlm", "activation_sharding", "vmap"), ("ssm", "activation_sharding", "vmap"),
               ("hybrid", "activation_sharding", "vmap"), ("cut", "seq_par_attention", "vmap"),
               ("dense", "fsdp_activations", "vmap"), ("dense", "fsdp_activations", "scan"),
               ("dense", "fsdp_activations", "remat"), ("moe", "fsdp_activations", "vmap"),
               ("moe", "fsdp_activations", "scan")]
TRAIN_IDS = ["-".join(c) for c in TRAIN_CASES]
FORWARD_CASES = sorted({(name, lever) for name, lever, _ in TRAIN_CASES})
FORWARD_IDS = ["-".join(c) for c in FORWARD_CASES]
# (config, lever, mode, rows): the lever on sizes it does not divide
INERT_CASES = [("cut", "activation_sharding", "vmap", 2),
               ("cut-one-block", "seq_par_attention", "vmap", 2),
               ("ssm-one-head", "activation_sharding", "vmap", 2),
               ("dense", "fsdp_activations", "scan", 2)]
INERT_IDS = ["-".join(map(str, c)) for c in INERT_CASES]
# (config, lever): one card, and a prefill on the grid, take no lever
PLAIN_CASES = [("cut", "seq_par_attention"), ("vlm", "activation_sharding"),
               ("ssm", "activation_sharding"), ("dense", "fsdp_activations")]
PLAIN_IDS = ["-".join(c) for c in PLAIN_CASES]
# (config, mode): a loss's gathered leaves under fsdp_activations
REGATHER_CASES = [("dense", "vmap"), ("moe", "scan")]
REGATHER_IDS = ["-".join(c) for c in REGATHER_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, lever=None, mode="vmap"):
    cfg = ModelConfig(**CONFIGS[name]).with_(fed_mode=mode)
    return cfg.with_(**{lever: True}) if lever else cfg


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
    """Seeded numpy weights: a matrix normal / sqrt(its second-to-last
    dim), the embedding and head at 0.02; Mamba-2's ``A_log`` near
    log(1..H), ``D`` near 1; the other vectors small normals."""
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
        elif len(shape) - path.startswith("layers/") < 2:
            flat[path] = 0.1 * noise
        else:
            scale = 0.02 if path in ("embed", "head") else shape[-2] ** -0.5
            flat[path] = scale * noise
    return _unpaths({p: v.astype(np.float32) for p, v in flat.items()})


def _inputs(cfg, lead, seed):
    """Tokens and labels (and a VLM's patches) of shape ``lead + (SEQ,)``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            lead + (cfg.prefix_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _batch(name, mode, rows=None):
    """(K, S, rows, ...) client data; client 0 gets the train CLI's attack
    (zeros); row 0 of every other client masks 5 of its labels, so the
    ranks that split the rows count different labels."""
    cfg = _cfg(name)
    out = _inputs(cfg, (K, LOCAL_STEPS[mode], rows or ROWS[mode]), 10)
    for v in out.values():
        v[0] = 0
    out["labels"][1:, :, 0, 11:] = -1
    return out


def _forward_batch(name):
    return _inputs(_cfg(name), (B,), 20)


# ------------------------------- the 4 ranks --------------------------------


def _placed(grid, name, mode, params_np):
    from repro_torch.convert import model_params_from_numpy

    whole = model_params_from_numpy(params_np, device="cpu")
    specs = tsharding.shard_params_tree(whole, grid, fsdp=mode != "vmap")
    return tsharding.shard_tree(whole, grid, specs), specs


def _round(grid, name, lever, mode, params_np):
    """The case's round on this rank, the lever on or off: the aggregate
    gathered whole, the decisions, the collectives by kind."""
    from repro_torch.core import init_reputation
    from repro_torch.fed.distributed import FedRoundConfig, make_fed_round

    model = build_model(_cfg(name, lever, mode), grid=grid)
    params, specs = _placed(grid, name, mode, params_np)
    batch = {k: torch.from_numpy(v) for k, v in _batch(name, mode).items()}
    if mode == "vmap":   # the clients ride the data rows
        batch = {k: v[grid.block(K, "data")] for k, v in batch.items()}
    fed_round = make_fed_round(model, FedRoundConfig(
        num_clients=K, local_steps=LOCAL_STEPS[mode], lr=LR, mode=mode,
        proposal_dtype="float32", client_axes=("data",) if mode == "vmap" else None), grid=grid)
    with tmesh.recording() as log:
        agg, rep, m = fed_round(params, init_reputation(K, device="cpu"), torch.ones(K), batch)
    return {"agg": {p: t.numpy() for p, t in
                    _paths(tsharding.unshard_tree(agg, grid, specs)).items()},
            "decisions": (rep.alpha.tolist(), rep.beta.tolist(), rep.blocked.tolist(),
                          float(m["good_frac"]), int(m["afa_rounds"])),
            "collectives": _kinds(log)}


def _kinds(log) -> dict:
    """(kind, axes) -> count of a recorded call's collectives."""
    out = {}
    for c in log:
        key = (c.kind, "+".join(c.axes))
        out[key] = out.get(key, 0) + 1
    return out


def _forward(grid, name, lever, params_np):
    """The forward of the case's batch on this rank, the lever on or off:
    the whole logits, the dot FLOPs of its attention and SSD spans and its
    collectives."""
    from repro_torch.analysis.trace import recording, region_label

    model = build_model(_cfg(name, lever), grid=grid)
    params, _ = _placed(grid, name, "vmap", params_np)
    batch = {k: torch.from_numpy(v) for k, v in _forward_batch(name).items()}
    with torch.no_grad(), recording() as rec:
        logits = model.forward(params, batch)
    flops = {"attention": 0, "ssd": 0}
    for op in rec.ops:
        for label in {region_label(r) for r in op.regions} & set(flops):
            flops[label] += op.flops
    return {"logits": logits.numpy(), "flops": flops, "collectives": _kinds(rec.collectives)}


def _grads(grid, name, lever, mode, rows, params_np):
    """The forward and the loss's gradients of one client step on this
    rank, the lever on or off."""
    model = build_model(_cfg(name, lever, mode), grid=grid)
    params, _ = _placed(grid, name, mode, params_np)
    mb = {k: torch.from_numpy(v[1, 0]) for k, v in _batch(name, mode, rows).items()}
    leaves = _paths(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = model.loss_fn(_unpaths(leaves), mb)[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        logits = model.forward(params, mb)
    return [logits, loss.detach()] + [g.detach() for g in grads]


def _prefill(grid, name, lever, params_np):
    """The prefill of the forward batch on this rank (or with no grid), the
    lever on or off: the last position's logits and the cache's leaves."""
    model = build_model(_cfg(name, lever), grid=grid)
    if grid is None:
        from repro_torch.convert import model_params_from_numpy

        params = model_params_from_numpy(params_np, device="cpu")
    else:
        params, _ = _placed(grid, name, "vmap", params_np)
    batch = {k: torch.from_numpy(v) for k, v in _forward_batch(name).items()
             if k != "labels"}
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cache_size=2 * SEQ)
    return [logits] + _tensors(cache)


def _tensors(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in _tensors(item)]


def _regather(grid, name, mode, params_np):
    """One local step's loss under ``fsdp_activations`` on this rank (of
    clients 1 and 2 under ``torch.func.vmap`` in ``vmap``, of client 1 in
    ``scan``): the gathered leaves still registered once its forward has
    returned, the elements autograd saved as blocks to gather again, and
    the backward's collectives."""
    from repro_torch.models import layers

    model = build_model(_cfg(name, "fsdp_activations", mode), grid=grid)
    params, _ = _placed(grid, name, mode, params_np)
    batch = {k: torch.from_numpy(v[1:3, 0]) for k, v in _batch(name, mode).items()}
    leaves = {p: t.expand((2,) + t.shape).clone() for p, t in _paths(params).items()}
    for t in leaves.values():
        t.requires_grad_(True)

    def loss_of(tree, mb):
        return model.loss_fn(tree, mb)[0]

    if mode == "vmap":
        loss_of = torch.func.vmap(loss_of)
    else:
        leaves = {p: t[0] for p, t in leaves.items()}
        batch = {k: v[0] for k, v in batch.items()}
    pack, regathered = layers._pack, [0]

    def counted(t):
        out = pack(t)
        regathered[0] += 0 if isinstance(out, torch.Tensor) else t.numel()
        return out

    layers._pack = counted
    try:
        loss = loss_of(_unpaths(leaves), batch).sum()
    finally:
        layers._pack = pack
    alive = sum(map(len, layers._GATHERED.values()))
    with tmesh.recording() as log:
        torch.autograd.grad(loss, list(leaves.values()))
    return {"alive": alive, "regathered": regathered[0], "backward": _kinds(log)}


def _grid_worker(params_np):
    """On each of 4 gloo ranks of a (data 2, model 2) grid: every case.
    Returns every rank's results."""
    import torch.distributed as dist

    torch.set_num_threads(1)   # the ranks and the reference's processes share the cores
    grid = tmesh.make_grid_mesh(tmesh.make_test_mesh(data=2, model=2), "cpu")
    mine = {"coords": dict(grid.coords), "train": {}, "forward": {}, "inert": {}, "prefill": {},
            "regather": {}}
    for name, lever, mode in TRAIN_CASES:
        mine["train"][(name, lever, mode)] = {
            on: _round(grid, name, lever if on else None, mode, params_np[name])
            for on in (True, False)}
    for name, lever in FORWARD_CASES:
        mine["forward"][(name, lever)] = {
            on: _forward(grid, name, lever if on else None, params_np[name])
            for on in (True, False)}
    for name, lever, mode, rows in INERT_CASES:
        on, off = (_grads(grid, name, lever if lever_on else None, mode, rows, params_np[name])
                   for lever_on in (True, False))
        mine["inert"][(name, lever, mode, rows)] = all(torch.equal(a, b) for a, b in zip(on, off))
    for name, lever in PLAIN_CASES:
        on, off = (_prefill(grid, name, lever if lever_on else None, params_np[name])
                   for lever_on in (True, False))
        mine["prefill"][(name, lever)] = all(torch.equal(a, b) for a, b in zip(on, off))
    for name, mode in REGATHER_CASES:
        mine["regather"][(name, mode)] = _regather(grid, name, mode, params_np[name])
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    dist.barrier()
    return ranks


# ------------------------------ the reference ------------------------------


def _jax_jobs(jobs, params_np):
    """The reference's side of ``jobs`` (("train", name, lever, mode),
    ("forward", name, lever) or ("attention", case)) in one process of one
    XLA thread, at the lowest scheduling priority."""
    import os

    os.nice(19)
    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    fns = {"train": _jax_train, "forward": _jax_forward, "attention": _jax_attention}
    return {job: fns[job[0]](*job[1:], params_np) for job in jobs}


# (B, Lq, Lk, Hq, Hkv, block_q, block_k, causal, prefix_len, q_offset): causal,
# prefix-LM, full with a ragged last block, a query block past its keys
ATTN_CASES = [(2, 40, 40, 4, 2, 16, 16, True, 0, 0), (1, 64, 64, 3, 3, 16, 32, True, 5, 0),
              (2, 37, 37, 4, 1, 8, 16, False, 0, 0), (1, 32, 64, 2, 2, 8, 16, True, 0, 32)]


def _attn_inputs(case):
    b, lq, lk, hq, hkv, bq, bk, causal, prefix, offset = ATTN_CASES[case]
    rng = np.random.default_rng(7 + case)
    q, k, v = (rng.standard_normal((b, n, h, 8)).astype(np.float32)
               for n, h in ((lq, hq), (lk, hkv), (lk, hkv)))
    return q, k, v, dict(causal=causal, prefix_len=prefix, q_offset=offset, block_q=bq,
                         block_k=bk)


def _jax_attention(case, params_np):
    import jax.numpy as jnp

    from repro.models.attention import flash_attention as jflash

    q, k, v, kw = _attn_inputs(case)
    return np.asarray(jflash(*map(jnp.asarray, (q, k, v)), parallel_q=True, **kw))


def _jax_model(name, lever, mode="vmap"):
    from repro.models import ModelConfig as JCfg
    from repro.models import build_model as jbuild

    return jbuild(JCfg(**dataclasses.asdict(_cfg(name, lever, mode))))


def _jax_train(name, lever, mode, params_np):
    import jax
    import jax.numpy as jnp

    from repro.core.reputation import init_reputation as jinit
    from repro.fed.distributed import FedRoundConfig as JFed
    from repro.fed.distributed import make_fed_round as jmake

    params = jax.tree_util.tree_map(jnp.asarray, params_np[name])
    fr = jax.jit(jmake(_jax_model(name, lever, mode), JFed(
        num_clients=K, local_steps=LOCAL_STEPS[mode], lr=LR, mode=mode,
        proposal_dtype="float32")))
    params, rep, m = fr(params, jinit(K), jnp.ones((K,), jnp.float32),
                        {k: jnp.asarray(v) for k, v in _batch(name, mode).items()})
    return {"agg": {p: np.asarray(t) for p, t in _paths(params).items()},
            "decisions": (np.asarray(rep.alpha).tolist(), np.asarray(rep.beta).tolist(),
                          np.asarray(rep.blocked).tolist(), float(m["good_frac"]),
                          int(m["afa_rounds"]))}


def _jax_forward(name, lever, params_np):
    import jax
    import jax.numpy as jnp

    model = _jax_model(name, lever)
    params = jax.tree_util.tree_map(jnp.asarray, params_np[name])
    batch = {k: jnp.asarray(v) for k, v in _forward_batch(name).items()}
    return np.asarray(jax.jit(model.forward)(params, batch))


# the reference's jobs in five processes, their compiles (~80 s on one
# thread) spread evenly over them
JAX_JOBS = [
    [("train", "vlm", "activation_sharding", "vmap"), ("train", "dense", "fsdp_activations", "scan")],
    [("train", "hybrid", "activation_sharding", "vmap"), ("forward", "vlm", "activation_sharding"),
     ("attention", 0)],
    [("train", "dense", "fsdp_activations", "remat"), ("train", "cut", "seq_par_attention", "vmap"),
     ("forward", "cut", "seq_par_attention")],
    [("train", "moe", "fsdp_activations", "vmap"), ("train", "ssm", "activation_sharding", "vmap"),
     ("attention", 1)],
    [("train", "moe", "fsdp_activations", "scan"), ("train", "dense", "fsdp_activations", "vmap"),
     ("forward", "ssm", "activation_sharding"), ("forward", "dense", "fsdp_activations"),
     ("forward", "hybrid", "activation_sharding"), ("forward", "moe", "fsdp_activations"),
     ("attention", 2), ("attention", 3)],
]


@pytest.fixture(autouse=True, scope="module")
def _pool():
    """The reference's jobs, in a pool of their own processes started with
    the module's first test."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    params = {name: _params(name) for name in CONFIGS}
    with ProcessPoolExecutor(len(JAX_JOBS),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        yield [pool.submit(_jax_jobs, jobs, params) for jobs in JAX_JOBS]


@pytest.fixture(scope="module")
def runs(_pool):
    ranks = spawn(_grid_worker, 4, backend="gloo", device="cpu",
                  args=({name: _params(name) for name in CONFIGS},))
    refs = {}
    for f in _pool:
        refs.update(f.result())
    return {"ranks": ranks, "refs": refs}


def _close(got, want, msg, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


# --------------------------------- the tests --------------------------------


def test_the_jobs_cover_every_case():
    jobs = {job for jobs in JAX_JOBS for job in jobs}
    assert jobs == ({("train",) + c for c in TRAIN_CASES}
                    | {("forward",) + c for c in FORWARD_CASES}
                    | {("attention", i) for i in range(len(ATTN_CASES))})


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_lever_round_equals_the_reference_and_the_lever_off_grid(runs, case):
    want = runs["refs"][("train",) + case]
    alpha, beta, blocked, good_frac, _ = want["decisions"]
    assert good_frac == 0.75 and beta[0] == 4.0 and not any(blocked), case  # client 0 out
    for rank in runs["ranks"]:
        got = rank["train"][case]
        assert got[True]["decisions"] == want["decisions"], (case, rank["coords"])
        assert got[False]["decisions"] == want["decisions"], (case, rank["coords"])
    got = runs["ranks"][0]["train"][case]
    for path, w in want["agg"].items():
        _close(got[True]["agg"][path], w, f"{case} {path} vs the reference", RTOL, ATOL)
        _close(got[True]["agg"][path], got[False]["agg"][path],
               f"{case} {path} vs the lever-off grid", RTOL, ATOL)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=FORWARD_IDS)
def test_lever_forward_equals_the_reference_and_the_lever_off_grid(runs, case):
    want = runs["refs"][("forward",) + case]
    for rank in runs["ranks"]:
        got = rank["forward"][case]
        _close(got[True]["logits"], want, f"{case} rank {rank['coords']} vs the reference")
        _close(got[True]["logits"], got[False]["logits"], f"{case} vs the lever-off grid")
        if case[1] == "seq_par_attention":   # each query block as without the lever
            np.testing.assert_array_equal(got[True]["logits"], got[False]["logits"])


@pytest.mark.parametrize("case", INERT_CASES, ids=INERT_IDS)
def test_a_lever_changes_no_bit_where_the_sizes_do_not_divide(runs, case):
    for rank in runs["ranks"]:
        assert rank["inert"][case], (case, rank["coords"])


def _ssd_shared_flops(cfg) -> int:
    """The SSD's C . B products of a forward, the same on every head: 2 b
    nc q^2 N a layer."""
    chunks = -(-SEQ // cfg.ssm_chunk)
    return cfg.num_layers * 2 * B * chunks * cfg.ssm_chunk ** 2 * cfg.ssm_state


@pytest.mark.parametrize("case", FORWARD_CASES, ids=FORWARD_IDS)
def test_per_rank_work_falls_by_the_model_axis(runs, case):
    """The traced dot FLOPs of each rank's attention and SSD spans: cut by
    m where the lever splits them, the same bits of work elsewhere."""
    name, lever = case
    cfg = _cfg(name, lever)
    for rank in runs["ranks"]:
        on, off = (rank["forward"][case][x]["flops"] for x in (True, False))
        if name in ("vlm", "cut"):
            assert off["attention"] > 0 and on["attention"] * M == off["attention"], (case, on, off)
        elif name in ("ssm", "hybrid"):
            shared = _ssd_shared_flops(cfg)
            assert off["ssd"] > shared
            assert (on["ssd"] - shared) * M == off["ssd"] - shared, (case, on, off, shared)
            assert on["attention"] == off["attention"]   # zamba2's shared block: whole heads
        else:   # fsdp_activations: each rank's rows, all heads
            assert on == off, (case, on, off)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=FORWARD_IDS)
def test_the_forwards_collectives_by_kind(runs, case):
    """A forward's collectives on a rank (kind, axes): under
    ``fsdp_activations`` no all-reduce over ``model`` in the dense model
    (the MoE sums its router's statistics over the rows), one bucketed
    all-gather a layer and one each for the embedding and the head; under
    ``activation_sharding`` on the cut head one all-gather of k and v a
    layer in place of the all-reduce that gathers q, k and v; under
    ``seq_par_attention`` the q, k and v gather and the output rows'
    gather a layer; in Mamba-2 the projection's and ``conv_w``'s gathers
    become all-gathers and the norm's mean square one more sum."""
    name, lever = case
    cfg = _cfg(name, lever)
    L = cfg.num_layers
    for rank in runs["ranks"]:
        on, off = (rank["forward"][case][x]["collectives"] for x in (True, False))
        if name == "dense":
            assert not any(axes == "model" and kind == "psum" for kind, axes in on), on
            assert off[("psum", "model")] >= 2 * L, off
            assert on[("all_gather", "model")] == L + 2, on
        elif name == "moe":
            assert on[("psum", "model")] == L, on   # the router's sums, a layer
            assert on[("all_gather", "model")] == L + 2, on
        elif name == "vlm":
            assert on.get(("all_gather", "model")) == L, on
            assert off[("gather", "model")] - on[("gather", "model")] == L, (on, off)
        elif name == "cut":
            assert on.get(("all_gather", "model")) == 2 * L, on
            assert off[("gather", "model")] - on[("gather", "model")] == L, (on, off)
        else:   # ssm, hybrid
            assert on.get(("all_gather", "model")) == 2 * L, on
            assert off[("gather", "model")] - on.get(("gather", "model"), 0) == 2 * L, (on, off)
            assert on[("psum", "model")] - off[("psum", "model")] == L, (on, off)


def test_fsdp_activations_round_gathers_instead_of_reducing(runs):
    """Over a round, ``fsdp_activations`` trades the tensor-parallel
    all-reduces over ``model`` for all-gathers and reduce-scatters: under
    ``scan`` every gather runs over data and model together."""
    for rank in runs["ranks"]:
        for mode in ("vmap", "scan"):
            on, off = (rank["train"][("dense", "fsdp_activations", mode)][x]["collectives"]
                       for x in (True, False))
            gather_axes = "model" if mode == "vmap" else "data+model"
            assert on[("all_gather", gather_axes)] > 0 and on[("reduce_scatter", gather_axes)] > 0
            assert on.get(("psum", "model"), 0) < off[("psum", "model")], (mode, on, off)


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_parallel_q_is_the_loop_and_the_references_attention(runs, case):
    from repro_torch.models.attention import flash_attention

    q, k, v, kw = _attn_inputs(case)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), parallel_q=True, **kw).numpy()
    loop = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    np.testing.assert_array_equal(got, loop)
    _close(got, runs["refs"][("attention", case)], f"{ATTN_CASES[case]} vs the reference's "
           "parallel_q", 1e-6, 1e-6)


@pytest.mark.parametrize("case", PLAIN_CASES, ids=PLAIN_IDS)
def test_one_card_takes_no_lever(case):
    """With no grid a lever changes no bit: the forward, the loss's
    gradients and the prefill (``seq_par_attention``'s 2 query blocks run
    as the loop runs them)."""
    from repro_torch.convert import model_params_from_numpy

    name, lever = case
    out = {}
    for on in (True, False):
        model = build_model(_cfg(name, lever if on else None))
        leaves = _paths(model_params_from_numpy(_params(name), device="cpu"))
        for t in leaves.values():
            t.requires_grad_(True)
        mb = {k: torch.from_numpy(v) for k, v in _forward_batch(name).items()}
        loss = model.loss_fn(_unpaths(leaves), mb)[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            logits = model.forward(_unpaths(leaves), mb)
        out[on] = [logits, loss.detach(), *grads] + _prefill(None, name, lever if on else None,
                                                              _params(name))
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False])), case


@pytest.mark.parametrize("case", PLAIN_CASES, ids=PLAIN_IDS)
def test_a_prefill_on_the_grid_takes_no_lever(runs, case):
    for rank in runs["ranks"]:
        assert rank["prefill"][case], (case, rank["coords"])


@pytest.mark.parametrize("case", REGATHER_CASES, ids=REGATHER_IDS)
def test_fsdp_activations_saves_blocks_and_gathers_them_again(runs, case):
    """No gathered leaf is left once the loss's forward returns: what
    autograd saved of them (every product's weight: at least each layer's
    matrices but the router's, and the head, for each client) is kept as
    the rank's blocks, and the backward gathers them again over ``model``
    (with data under FSDP)."""
    name, mode = case
    cfg = _cfg(name)
    clients = 2 if mode == "vmap" else 1
    leaves = _paths(_params(name))
    products = sum(v.size for p, v in leaves.items() if p == "head" or (
        p.startswith("layers/") and v.ndim >= 3 and not p.endswith("router")))
    axes = "model" if mode == "vmap" else "data+model"
    for rank in runs["ranks"]:
        got = rank["regather"][case]
        assert got["alive"] == 0, (case, got)
        assert got["regathered"] >= clients * products, (case, got, products)
        assert got["backward"].get(("all_gather", axes), 0) > cfg.num_layers, (case, got)


def test_the_dry_runs_per_rank_costs_take_the_levers():
    """``launch.dryrun.count_rank`` on meta, a (data 2, model 2) mesh, at
    ``train_4k``: on a cut head (3 q and 3 kv heads) ``seq_par_attention``
    (block_q 2,048: a query block a rank) and ``fsdp_activations`` each
    halve the rank's attention, the rest of its work split by 2 either
    way, so both count the same FLOPs, below the lever-off rank's; the
    first gathers q, k, v and the rows with all-gathers, the second
    gathers every leaf (no all-reduce-based gather is left in either);
    ``activation_sharding`` on 3 q heads changes nothing."""
    from repro_torch.launch.dryrun import count_rank

    base = get_config("smollm-135m").reduced().with_(num_heads=3, num_kv_heads=3, head_dim=64,
                                                     block_q=2048)
    costs = {lever: count_rank(base.with_(**({lever: True} if lever else {})), "train_4k",
                               tmesh.make_test_mesh(), None, {})["costs"]
             for lever in (None, "seq_par_attention", "fsdp_activations", "activation_sharding")}
    off = costs[None]
    assert costs["activation_sharding"] == off
    assert costs["seq_par_attention"]["dot_flops"] == costs["fsdp_activations"]["dot_flops"]
    assert costs["seq_par_attention"]["dot_flops"] < off["dot_flops"]
    seq, fsdp = (costs[k]["collective_counts"] for k in ("seq_par_attention", "fsdp_activations"))
    assert "all_gather" not in off["collective_counts"]
    assert seq["all_gather"] == 2 * base.num_layers and "gather" not in seq
    assert fsdp["all_gather"] == base.num_layers + 2 and "gather" not in fsdp
    assert fsdp["psum"] < off["collective_counts"]["psum"]
