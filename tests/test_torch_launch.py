"""The port's launch tier (``repro_torch.launch.{specs,analytic,steps}``)
against the JAX package's (``repro.launch``), on the CPU.

* ``analytic_report``, ``n_params_total`` and ``n_matmul_active`` equal the
  reference's float for float for every arch x shape at ``mesh_rows`` 1,
  16 and 256;
* ``input_specs`` on ``device="meta"`` gives the leaf paths, shapes and
  dtypes, the step kind, the skip reason and the ``meta`` of the
  reference's ``input_specs`` on a one-device mesh (``client_rows`` in
  place of the mesh) for all 40 combos; with ``client_rows`` > 1 the
  clients are ``client_rows`` under ``vmap`` and ``fed_clients`` under
  ``scan``/``remat``, as ``repro/launch/specs.py:63`` counts them;
  on ``device="cpu"`` (a cut batch) the same shapes with real, seeded
  values;
* ``build_step``'s prefill, forward, decode and train steps on reduced f32
  configs against the reference's ``build_step`` at 1e-5 (train: the
  aggregate, and the posteriors and blocked bits equal), the weights
  carried over through ``repro_torch.convert``;
* a reduced smollm-135m decode step on its ring cache at position 524,287
  (``long_500k``'s) against the reference's: RoPE at large positions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALIASES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.reputation import ReputationState as JaxRep  # noqa: E402
from repro.launch import analytic as jax_analytic  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.core import ReputationState  # noqa: E402
from repro_torch.launch import analytic, specs, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU workloads: the suite
    runs several workers at once, and torch's thread pool oversubscribed by
    them runs these ~20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = list(ALIASES)
SHAPES = list(specs.INPUT_SHAPES)
F32 = dict(param_dtype="float32", compute_dtype="float32")


class FakeMesh:
    """The attributes ``num_client_rows`` reads, as ``tests/test_launch.py``
    fakes a mesh."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@functools.lru_cache(maxsize=None)
def _mesh():
    return make_test_mesh(data=1, model=1)


def test_shapes_and_local_steps_are_the_reference_s():
    assert specs.INPUT_SHAPES == jax_specs.INPUT_SHAPES
    assert specs.LOCAL_STEPS == jax_specs.LOCAL_STEPS


# --------------------------------- analytic ----------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_report_equals_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert analytic.n_params_total(cfg) == jax_analytic.n_params_total(jcfg)
    assert analytic.n_matmul_active(cfg) == jax_analytic.n_matmul_active(jcfg)
    for rows in (1, 16, 256):
        assert analytic.analytic_report(cfg, shape, rows) == \
            jax_analytic.analytic_report(jcfg, shape, rows), (arch, shape, rows)


def test_smollm_analytic_values():
    """The figures the production-shape phase divides by."""
    cfg = get_config("smollm-135m")
    got = {s: analytic.analytic_report(cfg, s, 1) for s in SHAPES}
    want = {"train_4k": (5.166e15, 3.384e15), "prefill_32k": (1.469e15, 2.82e14),
            "decode_32k": (3.243e11, 3.443e10), "long_500k": (8.352e8, 2.69e8)}
    for s, (flops, six_nd) in want.items():
        assert got[s]["analytic_flops"] == pytest.approx(flops, rel=1e-3)
        assert got[s]["model_flops_6nd"] == pytest.approx(six_nd, rel=1e-3)
    assert analytic.n_params_total(cfg) == pytest.approx(1.628e8, rel=1e-3)
    assert analytic.n_matmul_active(cfg) == pytest.approx(1.345e8, rel=1e-3)


# ----------------------------------- specs -----------------------------------


def _keyname(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _jax_leaves(args) -> dict:
    return {tuple(_keyname(k) for k in path): (tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(args)[0]}


def _torch_leaves(tree, prefix=()) -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_torch_leaves(v, prefix + (k,)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    return jax_build_model(jax_get_config(arch))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    ref = jax_specs.input_specs(_jax_model(arch), shape, _mesh())
    got = specs.input_specs(build_model(get_config(arch)), shape)
    assert got.step_kind == ref.step_kind
    assert got.skip_reason == ref.skip_reason
    want_meta = dict(ref.meta)
    if want_meta.pop("mesh", None) is not None:
        want_meta["client_rows"] = 1
    assert got.meta == want_meta
    assert _torch_leaves(got.args) == _jax_leaves(ref.args)
    assert all(t.device.type == "meta" for t in tree_leaves_any(got.args))


def tree_leaves_any(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in vals for leaf in tree_leaves_any(v)]


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b", "nemotron-4-340b"])
def test_client_rows_count_clients_as_the_reference(arch):
    """vmap: K = client_rows, b = global_batch // K; scan and remat: K =
    fed_clients, b = global_batch (``repro/launch/specs.py:63``)."""
    cfg = get_config(arch)
    for rows in (2, 4, 16):
        K = specs.fed_client_count(cfg, rows)
        assert K == jax_specs.fed_client_count(jax_get_config(arch),
                                               FakeMesh({"data": rows, "model": 1}))
        b = specs.input_specs(build_model(cfg), "train_4k", rows)
        assert b.meta["num_clients"] == K
        want_b = 256 // rows if cfg.fed_mode == "vmap" else 256
        assert b.meta["per_client_batch"] == want_b
        assert b.args[3]["tokens"].shape == (K, specs.LOCAL_STEPS, want_b, 4096)
        assert b.args[1].alpha.shape == (K,) and b.args[2].shape == (K,)


def test_real_specs_on_the_cpu_are_seeded_and_shaped_as_on_meta():
    """``device="cpu"`` with a cut batch: the meta shapes, the decode
    position ``seq - 1``, and the same values from the same seed."""
    model = build_model(get_config("smollm-135m").reduced().with_(**F32))
    meta = specs.input_specs(model, "decode_32k", global_batch=2)
    a = specs.input_specs(model, "decode_32k", device="cpu", global_batch=2)
    b = specs.input_specs(model, "decode_32k", device="cpu", global_batch=2)
    assert _torch_leaves(a.args) == _torch_leaves(meta.args)
    assert a.meta["global_batch"] == 2 and a.meta["cache_size"] == 32768
    assert a.args[3].tolist() == [32767, 32767] and a.args[1]["pos"].tolist() == [32767] * 2
    for x, y in zip(tree_leaves_any(a.args), tree_leaves_any(b.args)):
        assert torch.equal(x, y)
    k = a.args[1]["layers"][0]
    assert k.abs().sum() > 0 and bool(torch.isfinite(k).all())
    other = specs.param_specs(model, device="cpu", seed=1)
    assert not torch.equal(other["head"], a.args[0]["head"])
    assert torch.equal(specs.param_specs(model, device="cpu")["head"], a.args[0]["head"])


# ----------------------------------- steps -----------------------------------


@functools.lru_cache(maxsize=None)
def _reduced_params(arch):
    """A reduced f32 config's parameters from seed 0, in both packages: one
    init a module, shared by every step built on the arch (the fed-round
    options do not change them)."""
    jm = jax_build_model(jax_get_config(arch).reduced().with_(**F32))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jp, model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _reduced(arch, **over):
    jcfg = jax_get_config(arch).reduced().with_(**F32, **over)
    cfg = get_config(arch).reduced().with_(**F32, **over)
    jp, p = _reduced_params(arch)
    return jax_build_model(jcfg), build_model(cfg), jp, p


def _close(a, b, tol=1e-5):
    a = np.asarray(a, dtype=np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_prefill_step_equals_the_reference():
    jm, m, jp, p = _reduced("smollm-135m")
    toks = _tokens(m.config.vocab_size, (2, 48), 1)
    meta = {"cache_size": 56}
    jstep = jax.jit(jax_steps.build_step(jm, jax_specs.SpecBundle("prefill", (), meta), None))
    jl, jc = jstep(jp, {"tokens": jnp.asarray(toks)})
    step = steps.build_step(m, specs.SpecBundle("prefill", (), meta))
    with torch.no_grad():
        logits, cache = step(p, {"tokens": torch.from_numpy(toks)})
    _close(jl, logits)
    for x, y in zip(jax.tree_util.tree_leaves(jc["layers"]), cache["layers"]):
        _close(x, y)
    assert cache["pos"].tolist() == np.asarray(jc["pos"]).tolist()


def test_forward_step_equals_the_reference():
    jm, m, jp, p = _reduced("hubert-xlarge")
    frames = np.random.default_rng(2).normal(size=(2, 32, m.config.frontend_dim))
    frames = frames.astype(np.float32)
    jstep = jax.jit(jax_steps.build_step(jm, jax_specs.SpecBundle("forward", (), {}), None))
    want = jstep(jp, {"frame_embeds": jnp.asarray(frames)})
    step = steps.build_step(m, specs.SpecBundle("forward", (), {}))
    with torch.no_grad():
        got = step(p, {"frame_embeds": torch.from_numpy(frames)})
    _close(want, got)


def _decode_pair(arch, cache_np, toks, pos, ring):
    """The reference's serve step and the port's on the same cache, tokens
    and positions: (want logits, want cache, got logits, got cache)."""
    jm, m, jp, p = _reduced(arch)
    meta = {"ring": ring, "cache_size": cache_np["layers"][0].shape[2]}
    jstep = jax.jit(jax_steps.build_step(jm, jax_specs.SpecBundle("decode", (), meta), None))
    jcache = jax.tree_util.tree_map(jnp.asarray, cache_np)
    jl, jc = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos))
    step = steps.build_step(m, specs.SpecBundle("decode", (), meta))
    cache = cache_from_numpy(cache_np, device="cpu")
    with torch.no_grad():
        logits, cache = step(p, cache, torch.from_numpy(toks), torch.from_numpy(pos))
    return jl, jc, logits, cache


def test_decode_step_equals_the_reference_from_its_prefill():
    jm, m, jp, p = _reduced("smollm-135m")
    toks = _tokens(m.config.vocab_size, (2, 40), 3)
    _, jc = jax.jit(lambda pp, t: jm.prefill(pp, {"tokens": t}, cache_size=48))(
        jp, jnp.asarray(toks))
    cache_np = jax.tree_util.tree_map(np.asarray, jc)
    nxt = _tokens(m.config.vocab_size, (2,), 4)
    pos = np.full((2,), 40, np.int32)
    jl, jc2, logits, cache = _decode_pair("smollm-135m", cache_np, nxt, pos, False)
    _close(jl, logits)
    for x, y in zip(jax.tree_util.tree_leaves(jc2["layers"]), cache["layers"]):
        _close(x, y)
    assert cache["pos"].tolist() == [41, 41]


def _rope_eager_freqs(x, positions, theta: float = 10_000.0):
    """``repro.models.layers.rope`` with its frequencies evaluated op by op
    (``jax.ensure_compile_time_eval``), not inside the step's fused XLA
    computation.  Fused, XLA rounds ``1 / theta ** (i / half)`` one float32
    ulp apart from the eager value (and from torch's), and position 524,287
    magnifies that into angles up to ~0.06 rad apart (ROADMAP C.16)."""
    half = x.shape[-1] // 2
    with jax.ensure_compile_time_eval():
        freqs = 1.0 / (theta ** (jnp.arange(0, half, dtype=jnp.float32) / half))
    ang = positions.astype(jnp.float32)[..., None] * freqs
    cos, sin = jnp.cos(ang)[..., None, :], jnp.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1).astype(x.dtype)


def _long_500k_ring():
    """A reduced smollm-135m's ring of its window's slots filled from a
    seed, at ``long_500k``'s position 524,287, as numpy."""
    _, m, _, _ = _reduced("smollm-135m")
    cfg = m.config
    w, b = cfg.sliding_window, 2
    shape = (cfg.num_layers, b, w, cfg.num_kv_heads, cfg.hd)
    r = np.random.default_rng(5)
    pos = np.full((b,), specs.INPUT_SHAPES["long_500k"]["seq"] - 1, np.int32)
    cache_np = {"layers": (r.normal(size=shape).astype(np.float32),
                           r.normal(size=shape).astype(np.float32)), "pos": pos.copy()}
    return cache_np, _tokens(cfg.vocab_size, (b,), 6), pos


def test_rope_at_long_500k_position_is_the_float64_rotation():
    """The port's RoPE at position 524,287 (angles up to ~5e5 rad) within
    1e-6 of the float64 rotation by the same float32 angles (its float32
    frequencies, as the reference computes them op by op)."""
    from repro_torch.models.layers import rope

    x = np.random.default_rng(8).normal(size=(2, 1, 4, 64)).astype(np.float32)
    pos = np.full((2, 1), 524_287, np.int32)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    freqs = np.asarray(1.0 / (10_000.0 ** (jnp.arange(0, 32, dtype=jnp.float32) / 32)))
    ang = (np.float32(524_287) * freqs).astype(np.float64)
    x1, x2 = x[..., :32].astype(np.float64), x[..., 32:].astype(np.float64)
    want = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                           x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ring_decode_at_long_500k_position_equals_the_reference(monkeypatch):
    """``long_500k``'s step on a reduced smollm: the ring filled from a seed,
    position 524,287, against the reference's step with its RoPE
    frequencies evaluated op by op (``_rope_eager_freqs``)."""
    import repro.models.blocks as jax_blocks

    monkeypatch.setattr(jax_blocks, "rope", _rope_eager_freqs)
    cache_np, toks, pos = _long_500k_ring()
    jl, jc, logits, cache = _decode_pair("smollm-135m", cache_np, toks, pos, True)
    _close(jl, logits)
    slot = int(pos[0]) % cache_np["layers"][0].shape[2]
    for x, y in zip(jax.tree_util.tree_leaves(jc["layers"]), cache["layers"]):
        _close(np.asarray(x)[:, :, slot], y[:, :, slot])
    assert cache["pos"].tolist() == [int(pos[0]) + 1] * len(pos)


def _fed_batch(K, S, bsz, seq, vocab, seed):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, (K, S, bsz, seq)).astype(np.int32)
    lab = r.integers(0, vocab, (K, S, bsz, seq)).astype(np.int32)
    tok[0], lab[0] = 0, 7  # client 0 byzantine: the train CLI's attack
    return {"tokens": tok, "labels": lab}


@pytest.mark.parametrize("mode,clients", [("vmap", 1), ("scan", 4), ("remat", 4)])
def test_train_step_equals_the_reference(mode, clients):
    """The reference's train step (its ``build_step`` on a one-device mesh:
    one client under vmap) against the port's (``client_rows=1``)."""
    jm, m, jp, p = _reduced("smollm-135m", fed_mode=mode, fed_clients=4)
    kw = dict(lr=0.05, local_steps=2, proposal_dtype="float32")
    meta = {"client_rows": 1}
    batch = _fed_batch(clients, 2, 2, 16, m.config.vocab_size, 7)
    mesh = _mesh()
    with mesh:
        jstep = jax.jit(jax_steps.build_step(jm, jax_specs.SpecBundle("train", (), meta), mesh,
                                             **kw))
        jrep = JaxRep(jnp.full((clients,), 3.0), jnp.full((clients,), 3.0),
                      jnp.zeros((clients,), bool))
        jagg, jrep2, jmet = jstep(jp, jrep, jnp.ones((clients,), jnp.float32),
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    step = steps.build_step(m, specs.SpecBundle("train", (), meta), **kw)
    rep = ReputationState(torch.full((clients,), 3.0), torch.full((clients,), 3.0),
                          torch.zeros((clients,), dtype=torch.bool))
    agg, rep2, met = step(p, rep, torch.ones((clients,)),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    for x, y in zip(jax.tree_util.tree_leaves(jagg), tree_leaves(agg)):
        _close(x, y)
    assert rep2.alpha.tolist() == np.asarray(jrep2.alpha).tolist()
    assert rep2.beta.tolist() == np.asarray(jrep2.beta).tolist()
    assert rep2.blocked.tolist() == np.asarray(jrep2.blocked).tolist()
    assert int(met["afa_rounds"]) == int(jmet["afa_rounds"])
    if clients > 1:  # the byzantine client screened out, in both packages
        assert rep2.beta.tolist()[0] == 4.0
