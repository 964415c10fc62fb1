"""The port's hybrid family (zamba2-style) against the JAX package's.

Mamba-2 segments with the one shared attention block after each full
segment, its own KV cache per application point (``cache["shared"]``).
The tiny HYBRID of ``tests/test_models.py:33`` (5 layers, the shared block
every 2: two segments and a tail of one) and the same without a tail (4
layers), from the JAX parameters: forward and loss within 1e-5 (loss 2e-3),
prefill's last logits within 1e-5 and every cache within 1e-5 of its
largest magnitude (the second segment's SSD sums reach ~170 in f32, where
a few ulps are ~2e-5) on the linear and ring layouts, both attention
routes (the flash kernel's CPU twin for the shared block); decode steps
from the JAX prefill's cache; decode = teacher forcing and ring = window
decode at the reference test's tolerances; the shared block's flash calls;
the launcher on a reduced zamba2-1.2b; zamba2-1.2b's parameter shapes on
the meta device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.model import hybrid_segments  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_structure  # noqa: E402

# tests/test_models.py:33
HYBRID = dict(name="t-hybrid", family="hybrid", num_layers=5, d_model=64, vocab_size=96,
              num_heads=4, num_kv_heads=4, d_ff=128, ssm_state=16, ssm_head_dim=32,
              ssm_chunk=16, shared_attn_every=2, block_q=16, block_k=16)
LAYERS = {"tail": 5, "no-tail": 4}
B, L = 2, 40
TOL = 1e-5
W = 16   # the ring layouts' window: 40 % 16 = 8, the roll runs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfg(n_layers, window=0, **kw):
    return dict(HYBRID, num_layers=n_layers, sliding_window=window, **kw)


@functools.lru_cache(maxsize=None)
def _jax_model(n_layers, window=0):
    return jax_build_model(JaxModelConfig(**_cfg(n_layers, window)))


@functools.lru_cache(maxsize=None)
def _jax_params(n_layers, seed):
    return jax.jit(_jax_model(n_layers).init)(jax.random.PRNGKey(seed))


def _port(n_layers, seed, window=0, pallas=False):
    tm = build_model(ModelConfig(**_cfg(n_layers, window, use_pallas_attention=pallas)))
    return tm, model_params_from_numpy(_np_tree(_jax_params(n_layers, seed)), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, HYBRID["vocab_size"], shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward_and_loss(n_layers, seed):
    jm = _jax_model(n_layers)
    batch = {"tokens": jnp.asarray(_tokens(seed, (B, L))),
             "labels": jnp.asarray(_tokens(seed + 10, (B, L)))}
    return jax.jit(lambda p, b: (jm.forward(p, b), jm.loss_fn(p, b)[0]))(
        _jax_params(n_layers, seed), batch)


@functools.lru_cache(maxsize=None)
def _jax_prefill(n_layers, seed, ring):
    window, cache_size = (W, W) if ring else (0, L + 8)
    fn = jax.jit(_jax_model(n_layers, window).prefill,
                 static_argnames=("cache_size", "use_window"))
    return fn(_jax_params(n_layers, seed), {"tokens": jnp.asarray(_tokens(seed, (B, L)))},
              cache_size=cache_size, use_window=ring)


def _close_scaled(got, want, tol=TOL, msg=""):
    """Within ``tol`` of the tensor's largest magnitude (f32 rounding of
    large intermediates carries into every later layer)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=msg)


def _close_cache(got, want):
    assert sorted(got) == sorted(want)
    for k in ("state", "conv"):
        _close_scaled(got["layers"][k], want["layers"][k], msg=k)
    for name, g, w in zip("kv", got["shared"], want["shared"]):
        assert tuple(g.shape) == w.shape
        _close_scaled(g, w, msg=f"shared {name}")
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


@pytest.fixture
def flash_calls(monkeypatch):
    """The shapes of every ``ops.flash_attention`` call (its CPU twin runs)."""
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, *a, **k: calls.append(tuple(q.shape)) or real(q, *a, **k))
    return calls


def test_hybrid_segments_of_zamba2():
    assert hybrid_segments(get_config("zamba2-1.2b")) == (6, 6, 2)
    assert hybrid_segments(ModelConfig(**HYBRID)) == (2, 2, 1)


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-twin"])
@pytest.mark.parametrize("layout", list(LAYERS))
def test_hybrid_forward_and_loss_match_jax(layout, pallas, flash_calls):
    n = LAYERS[layout]
    tm, tp = _port(n, 0, pallas=pallas)
    tok, lab = _tokens(0, (B, L)), _tokens(10, (B, L))
    want, jloss = _jax_forward_and_loss(n, 0)
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": _t(tok)})
        loss, met = tm.loss_fn(tp, {"tokens": _t(tok), "labels": _t(lab)})
    _close(got, want)
    _close(loss, jloss, 2e-3)
    assert float(met["lb_loss"]) == 0.0
    # the shared block, and only it, takes the kernel: once a segment, 2 forwards
    assert flash_calls == ([(B, L, 4, 16)] * 4 if pallas else [])


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-twin"])
@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("layout", list(LAYERS))
def test_hybrid_prefill_matches_jax(layout, ring, pallas, flash_calls):
    n = LAYERS[layout]
    window, cache_size = (W, W) if ring else (0, L + 8)
    tm, tp = _port(n, 1, window, pallas)
    jl, jc = _jax_prefill(n, 1, ring)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": _t(_tokens(1, (B, L)))}, cache_size=cache_size,
                            use_window=ring)
    _close(tl, jl)
    assert tc["layers"]["state"].shape == (n, B, 4, 16, 32)
    assert tc["shared"][0].shape == (2, B, cache_size, 4, 16)
    _close_cache(tc, jc)
    # the windowed prefill is plain torch; the linear one's shared blocks the kernel
    assert len(flash_calls) == (2 if pallas and not ring else 0)


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_hybrid_decode_from_jax_prefill_matches_jax(ring, flash_calls):
    """Four decode steps of each package from the JAX prefill's cache: the
    Mamba-2 caches and the shared blocks' ring or linear caches written in
    place; the kernel is not called in decode."""
    window = W if ring else 0
    tm, tp = _port(5, 1, window, pallas=True)
    params = _jax_params(5, 1)
    _, jc = _jax_prefill(5, 1, ring)
    tc = cache_from_numpy(_np_tree(jc), device="cpu")
    jdecode = jax.jit(functools.partial(_jax_model(5, window).decode_step, ring=ring))
    extra = _tokens(2, (B, 4))
    for t in range(4):
        jlog, jc = jdecode(params, jc, jnp.asarray(extra[:, t]))
        with torch.no_grad():
            tlog, out = tm.decode_step(tp, tc, _t(extra[:, t]), ring=ring)
        assert out is tc
        _close(tlog, jlog, msg=f"step {t}")
    _close_cache(tc, jc)
    assert flash_calls == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_init_cache_matches_jax(dtype):
    want = _jax_model(5).init_cache(3, 20, getattr(jnp, dtype))
    got = build_model(ModelConfig(**HYBRID)).init_cache(3, 20, getattr(torch, dtype),
                                                        device="cpu")
    assert sorted(got) == sorted(want) == ["layers", "pos", "shared"]
    pairs = [(got["layers"][k], want["layers"][k]) for k in ("state", "conv")]
    pairs += list(zip(got["shared"], want["shared"])) + [(got["pos"], want["pos"])]
    for g, w in pairs:
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.float().any()


@pytest.mark.parametrize("layout", list(LAYERS))
def test_hybrid_decode_equals_teacher_forcing(layout):
    """``tests/test_models.py:86`` on the port, with and without a tail
    segment."""
    gen = torch.Generator()
    gen.manual_seed(3)
    tm = build_model(ModelConfig(**_cfg(LAYERS[layout])))
    params = tm.init(gen, "cpu")
    tok = _t(_tokens(3, (B, L + 4)).astype(np.int64))
    with torch.no_grad():
        full = tm.forward(params, {"tokens": tok})
        lp, cache = tm.prefill(params, {"tokens": tok[:, :L]}, cache_size=L + 8)
        _close(lp, full[:, L - 1], 2e-3)
        for t in range(4):
            logits, cache = tm.decode_step(params, cache, tok[:, L + t])
            _close(logits, full[:, L + t], 5e-3, msg=f"step {t}")


def test_hybrid_ring_decode_equals_window_decode():
    """``tests/test_models.py:138`` on the hybrid: the shared blocks' ring
    caches of the window's size = the windowed forward, past the window."""
    gen = torch.Generator()
    gen.manual_seed(4)
    tm = build_model(ModelConfig(**_cfg(5, W)))
    params = tm.init(gen, "cpu")
    tok = _t(_tokens(4, (B, L + 3)).astype(np.int64))
    with torch.no_grad():
        full = tm.forward(params, {"tokens": tok}, use_window=True)
        lp, cache = tm.prefill(params, {"tokens": tok[:, :L]}, cache_size=W, use_window=True)
        _close(lp, full[:, L - 1], 2e-3)
        for t in range(3):
            logits, cache = tm.decode_step(params, cache, tok[:, L + t], ring=True)
            _close(logits, full[:, L + t], 5e-3, msg=f"ring step {t}")


@pytest.mark.parametrize("extra,word", [([], "linear cache"), (["--ring"], "ring cache")],
                         ids=["linear", "ring"])
def test_serve_cli_zamba2(extra, word, capsys):
    rc = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--requests", "2", "--batch", "2",
                     "--prompt-len", "16", "--gen", "4", "--device", "cpu", *extra])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("batch 0: prefill 2x16 in ") and "decoded 4 tok" in out[0]
    assert out[-1].startswith("served 2 requests, 8 tokens, ") and word in out[-1]


def test_zamba2_params_on_meta_match_jax_shapes():
    """zamba2-1.2b at full width on the meta device: JAX's paths, shapes and
    dtypes, one shared dense block beside 38 Mamba-2 layers."""
    want = jax.eval_shape(jax_build_model(jax_get_config("zamba2-1.2b")).init,
                          jax.random.PRNGKey(0))
    got = build_model(get_config("zamba2-1.2b")).init(None, "meta")
    want_paths = [tuple(k.key for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert list(tree_structure(got)) == want_paths
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got["shared"]["attn"]["wq"].shape == (2048, 2048)
    assert got["layers"]["mamba"]["in_proj"].shape[0] == 38
    n = sum(t.numel() for t in tree_leaves(got))
    assert 1.1e9 < n < 1.2e9
