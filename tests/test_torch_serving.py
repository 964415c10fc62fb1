"""The port's LLM serving path against the JAX package's.

Same numpy inputs, and the JAX parameters converted through numpy, for
both.  The window and decode attention within 1e-5 / 1e-6; prefill's last
logits and every layer's cache within 1e-5 on the linear and ring layouts
and both attention routes (the flash kernel's CPU twin); decode steps
started from the reference's prefill (``cache_from_numpy``) within 1e-5;
the reference's own properties (decode = teacher forcing, ring = window
decode, ``tests/test_models.py:86``, ``:138``) at its tolerances; greedy
``generate`` = a JAX greedy loop token for token; the launcher's CLI.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TINY = dict(name="t-dense", family="dense", num_layers=2, d_model=32, vocab_size=64,
            num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16)
B, L = 2, 40   # L is not a multiple of block_q
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_model(window=0):
    """One JAX model per window for the module (its prefill always takes
    its blocked attention)."""
    return jax_build_model(JaxModelConfig(**TINY, sliding_window=window))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    """The JAX parameters of ``seed`` (the window does not change them),
    from one compiled init."""
    return jax.jit(_jax_model().init)(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _jax_prefill(window, seed, cache_size, use_window):
    """The JAX prefill of ``_tokens(seed, (B, L))``, shared by both of the
    port's attention routes."""
    fn = jax.jit(_jax_model(window).prefill, static_argnames=("cache_size", "use_window"))
    return fn(_jax_params(seed), {"tokens": jnp.asarray(_tokens(seed, (B, L)))},
              cache_size=cache_size, use_window=use_window)


def _models(seed=0, pallas=False, sliding_window=0):
    """The JAX model, the port's on the route ``pallas`` picks, and the JAX
    params on both sides."""
    tm = build_model(ModelConfig(**TINY, sliding_window=sliding_window,
                                 use_pallas_attention=pallas))
    params = _jax_params(seed)
    return (_jax_model(sliding_window), tm, params,
            model_params_from_numpy(_np_tree(params), device="cpu"))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], shape).astype(np.int32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("window", [8, 64], ids=["window<l", "window>=l"])
def test_sliding_window_attention_matches_jax(window):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, L, h, 8)).astype(np.float32) for h in (4, 2, 2))
    want = jattn.sliding_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          window=window, block_q=16)
    got = tattn.sliding_window_attention(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), window=window, block_q=16)
    _close(got, want)


@pytest.mark.parametrize("ring,window,cache_len", [
    (False, 0, [5, 17, 24]), (False, 6, [5, 17, 24]), (True, 0, [10, 24, 40]),
], ids=["linear", "linear-window", "ring"])
def test_decode_attention_matches_jax(ring, window, cache_len):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 4, 8)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, 24, 2, 8)).astype(np.float32) for _ in range(2))
    n = np.asarray(cache_len, np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(n), window=window, ring=ring)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(n), window=window,
                                 ring=ring)
    _close(got, want, 1e-6)


LAYOUTS = {  # sliding_window, cache_size, use_window
    "linear": (0, L + 8, False),
    "ring-l<w": (64, 64, True),
    "ring-l>=w": (16, 16, True),   # 40 % 16 = 8: the roll runs
}


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-twin"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_matches_jax(layout, pallas):
    window, cache_size, use_window = LAYOUTS[layout]
    _, tm, _, tp = _models(3, pallas, sliding_window=window)
    tok = _tokens(3, (B, L))
    jl, jc = _jax_prefill(window, 3, cache_size, use_window)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, cache_size=cache_size,
                            use_window=use_window)
    assert tl.dtype == torch.float32 and tl.shape == (B, TINY["vocab_size"])
    _close(tl, jl)
    for got, want in zip(tc["layers"], jc["layers"]):
        assert tuple(got.shape) == want.shape == (2, B, cache_size, 2, 8)
        _close(got, want)
    assert tc["pos"].dtype == torch.int32
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_decode_from_jax_prefill_matches_jax(ring):
    """Four decode steps of each package, both started from the JAX
    prefill's cache; the port writes its cache in place."""
    window, cache_size = (16, 16) if ring else (0, L + 8)
    jm, tm, params, tp = _models(4, sliding_window=window)
    _, jc = _jax_prefill(window, 4, cache_size, ring)
    tc = cache_from_numpy(_np_tree(jc), device="cpu")
    extra = _tokens(5, (B, 4))
    jdecode = jax.jit(functools.partial(jm.decode_step, ring=ring))
    with torch.no_grad():
        for t in range(4):
            jlog, jc = jdecode(params, jc, jnp.asarray(extra[:, t]))
            tlog, out = tm.decode_step(tp, tc, torch.from_numpy(extra[:, t]), ring=ring)
            assert out is tc
            _close(tlog, jlog, msg=f"step {t}")
    for got, want in zip(tc["layers"], jc["layers"]):
        _close(got, want)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    jm, tm, _, _ = _models()
    want = jm.init_cache(3, 20, getattr(jnp, dtype))
    got = tm.init_cache(3, 20, getattr(torch, dtype), device="cpu")
    for g, w in zip([*got["layers"], got["pos"]], [*want["layers"], want["pos"]]):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.float().any()


def test_forward_use_window_matches_jax():
    jm, tm, params, tp = _models(6, sliding_window=8)
    tok = _tokens(6, (B, L))
    want = jax.jit(jm.forward, static_argnames="use_window")(
        params, {"tokens": jnp.asarray(tok)}, use_window=True)
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(tok)}, use_window=True)
    _close(got, want)


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-twin"])
def test_decode_equals_teacher_forcing(pallas):
    """``tests/test_models.py:86`` on the port: prefill then 4 decode steps
    = a forward over the longer sequence."""
    gen = torch.Generator()
    gen.manual_seed(7)
    tm = build_model(ModelConfig(**TINY, use_pallas_attention=pallas))
    params = tm.init(gen, "cpu")
    tok = torch.from_numpy(_tokens(7, (B, L + 4)).astype(np.int64))
    with torch.no_grad():
        full = tm.forward(params, {"tokens": tok})
        lp, cache = tm.prefill(params, {"tokens": tok[:, :L]}, cache_size=L + 8)
        _close(lp, full[:, L - 1], 2e-3)
        for t in range(4):
            logits, cache = tm.decode_step(params, cache, tok[:, L + t])
            _close(logits, full[:, L + t], 5e-3, msg=f"step {t}")


def test_ring_decode_equals_window_decode():
    """``tests/test_models.py:138`` on the port: the ring cache of the
    window's size = the windowed forward, past the window."""
    w = 16
    gen = torch.Generator()
    gen.manual_seed(8)
    tm = build_model(ModelConfig(**TINY, sliding_window=w))
    params = tm.init(gen, "cpu")
    tok = torch.from_numpy(_tokens(8, (B, L + 3)).astype(np.int64))
    with torch.no_grad():
        full = tm.forward(params, {"tokens": tok}, use_window=True)
        lp, cache = tm.prefill(params, {"tokens": tok[:, :L]}, cache_size=w, use_window=True)
        _close(lp, full[:, L - 1], 2e-3)
        for t in range(3):
            logits, cache = tm.decode_step(params, cache, tok[:, L + t], ring=True)
            _close(logits, full[:, L + t], 5e-3, msg=f"ring step {t}")


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_generate_greedy_matches_jax_loop(ring):
    """Greedy ``generate`` = a JAX greedy loop over prefill / decode_step on
    the same parameters, token for token; every step's top-2 margin is
    asserted above 1e-4, so no tie decides the test."""
    window, cache_size, n_gen = (16, 16, 6) if ring else (0, L + 6, 6)
    jm, tm, params, tp = _models(9, sliding_window=window)
    tok = _tokens(9, (B, L))
    logits, cache = _jax_prefill(window, 9, cache_size, ring)
    jdecode = jax.jit(functools.partial(jm.decode_step, ring=ring))
    want = []
    for step in range(n_gen):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1e-4).all(), f"tie at step {step}"
        want.append(np.asarray(jnp.argmax(logits, -1)))
        if step < n_gen - 1:
            logits, cache = jdecode(params, cache, jnp.asarray(want[-1], jnp.int32))
    res = serve.generate(tm, tp, torch.from_numpy(tok.astype(np.int64)), gen=n_gen,
                         ring=ring, cache_size=cache_size)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))
    _close(res.logits, logits)
    assert res.times["decode_steps"] == n_gen - 1 and res.times["capture_s"] == 0.0


def test_generate_reuses_its_program_and_samples_from_its_generator():
    gen = torch.Generator()
    gen.manual_seed(10)
    tm = build_model(ModelConfig(**TINY))
    params = tm.init(gen, "cpu")
    prompts = torch.from_numpy(_tokens(10, (B, 8)).astype(np.int64))
    programs = {}
    a = serve.generate(tm, params, prompts, gen=4, ring=False, cache_size=12,
                       programs=programs)
    prog = programs[(B, 12, False, True)]
    b = serve.generate(tm, params, prompts, gen=4, ring=False, cache_size=12,
                       programs=programs)
    assert programs == {(B, 12, False, True): prog}
    assert torch.equal(a.tokens, b.tokens)
    draws = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(11)
        draws.append(serve.generate(tm, params, prompts, gen=4, ring=False, cache_size=12,
                                    temperature=1.5, generator=g).tokens)
    assert torch.equal(draws[0], draws[1])
    assert ((draws[0] >= 0) & (draws[0] < TINY["vocab_size"])).all()
    with pytest.raises(ValueError, match="linear cache"):
        serve.generate(tm, params, prompts, gen=6, ring=False, cache_size=12)


@pytest.mark.parametrize("arch,extra,word", [
    ("smollm-135m", [], "linear cache"), ("smollm-135m", ["--ring"], "ring cache"),
    ("olmoe-1b-7b", ["--ring"], "ring cache"),
], ids=["linear", "ring", "moe-ring"])
def test_serve_cli_linear_and_ring(arch, extra, word, capsys):
    """``tests/test_cli.py:30`` on the port's launcher, on the CPU, and a
    reduced olmoe-1b-7b on the ring cache."""
    rc = serve.main(["--arch", arch, "--reduced", "--requests", "2", "--batch", "2",
                     "--prompt-len", "16", "--gen", "4", "--device", "cpu", *extra])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("batch 0: prefill 2x16 in ") and "decoded 4 tok" in out[0]
    assert out[-1].startswith("served 2 requests, 8 tokens, ") and word in out[-1]


def test_serve_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "smollm-135m", "--reduced", "--requests", "1", "--batch", "1",
                    "--prompt-len", "4", "--gen", "2"])


def test_launcher_module_imports_no_jax():
    """``python -m repro_torch.launch.serve --help`` in a fresh process
    exits 0 without importing jax or repro."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--ring" in out.stdout and "--device" in out.stdout
