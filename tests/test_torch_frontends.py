"""The port's VLM and audio families (the patch and frame frontends)
against the JAX package's.

The tiny VLM and AUDIO of ``tests/test_models.py:38-45`` from the JAX
parameters: forward and loss within 1e-5 (loss 2e-3; the VLM's on its text
tokens only), prefill within 1e-5 (the VLM's cache holds its patches too),
the VLM's decode steps from the JAX prefill's cache, decode = teacher
forcing (``tests/test_models.py:86``'s tolerances); the prefix-LM mask
(patches see each other, the text sees the patches) on the plain attention
whatever the config asks (``repro/models/blocks.py:88``); the audio encoder
bidirectional on both attention routes, no decode step; greedy
``generate`` of the VLM = a JAX greedy loop; the launcher on a reduced
paligemma-3b (its cache sized with the prefix, its patches drawn after the
prompts) and refusing hubert-xlarge; both full configs' parameter shapes on
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
from repro_torch.utils.trees import tree_leaves, tree_structure  # noqa: E402

V = 96
# tests/test_models.py:38, :43
VLM = dict(name="t-vlm", family="vlm", num_layers=2, d_model=64, vocab_size=V,
           num_heads=4, num_kv_heads=1, d_ff=128, frontend="patch", frontend_dim=32,
           prefix_len=8, block_q=16, block_k=16)
AUDIO = dict(name="t-audio", family="audio", num_layers=2, d_model=64, vocab_size=V,
             num_heads=4, num_kv_heads=4, d_ff=128, frontend="frame", frontend_dim=24,
             causal=False, block_q=16, block_k=16)
CFGS = {"vlm": VLM, "audio": AUDIO}
B, L, P = 2, 40, 8   # P = the VLM's prefix
TOL = 1e-5
CACHE = P + L + 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _batch(family, seed):
    """numpy inputs of ``tests/test_models.py:51``'s shapes."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (B, L)).astype(np.int32)
    lab = rng.integers(0, V, (B, L)).astype(np.int32)
    if family == "audio":
        return {"frame_embeds": rng.normal(size=(B, L, 24)).astype(np.float32), "labels": lab}
    return {"tokens": tok, "labels": lab,
            "patch_embeds": rng.normal(size=(B, P, 32)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    return jax_build_model(JaxModelConfig(**CFGS[family]))


@functools.lru_cache(maxsize=None)
def _jax_params(family):
    return jax.jit(_jax_model(family).init)(jax.random.PRNGKey(0))


def _port(family, **kw):
    tm = build_model(ModelConfig(**CFGS[family], **kw))
    return tm, model_params_from_numpy(_np_tree(_jax_params(family)), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_forward_loss_prefill(family):
    jm = _jax_model(family)
    batch = {k: jnp.asarray(v) for k, v in _batch(family, 1).items()}
    return jax.jit(lambda p, b: (jm.forward(p, b), jm.loss_fn(p, b)[0],
                                 jm.prefill(p, b, cache_size=CACHE)))(_jax_params(family), batch)


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(k["causal"]) or real(*a, **k))
    return calls


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-config"])
@pytest.mark.parametrize("family", list(CFGS))
def test_forward_loss_and_prefill_match_jax(family, pallas, flash_calls):
    """The VLM's prefix keeps it on the plain attention under
    ``use_pallas_attention``; the encoder takes the kernel (its CPU twin),
    non-causal, once a layer."""
    tm, tp = _port(family, use_pallas_attention=pallas)
    want, jloss, (jl, jc) = _jax_forward_loss_prefill(family)
    batch = {k: _t(v) for k, v in _batch(family, 1).items()}
    with torch.no_grad():
        got = tm.forward(tp, batch)
        loss, met = tm.loss_fn(tp, batch)
        tl, tc = tm.prefill(tp, batch, cache_size=CACHE)
    lq = L + (P if family == "vlm" else 0)
    assert got.shape == (B, lq, V)
    _close(got, want)
    _close(loss, jloss, 2e-3)
    assert float(met["lb_loss"]) == 0.0 == float(met["z_loss"])
    _close(tl, jl)
    for name, g, w in zip("kv", tc["layers"], jc["layers"]):
        assert tuple(g.shape) == w.shape == (2, B, CACHE, 1 if family == "vlm" else 4, 16)
        _close(g, w, msg=name)
    assert int(tc["pos"][0]) == lq == int(jc["pos"][0])
    want_calls = [False] * 6 if pallas and family == "audio" else []
    assert flash_calls == want_calls


def test_vlm_loss_is_on_the_text_tokens():
    """The loss reads the text positions only: labels of L tokens, the
    patches' logits never scored."""
    tm, tp = _port("vlm")
    batch = {k: _t(v) for k, v in _batch("vlm", 2).items()}
    with torch.no_grad():
        logits = tm.forward(tp, batch)[:, P:]
        loss, _ = tm.loss_fn(tp, batch)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, V),
                                             batch["labels"].reshape(-1).long())
    _close(loss, want, 1e-6)


def test_vlm_decode_from_jax_prefill_matches_jax():
    tm, tp = _port("vlm")
    params = _jax_params("vlm")
    _, _, (_, jc) = _jax_forward_loss_prefill("vlm")
    tc = cache_from_numpy(_np_tree(jc), device="cpu")
    jdecode = jax.jit(_jax_model("vlm").decode_step)
    extra = np.random.default_rng(3).integers(0, V, (B, 4)).astype(np.int32)
    for t in range(4):
        jlog, jc = jdecode(params, jc, jnp.asarray(extra[:, t]))
        with torch.no_grad():
            tlog, out = tm.decode_step(tp, tc, _t(extra[:, t]))
        assert out is tc
        _close(tlog, jlog, msg=f"step {t}")
    for g, w in zip(tc["layers"], jc["layers"]):
        _close(g, w)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _random_port(family, seed, **kw):
    gen = torch.Generator()
    gen.manual_seed(seed)
    tm = build_model(ModelConfig(**CFGS[family], **kw))
    return tm, tm.init(gen, "cpu")


def test_vlm_decode_equals_teacher_forcing():
    tm, params = _random_port("vlm", 4)
    batch = {k: _t(v) for k, v in _batch("vlm", 4).items()}
    extra = _t(np.random.default_rng(5).integers(0, V, (B, 4)))
    longer = dict(batch, tokens=torch.cat([batch["tokens"], extra], dim=1))
    with torch.no_grad():
        full = tm.forward(params, longer)
        lp, cache = tm.prefill(params, batch, cache_size=CACHE)
        _close(lp, full[:, P + L - 1], 2e-3)
        for t in range(4):
            logits, cache = tm.decode_step(params, cache, extra[:, t])
            _close(logits, full[:, P + L + t], 5e-3, msg=f"step {t}")


def test_vlm_prefix_visible_to_text():
    """``tests/test_models.py:174`` and the rest of the prefix-LM mask: a
    patch changes the text's logits and an earlier patch's; a text token
    changes no earlier position."""
    tm, params = _random_port("vlm", 6)
    batch = {k: _t(v) for k, v in _batch("vlm", 6).items()}
    pe = batch["patch_embeds"].clone()
    pe[:, -1] = 0.0
    tok = batch["tokens"].clone()
    tok[:, -1] = (tok[:, -1] + 1) % V
    with torch.no_grad():
        out = tm.forward(params, batch)
        patched = tm.forward(params, dict(batch, patch_embeds=pe))
        texted = tm.forward(params, dict(batch, tokens=tok))
    assert float((out[:, -1] - patched[:, -1]).abs().max()) > 1e-6
    assert float((out[:, 0] - patched[:, 0]).abs().max()) > 1e-6   # the prefix is bidirectional
    assert torch.equal(out[:, :-1], texted[:, :-1])                 # the text is causal


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-twin"])
def test_audio_encoder_bidirectional_without_decode(pallas):
    """``tests/test_models.py:162`` on both routes: a late frame changes the
    first output; an encoder has no decode step."""
    tm, params = _random_port("audio", 7, use_pallas_attention=pallas)
    batch = {k: _t(v) for k, v in _batch("audio", 7).items()}
    fe = batch["frame_embeds"].clone()
    fe[:, -1] = 0.0
    with torch.no_grad():
        out1 = tm.forward(params, batch)
        out2 = tm.forward(params, dict(batch, frame_embeds=fe))
    assert float((out1[:, 0] - out2[:, 0]).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="encoder-only"):
        tm.decode_step(params, tm.init_cache(B, 8, device="cpu"), torch.zeros(B, dtype=torch.long))


def test_vlm_generate_greedy_matches_jax_loop():
    """Greedy ``generate`` with the patches = a JAX greedy loop, token for
    token, every step's top-2 margin above 1e-4."""
    n_gen = 6
    tm, tp = _port("vlm")
    params = _jax_params("vlm")
    _, _, (logits, cache) = _jax_forward_loss_prefill("vlm")
    jdecode = jax.jit(_jax_model("vlm").decode_step)
    want = []
    for step in range(n_gen):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1e-4).all(), f"tie at step {step}"
        want.append(np.asarray(jnp.argmax(logits, -1)))
        if step < n_gen - 1:
            logits, cache = jdecode(params, cache, jnp.asarray(want[-1], jnp.int32))
    batch = _batch("vlm", 1)
    prompts = _t(batch["tokens"].astype(np.int64))
    res = serve.generate(tm, tp, prompts, gen=n_gen, ring=False, cache_size=CACHE,
                         patch_embeds=_t(batch["patch_embeds"]))
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))
    _close(res.logits, logits)
    with pytest.raises(ValueError, match="8 prefix, 40 prompt and 5 decoded"):
        serve.generate(tm, tp, prompts, gen=n_gen, ring=False, cache_size=P + L + 4,
                       patch_embeds=_t(batch["patch_embeds"]))
    with pytest.raises(ValueError, match="patch_embeds"):
        serve.generate(tm, tp, prompts, gen=n_gen, ring=False, cache_size=CACHE)


def test_serve_cli_paligemma_sizes_its_cache_with_the_prefix(monkeypatch, capsys):
    """The reference's arguments: 16 + 12 positions of prompt and output in
    a cache of ``prefix_len + 16 + 12`` slots (the reference's 28 would
    leave the last 7 decode steps without a slot); prompts and patches
    drawn in the reference's order from one generator."""
    seen = []
    real = serve.generate
    monkeypatch.setattr(serve, "generate",
                        lambda m, p, prompts, **kw: seen.append((prompts, kw)) or real(
                            m, p, prompts, **kw))
    rc = serve.main(["--arch", "paligemma-3b", "--reduced", "--requests", "2", "--batch", "1",
                     "--prompt-len", "16", "--gen", "12", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("batch 0: prefill 1x16 in ") and "decoded 12 tok" in out[0]
    assert out[-1].startswith("served 2 requests, 24 tokens, ") and "linear cache" in out[-1]
    cfg = get_config("paligemma-3b").reduced()
    rng = np.random.default_rng(0)
    for prompts, kw in seen:
        assert kw["cache_size"] == cfg.prefix_len + 16 + 12 == 36
        np.testing.assert_array_equal(prompts.numpy(), rng.integers(0, cfg.vocab_size, (1, 16)))
        np.testing.assert_array_equal(
            kw["patch_embeds"].numpy(),
            rng.normal(size=(1, cfg.prefix_len, cfg.frontend_dim)).astype(np.float32))


def test_serve_cli_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch,n_params", [("paligemma-3b", (3.0e9, 3.1e9)),
                                           ("hubert-xlarge", (0.9e9, 1.0e9))])
def test_params_on_meta_match_jax_shapes(arch, n_params):
    """The full config on the meta device: JAX's paths, shapes and dtypes;
    ``embed`` only where the family reads tokens, ``frontend_proj`` beside
    it."""
    want = jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    cfg = get_config(arch)
    got = build_model(cfg).init(None, "meta")
    want_paths = [tuple(k.key for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert list(tree_structure(got)) == want_paths
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    assert ("embed" in got) == (cfg.family == "vlm")
    n = sum(t.numel() for t in tree_leaves(got))
    assert n_params[0] < n < n_params[1]
