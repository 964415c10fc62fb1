"""The port's Mamba-2 block and SSM family against the JAX package's.

Same numpy inputs, and the JAX parameters carried across through numpy,
for both.  ``_ssd_chunked``, ``_causal_conv``, ``apply_mamba2`` (with its
serving cache) and ``decode_mamba2`` within 1e-5, at an L that is a
multiple of the chunk, one that is not, and one shorter than the conv's
``cw - 1``; the tiny SSM model of ``tests/test_models.py:29`` in forward,
loss (and its gradient), prefill and decode steps from the JAX prefill's
cache; decode = teacher forcing (``tests/test_models.py:86``'s
tolerances); greedy ``generate`` = a JAX greedy loop; the launcher on a
reduced mamba2-1.3b; mamba2-1.3b's parameter shapes on the meta device.
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
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_structure  # noqa: E402

# tests/test_models.py:29
SSM = dict(name="t-ssm", family="ssm", num_layers=2, d_model=64, vocab_size=96,
           ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
B, L = 2, 40   # L is not a multiple of the chunk
TOL = 1e-5
LENGTHS = {"l=3chunks": 48, "l%chunk!=0": 40, "l<cw-1": 2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _jax_model():
    return jax_build_model(JaxModelConfig(**SSM))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    return jax.jit(_jax_model().init)(jax.random.PRNGKey(seed))


def _port(seed):
    return build_model(ModelConfig(**SSM)), model_params_from_numpy(
        _np_tree(_jax_params(seed)), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SSM["vocab_size"], shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(seed):
    fn = jax.jit(_jax_model().prefill, static_argnames=("cache_size", "use_window"))
    return fn(_jax_params(seed), {"tokens": jnp.asarray(_tokens(seed, (B, L)))}, cache_size=L)


@functools.lru_cache(maxsize=None)
def _jax_decode():
    return jax.jit(_jax_model().decode_step)


def _layer_params(seed):
    """Layer 0's Mamba-2 params of the tiny model, JAX and port."""
    jp = jax.tree_util.tree_map(lambda x: x[0], _jax_params(seed)["layers"]["mamba"])
    return jp, model_params_from_numpy(_np_tree(jp), device="cpu")


@pytest.mark.parametrize("l", list(LENGTHS.values()), ids=list(LENGTHS))
def test_ssd_chunked_matches_jax(l):
    rng = np.random.default_rng(l)
    h, p, n = 4, 8, 16
    x = rng.normal(size=(B, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, l, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, l, n)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(h,)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    jy, js = jax.jit(jssm._ssd_chunked, static_argnums=6)(*map(jnp.asarray, args), 16)
    ty, ts = tssm._ssd_chunked(*map(_t, args), 16)
    assert ty.shape == (B, l, h, p) and ts.shape == (B, h, n, p) and ts.dtype == torch.float32
    _close(ty, jy, msg="y")
    _close(ts, js, msg="final state")


@pytest.mark.parametrize("l", [40, 2], ids=["l=40", "l<cw-1"])
def test_causal_conv_matches_jax(l):
    rng = np.random.default_rng(l)
    xbc, w, b = (rng.normal(size=s).astype(np.float32) for s in ((B, l, 12), (4, 12), (12,)))
    _close(tssm._causal_conv(_t(xbc), _t(w), _t(b)),
           jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("l", list(LENGTHS.values()), ids=list(LENGTHS))
def test_apply_mamba2_with_state_matches_jax(l):
    """The block's output and its serving cache: the final state and the
    raw pre-conv tail, left-padded when l < cw - 1."""
    cfg, jcfg = ModelConfig(**SSM), JaxModelConfig(**SSM)
    jp, tp = _layer_params(0)
    u = np.random.default_rng(l).normal(size=(B, l, 64)).astype(np.float32)
    jout, jc = jax.jit(functools.partial(jssm.apply_mamba2, cfg=jcfg, return_state=True))(
        jp, u=jnp.asarray(u))
    with torch.no_grad():
        tout, tc = tssm.apply_mamba2(tp, cfg, _t(u), return_state=True)
    _close(tout, jout)
    assert sorted(tc) == ["conv", "state"] and tc["conv"].shape == (B, 3, 128 + 32)
    for k in tc:
        _close(tc[k], jc[k], msg=k)
    if l < 3:
        assert not tc["conv"][:, :3 - l].any()


def test_decode_mamba2_matches_jax_in_place():
    """Three single-token steps from the JAX block's cache: the port writes
    its state and conv window in place."""
    cfg, jcfg = ModelConfig(**SSM), JaxModelConfig(**SSM)
    jp, tp = _layer_params(1)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(B, 20, 64)).astype(np.float32)
    _, jc = jssm.apply_mamba2(jp, jcfg, jnp.asarray(u), return_state=True)
    tc = cache_from_numpy({"layers": _np_tree(jc), "pos": np.zeros(B, np.int32)},
                          device="cpu")["layers"]
    state, conv = tc["state"], tc["conv"]
    jstep = jax.jit(functools.partial(jssm.decode_mamba2, cfg=jcfg))
    for t in range(3):
        u1 = rng.normal(size=(B, 64)).astype(np.float32)
        jout, jc = jstep(jp, u1=jnp.asarray(u1), cache=jc)
        with torch.no_grad():
            tout = tssm.decode_mamba2(tp, cfg, _t(u1), tc)
        _close(tout, jout, msg=f"step {t}")
        assert tc["state"] is state and tc["conv"] is conv
        _close(state, jc["state"], msg=f"state, step {t}")
        _close(conv, jc["conv"], msg=f"conv, step {t}")


def test_ssm_model_forward_loss_and_grad_match_jax():
    jm, (tm, tp) = _jax_model(), _port(2)
    params = _jax_params(2)
    tok, lab = _tokens(2, (B, L)), _tokens(12, (B, L))
    lab[0, :5] = -1
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": _t(tok), "labels": _t(lab)}
    with torch.no_grad():
        _close(tm.forward(tp, tb), jax.jit(jm.forward)(params, jb))
    (jloss, jmet), jgrad = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(params, jb)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    loss, met = tm.loss_fn(tp, tb)
    loss.backward()
    _close(loss.detach(), jloss, 2e-3)
    _close(met["ce"].detach(), jmet["ce"], 2e-3)
    assert float(met["lb_loss"]) == 0.0 == float(met["z_loss"])
    want = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert list(tree_structure(tp)) == [tuple(k.key for k in p) for p, _ in want]
    for got, (path, g) in zip(tree_leaves(tp), want):
        assert torch.isfinite(got.grad).all()
        _close(got.grad, g, 1e-4, msg=str(path))
    assert float(tp["layers"]["mamba"]["A_log"].grad.abs().sum()) > 0


def test_ssm_prefill_matches_jax():
    tm, tp = _port(3)
    jl, jc = _jax_prefill(3)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": _t(_tokens(3, (B, L)))}, cache_size=L)
    _close(tl, jl)
    assert sorted(tc) == ["layers", "pos"] and sorted(tc["layers"]) == ["conv", "state"]
    assert tc["layers"]["state"].shape == (2, B, 4, 16, 32)
    assert tc["layers"]["conv"].shape == (2, B, 3, 160)
    for k in ("state", "conv"):
        _close(tc["layers"][k], jc["layers"][k], msg=k)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_ssm_decode_from_jax_prefill_matches_jax():
    """Four decode steps of each package from the JAX prefill's cache."""
    tm, tp = _port(3)
    params = _jax_params(3)
    _, jc = _jax_prefill(3)
    tc = cache_from_numpy(_np_tree(jc), device="cpu")
    extra = _tokens(4, (B, 4))
    for t in range(4):
        jlog, jc = _jax_decode()(params, jc, jnp.asarray(extra[:, t]))
        with torch.no_grad():
            tlog, out = tm.decode_step(tp, tc, _t(extra[:, t]))
        assert out is tc
        _close(tlog, jlog, msg=f"step {t}")
    for k in ("state", "conv"):
        _close(tc["layers"][k], jc["layers"][k], msg=k)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_cache_matches_jax(dtype):
    want = _jax_model().init_cache(3, 20, getattr(jnp, dtype))
    got = build_model(ModelConfig(**SSM)).init_cache(3, 20, getattr(torch, dtype),
                                                     device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("state", "conv"):
        g, w = got["layers"][k], want["layers"][k]
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.float().any()
    assert got["pos"].dtype == torch.int32 and not got["pos"].any()


@pytest.mark.parametrize("l", [40, 2], ids=["l=40", "l<cw-1"])
def test_ssm_decode_equals_teacher_forcing(l):
    """``tests/test_models.py:86`` on the port, from a prompt longer than a
    chunk and from one shorter than the conv window."""
    gen = torch.Generator()
    gen.manual_seed(5)
    tm = build_model(ModelConfig(**SSM))
    params = tm.init(gen, "cpu")
    tok = _t(_tokens(5, (B, l + 4)).astype(np.int64))
    with torch.no_grad():
        full = tm.forward(params, {"tokens": tok})
        lp, cache = tm.prefill(params, {"tokens": tok[:, :l]}, cache_size=l + 8)
        _close(lp, full[:, l - 1], 2e-3)
        for t in range(4):
            logits, cache = tm.decode_step(params, cache, tok[:, l + t])
            _close(logits, full[:, l + t], 5e-3, msg=f"step {t}")


def test_ssm_generate_greedy_matches_jax_loop():
    """Greedy ``generate`` = a JAX greedy loop over prefill / decode_step,
    token for token, every step's top-2 margin above 1e-4."""
    n_gen = 6
    tm, tp = _port(6)
    params = _jax_params(6)
    logits, cache = jax.jit(_jax_model().prefill, static_argnames="cache_size")(
        params, {"tokens": jnp.asarray(_tokens(6, (B, L)))}, cache_size=L + n_gen)
    want = []
    for step in range(n_gen):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1e-4).all(), f"tie at step {step}"
        want.append(np.asarray(jnp.argmax(logits, -1)))
        if step < n_gen - 1:
            logits, cache = _jax_decode()(params, cache, jnp.asarray(want[-1], jnp.int32))
    res = serve.generate(tm, tp, _t(_tokens(6, (B, L)).astype(np.int64)), gen=n_gen,
                         ring=False, cache_size=L + n_gen)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))
    _close(res.logits, logits)
    _close(res.cache["layers"]["state"], cache["layers"]["state"])


def test_serve_cli_mamba(capsys):
    rc = serve.main(["--arch", "mamba2-1.3b", "--reduced", "--requests", "2", "--batch", "2",
                     "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("batch 0: prefill 2x16 in ") and "decoded 4 tok" in out[0]
    assert out[-1].startswith("served 2 requests, 8 tokens, ") and "linear cache" in out[-1]
    with pytest.raises(SystemExit, match="no sliding window"):
        serve.main(["--arch", "mamba2-1.3b", "--reduced", "--ring", "--device", "cpu"])


def test_mamba2_params_on_meta_match_jax_shapes():
    """mamba2-1.3b at full width on the meta device has JAX's paths, shapes
    and dtypes: A_log, dt_bias and D in f32 beside bf16 weights."""
    want = jax.eval_shape(jax_build_model(jax_get_config("mamba2-1.3b")).init,
                          jax.random.PRNGKey(0))
    got = build_model(get_config("mamba2-1.3b")).init(None, "meta")
    want_paths = [tuple(k.key for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert list(tree_structure(got)) == want_paths
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    mamba = got["layers"]["mamba"]
    assert mamba["in_proj"].shape == (48, 2048, 2 * 4096 + 2 * 128 + 64)
    assert mamba["A_log"].dtype == torch.float32 and mamba["in_proj"].dtype == torch.bfloat16
    n = sum(t.numel() for t in tree_leaves(got))
    assert 1.4e9 < n < 1.5e9
