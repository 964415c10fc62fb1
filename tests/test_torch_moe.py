"""The port's MoE family against the JAX package's.

``apply_moe`` with drops (cf 1.0) and dropless (cf = E/k) within 1e-5 (y)
and 1e-6 (the aux losses), from the JAX layer's parameters; a tiny MoE
model's forward and loss with its aux terms within 1e-5, prefill and
decode against the JAX model; decode = teacher forcing on the dropless model
(``tests/test_models.py:25``, ``:86``); olmoe-1b-7b and phi3.5-moe
parameter shapes on the meta device against JAX's ``eval_shape``.
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_structure  # noqa: E402

E, K = 4, 2
TINY = dict(name="t-moe", family="moe", num_layers=2, d_model=32, vocab_size=64,
            num_heads=4, num_kv_heads=2, d_ff=48, block_q=16, block_k=16,
            num_experts=E, top_k=K)
B, L = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("cf", [1.0, E / K], ids=["drops", "dropless"])
def test_apply_moe_matches_jax(cf, activation):
    p = jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3, 4, 5))(
        jax.random.PRNGKey(0), 32, 48, E, activation, jnp.float32)
    x = np.random.default_rng(0).normal(size=(B, L, 32)).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf, activation=activation)
    jy, (jlb, jz) = jax.jit(functools.partial(jmoe.apply_moe, **kw))(p, jnp.asarray(x))
    tp = model_params_from_numpy(_np_tree(p), device="cpu")
    assert tp["router"].dtype == torch.float32
    assert sorted(tp) == sorted(tmoe.init_moe(torch.Generator(), 32, 48, E, activation,
                                              torch.float32, device="meta"))
    y, (lb, z) = tmoe.apply_moe(tp, torch.from_numpy(x), **kw)
    _close(y, jy, 1e-5)
    _close(lb, jlb, 1e-6)
    _close(z, jz, 1e-6)
    # at cf 1.0 some choices overflow their expert (their tokens get less
    # than the full gated sum), dropless none do
    cap = max(int(L * K / E * cf), 1)
    idx = torch.topk(torch.from_numpy(x) @ tp["router"], K, dim=-1).indices
    load = torch.stack([torch.bincount(r.flatten(), minlength=E) for r in idx])
    assert bool((load > cap).any()) == (cf == 1.0)


@functools.lru_cache(maxsize=None)
def _jax_model(cf=1.25):
    return jax_build_model(JaxModelConfig(**TINY, capacity_factor=cf))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    """The JAX parameters of ``seed``, from one compiled init."""
    return jax.jit(_jax_model().init)(jax.random.PRNGKey(seed))


def _models(seed, cf=1.25, pallas=False):
    tm = build_model(ModelConfig(**TINY, capacity_factor=cf, use_pallas_attention=pallas))
    params = _jax_params(seed)
    return (_jax_model(cf), tm, params,
            model_params_from_numpy(_np_tree(params), device="cpu"))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("pallas", [False, True], ids=["blocked", "flash-twin"])
def test_tiny_moe_model_matches_jax(pallas):
    """Forward and loss (with the router's aux terms) from the JAX
    parameters, within 1e-5: the flash kernel's CPU twin is exact."""
    jm, tm, params, tp = _models(1, pallas=pallas)
    tok = _tokens(1, (B, L))
    lab = np.random.default_rng(2).integers(-1, 64, (B, L)).astype(np.int32)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tok)})
    jloss, jmet = jax.jit(jm.loss_fn)(params, {"tokens": jnp.asarray(tok),
                                                "labels": jnp.asarray(lab)})
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
        loss, met = tm.loss_fn(tp, {"tokens": torch.from_numpy(tok),
                                    "labels": torch.from_numpy(lab)})
    _close(got, want, 1e-5)
    for g, w in ((loss, jloss), (met["ce"], jmet["ce"]), (met["lb_loss"], jmet["lb_loss"]),
                 (met["z_loss"], jmet["z_loss"])):
        _close(g, w, 1e-5)
    assert float(met["lb_loss"]) > 0 and float(met["z_loss"]) > 0
    assert float(loss) > float(met["ce"])


def test_moe_prefill_and_decode_match_jax():
    """Prefill's logits and cache, then 4 decode steps of each package from
    the JAX prefill's cache."""
    jm, tm, params, tp = _models(3)
    tok = _tokens(3, (B, L))
    jl, jc = jax.jit(jm.prefill, static_argnames="cache_size")(
        params, {"tokens": jnp.asarray(tok)}, cache_size=L + 4)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, cache_size=L + 4)
    _close(tl, jl, 1e-5)
    for got, want in zip(tc["layers"], jc["layers"]):
        _close(got, want, 1e-5)
    tc = cache_from_numpy(_np_tree(jc), device="cpu")
    extra = _tokens(4, (B, 4))
    jdecode = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(4):
            jlog, jc = jdecode(params, jc, jnp.asarray(extra[:, t]))
            tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(extra[:, t]))
            _close(tlog, jlog, 1e-5, msg=f"step {t}")


def test_dropless_moe_decode_equals_teacher_forcing():
    gen = torch.Generator()
    gen.manual_seed(5)
    tm = build_model(ModelConfig(**TINY, capacity_factor=E / K))
    params = tm.init(gen, "cpu")
    tok = torch.from_numpy(_tokens(5, (B, L + 4)).astype(np.int64))
    with torch.no_grad():
        full = tm.forward(params, {"tokens": tok})
        lp, cache = tm.prefill(params, {"tokens": tok[:, :L]}, cache_size=L + 8)
        _close(lp, full[:, L - 1], 2e-3)
        for t in range(4):
            logits, cache = tm.decode_step(params, cache, tok[:, L + t])
            _close(logits, full[:, L + t], 5e-3, msg=f"step {t}")


def test_moe_trains_and_keeps_the_router_in_f32():
    cfg = ModelConfig(**TINY, param_dtype="bfloat16", compute_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(6)
    params = build_model(cfg).init(gen, "cpu")
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["router"].shape == (2, 32, E)
    assert all(moe[n].dtype == torch.bfloat16 for n in ("gate", "up", "down"))
    # dense_init's fan-in is shape[0] = E for the experts, as in the reference
    assert float(moe["up"].float().abs().max()) <= 2 / np.sqrt(E) + 1e-2
    assert float(moe["up"].float().std()) > 0.8 / np.sqrt(E)
    f32 = build_model(ModelConfig(**TINY))
    p32 = f32.init(gen, "cpu")
    p32["layers"]["moe"]["up"].requires_grad_(True)
    tok = torch.from_numpy(_tokens(6, (B, L)).astype(np.int64))
    loss, _ = f32.loss_fn(p32, {"tokens": tok, "labels": tok})
    loss.backward()
    grad = p32["layers"]["moe"]["up"].grad
    assert torch.isfinite(grad).all() and float(grad.abs().sum()) > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_param_shapes_equal_jax_eval_shape(arch):
    want = jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    got = build_model(get_config(arch)).init(None, "meta")
    want_paths = [tuple(k.key for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert list(tree_structure(got)) == want_paths
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
