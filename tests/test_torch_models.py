"""The port's dense transformer stack against the JAX package's.

Same numpy inputs (and the JAX parameters, converted through numpy) for
both.  Layers agree within 1e-5 (f32); the tiny dense model's logits and
loss within 2e-3 on both attention routes, the tolerance
``tests/test_models.py:256`` holds the JAX Pallas route to.  smollm-135m is
compared by parameter shapes only: the port builds it on the meta device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALIASES as JAX_ALIASES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import ALIASES, get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_structure  # noqa: E402

TINY = dict(name="t-dense", family="dense", num_layers=2, d_model=32, vocab_size=64,
            num_heads=4, num_kv_heads=2, d_ff=64, block_q=16, block_k=16)
ACTIVATIONS = ["swiglu", "geglu", "squared_relu", "gelu"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    w = rng.normal(size=24).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_matches_jax(activation):
    p = jl.init_mlp(jax.random.PRNGKey(2), 16, 40, activation, jnp.float32)
    x = np.random.default_rng(2).normal(size=(4, 7, 16)).astype(np.float32)
    want = np.asarray(jl.apply_mlp(p, jnp.asarray(x), activation))
    tp = model_params_from_numpy(_np_tree(p), device="cpu")
    assert sorted(tp) == sorted(tl.init_mlp(torch.Generator(), 16, 40, activation,
                                            torch.float32, device="cpu"))
    got = tl.apply_mlp(tp, torch.from_numpy(x), activation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dense_init_is_a_truncated_fan_in_normal():
    gen = torch.Generator()
    gen.manual_seed(0)
    w = tl.dense_init(gen, (400, 300), torch.float32, device="cpu")
    s = 1.0 / np.sqrt(400)
    assert float(w.abs().max()) <= 2 * s + 1e-7
    # a N(0, 1) cut at +-2 has std 0.8796
    assert abs(float(w.std()) / s - 0.8796) < 0.01


def _batch(seed=0, b=2, l=40, vocab=64):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, l)).astype(np.int32)
    lab = rng.integers(-1, vocab, size=(b, l)).astype(np.int32)  # -1: masked
    return tok, lab


@pytest.mark.parametrize("pallas,activation", [(False, "swiglu"), (True, "gelu")],
                         ids=["blocked-swiglu", "flash-kernel-gelu"])
def test_tiny_dense_model_matches_jax(pallas, activation):
    """Forward and loss from the JAX parameters, on the route the config
    picks: the flash kernel's twin or the plain blocked attention (the JAX
    side: its Pallas kernel in interpret mode, or its blocked attention)."""
    jm = jax_build_model(JaxModelConfig(**TINY, activation=activation,
                                        use_pallas_attention=pallas))
    tm = build_model(ModelConfig(**TINY, activation=activation, use_pallas_attention=pallas))
    params = jm.init(jax.random.PRNGKey(3))
    tp = model_params_from_numpy(_np_tree(params), device="cpu")
    tok, lab = _batch()
    want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(tok)}))
    jloss, jmet = jm.loss_fn(params, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    ops.reset_launch_counts()
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
        loss, met = tm.loss_fn(tp, {"tokens": torch.from_numpy(tok),
                                    "labels": torch.from_numpy(lab)})
    assert got.dtype == torch.float32 and got.shape == (2, 40, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=2e-3, atol=2e-3)
    assert float(met["lb_loss"]) == 0.0 == float(met["z_loss"])
    assert ops.LAUNCH_COUNTS["flash_attn"] == 0  # the CPU twin is no launch


def test_flash_route_follows_the_config_and_the_policy(monkeypatch):
    """use_pallas_attention routes through ops.flash_attention unless the
    policy vetoes kernels or a prefix-LM span is set (blocks.py:88)."""
    from repro_torch.models import blocks

    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    cfg = ModelConfig(**TINY, use_pallas_attention=True)
    tm = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tm.init(gen, "cpu")
    tok, _ = _batch()
    with torch.no_grad():
        tm.forward(params, {"tokens": torch.from_numpy(tok)})
    assert len(calls) == cfg.num_layers
    assert calls[0] == dict(causal=True, block_q=16, block_k=16)
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "torch")
    assert not blocks.uses_flash_kernel(cfg)
    monkeypatch.delenv("REPRO_TORCH_KERNELS")
    assert not blocks.uses_flash_kernel(cfg.with_(prefix_len=4))
    assert blocks.uses_flash_kernel(cfg)


def test_kernel_route_refuses_to_train():
    """Training through the flash kernel raises, as the JAX package cannot
    differentiate its Pallas kernel; the plain route trains."""
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = ModelConfig(**TINY)
    params = build_model(cfg).init(gen, "cpu")
    params["layers"]["attn"]["wq"].requires_grad_(True)
    tok, lab = _batch()
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    with pytest.raises(RuntimeError, match="no backward"):
        build_model(cfg.with_(use_pallas_attention=True)).loss_fn(params, batch)
    loss, _ = build_model(cfg).loss_fn(params, batch)
    loss.backward()
    assert torch.isfinite(params["layers"]["attn"]["wq"].grad).all()


def test_smollm_param_shapes_equal_jax_eval_shape():
    """Full smollm-135m: the port's parameter tree (built on the meta device,
    nothing allocated) has JAX's paths, shapes and dtypes."""
    cfg = get_config("smollm-135m")
    want = jax.eval_shape(jax_build_model(jax_get_config("smollm-135m")).init,
                          jax.random.PRNGKey(0))
    got = build_model(cfg).init(None, "meta")
    want_paths = [tuple(k.key for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert list(tree_structure(got)) == want_paths
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got["layers"]["attn"]["wk"].shape == (30, 576, 192)


def test_config_registry_is_a_copy_of_jax():
    assert ALIASES == JAX_ALIASES
    for arch in ALIASES:
        got, want = dataclasses.asdict(get_config(arch)), dataclasses.asdict(jax_get_config(arch))
        assert got == want, arch
        assert str(get_config(arch).pdtype).split(".")[-1] == str(jax_get_config(arch).pdtype)
    red = get_config("smollm-135m").reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(jax_get_config("smollm-135m").reduced())


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_every_registry_arch_builds_on_meta(arch):
    """Every architecture of the registry builds, its parameters on the meta
    device in the config's dtype, with the cache tree its family serves
    from (none for an encoder's decode)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(None, "meta")
    leaves = tree_leaves(params)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert params["head"].shape == (cfg.d_model, cfg.vocab_size)
    assert params["head"].dtype == cfg.pdtype
    cache = model.init_cache(2, 16, device="meta")
    assert sorted(cache) == (["layers", "pos", "shared"] if cfg.family == "hybrid"
                             else ["layers", "pos"])


def test_bf16_params_convert_through_float32():
    """np.asarray of a JAX bf16 leaf is ml_dtypes.bfloat16, which
    torch.from_numpy rejects; the converter goes through f32, exactly."""
    cfg = JaxModelConfig(**{**TINY, "param_dtype": "bfloat16", "compute_dtype": "bfloat16"})
    params = jax_build_model(cfg).init(jax.random.PRNGKey(4))
    tp = model_params_from_numpy(_np_tree(params), device="cpu")
    wq = tp["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    want = np.asarray(params["layers"]["attn"]["wq"].astype(jnp.float32))
    np.testing.assert_array_equal(wq.float().numpy(), want)


def test_model_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(ModelConfig(**TINY)).init(torch.Generator())
