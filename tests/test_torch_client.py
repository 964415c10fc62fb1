"""The port's client layer and attacks against the JAX package: local SGD of
stacked clients (softmax and sigmoid losses), the test error, and the
update-level attacks.  Same numpy inputs; f32 tolerance rtol 1e-5 after a
few SGD steps (different summation orders), RNG-free outputs exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.attacks import alie_update_tree as jax_alie  # noqa: E402
from repro.attacks import ipm_update_tree as jax_ipm  # noqa: E402
from repro.fed.client import local_sgd as jax_local_sgd  # noqa: E402
from repro.fed.dnn import dnn_error as jax_dnn_error  # noqa: E402
from repro.fed.dnn import dnn_loss as jax_dnn_loss  # noqa: E402
from repro_torch.attacks import (  # noqa: E402
    alie_update_tree,
    byzantine_update_tree,
    ipm_update_tree,
)
from repro_torch.fed import DnnWorkload, EngineConfig  # noqa: E402
from repro_torch.fed.client import local_sgd  # noqa: E402
from repro_torch.fed.dnn import dnn_error, dnn_loss  # noqa: E402


def _params(sizes, rng):
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
        p[f"b{i}"] = (0.1 * rng.normal(size=b)).astype(np.float32)
    return p


@pytest.mark.parametrize("out_units", [10, 1])
def test_local_sgd_of_stacked_clients_matches_jax(out_units):
    rng = np.random.default_rng(out_units)
    sizes = (12, 16, 8, out_units)
    K, S, b = 3, 4, 20
    p0 = _params(sizes, rng)
    x = rng.normal(size=(K, S, b, 12)).astype(np.float32)
    y = rng.integers(0, max(out_units, 2), size=(K, S, b)).astype(np.int32)
    stacked = {k: torch.from_numpy(np.repeat(v[None], K, 0)) for k, v in p0.items()}
    got = local_sgd(dnn_loss, stacked, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                    lr=0.1, momentum=0.9)
    for k in range(K):
        want = jax_local_sgd(jax_dnn_loss, {n: jnp.asarray(v) for n, v in p0.items()},
                             {"x": jnp.asarray(x[k]), "y": jnp.asarray(y[k])},
                             jax.random.PRNGKey(0), lr=0.1, momentum=0.9, dropout=False)
        for n in p0:
            np.testing.assert_allclose(got[n][k].numpy(), np.asarray(want[n]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_units", [10, 1])
def test_dnn_loss_and_error_match_jax(out_units):
    rng = np.random.default_rng(7)
    p0 = _params((12, 16, 8, out_units), rng)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    y = rng.integers(0, max(out_units, 2), size=50).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    np.testing.assert_allclose(float(dnn_loss(tp, batch)),
                               float(jax_dnn_loss(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)})),
                               rtol=1e-5)
    assert float(dnn_error(tp, batch["x"], batch["y"])) == float(
        jax_dnn_error(jp, jnp.asarray(x), jnp.asarray(y)))


def test_dropout_masks_are_keyed_per_client_and_inverted():
    wl = DnnWorkload((6, 32, 16, 3))
    a = wl.dropout_keep([11, 12, 13], 2, 50, torch.device("cpu"))
    b = wl.dropout_keep([13], 2, 50, torch.device("cpu"))
    assert [m.shape for m in a] == [(3, 2, 50, 32), (3, 2, 50, 16)]
    assert torch.equal(a[0][2], b[0][0]) and torch.equal(a[1][2], b[1][0])
    assert 0.4 < float(a[0].float().mean()) < 0.6
    cfg = EngineConfig(dropout=True)
    p = wl.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = {"x": torch.randn(3, 2, 5, 6), "y": torch.zeros(3, 2, 5, dtype=torch.int64)}
    out = wl.local_update(cfg, p, batch, [1, 2, 3])
    assert out["w0"].shape == (3, 6, 32) and torch.isfinite(out["w0"]).all()


def _stack(rng, K):
    return {"w": rng.normal(size=(K, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(K, 3)).astype(np.float32)}


def test_alie_and_ipm_match_jax():
    rng = np.random.default_rng(3)
    K = 6
    st = _stack(rng, K)
    bad = np.array([1, 1, 0, 0, 0, 0], bool)
    benign = ~bad
    tt = {k: torch.from_numpy(v) for k, v in st.items()}
    jt = {k: jnp.asarray(v) for k, v in st.items()}
    for tfn, jfn in ((alie_update_tree, jax_alie), (ipm_update_tree, jax_ipm)):
        got = tfn(tt, torch.from_numpy(bad), torch.from_numpy(benign))
        want = jfn(jt, jnp.asarray(bad), jnp.asarray(benign))
        for k in st:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_byzantine_noise_is_keyed_by_original_client_id():
    rng = np.random.default_rng(4)
    st = {k: torch.from_numpy(v) for k, v in _stack(rng, 4).items()}
    prev = {k: torch.zeros(v.shape[1:]) for k, v in st.items()}
    bad = torch.tensor([True, False, True, False])
    full = byzantine_update_tree(st, prev, bad, 99, scale=20.0)
    assert torch.equal(full["w"][1], st["w"][1])
    assert 10.0 < float(full["w"][0].std()) < 40.0
    # the same clients compacted into other rows draw the same noise
    sub = {k: v[[2, 0]] for k, v in st.items()}
    moved = byzantine_update_tree(sub, prev, torch.tensor([True, True]), 99,
                                  scale=20.0, client_ids=[2, 0])
    assert torch.equal(moved["w"][0], full["w"][2]) and torch.equal(moved["b"][1], full["b"][0])
