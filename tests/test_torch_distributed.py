"""The port's whole-model federated round (``repro_torch.fed.distributed``)
against the JAX package's ``make_fed_round``.

Same numpy batches, and the JAX parameters converted through numpy, for
both, on the f32 ``tiny_lm`` of ``tests/test_fed.py``:

* every mode (``vmap``, ``scan`` storing float32, bfloat16 or int8 deltas,
  ``remat``), with one byzantine client (the train CLI's attack) and with a
  client blocked before the round: aggregate within 1e-5 / 1e-6, the
  posteriors (``alpha``, ``beta``, so ``good_mask`` on every participating
  client), ``blocked``, ``good_frac`` and ``afa_rounds`` exactly equal, the
  similarities within 1e-5 (with bfloat16 storage the aggregate within one
  bfloat16 ulp, 2**-7 relative: both packages round each proposal to
  bfloat16, and proposals 1e-7 apart can round to neighbours);
* the port's counterparts of ``tests/test_fed.py``'s mode checks (scan =
  vmap, remat = vmap with one screening pass, one observation a client,
  int8 storage within its quantization error) and of
  ``tests/test_compaction.py``'s (a blocked row skipped in ``scan``: its
  loss is never evaluated; ``compact_fed_batch``);
* ``microbatch=2`` = ``microbatch=1`` within float32 rounding;
* one reduced mamba2-1.3b round in ``vmap`` mode against the JAX one (the
  SSD's backward under ``torch.func.vmap``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import AFAConfig as JaxAFAConfig  # noqa: E402
from repro.core.reputation import ReputationState as JaxRep  # noqa: E402
from repro.fed.distributed import FedRoundConfig as JaxFedRoundConfig  # noqa: E402
from repro.fed.distributed import make_fed_round as jax_make_fed_round  # noqa: E402
from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core import AFAConfig, ReputationState, init_reputation  # noqa: E402
from repro_torch.fed.distributed import (  # noqa: E402
    FedRoundConfig,
    compact_fed_batch,
    make_fed_round,
)
from repro_torch.models import ModelConfig, build_model  # noqa: E402
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

TINY = dict(name="fed-lm", family="dense", num_layers=2, d_model=32, vocab_size=64,
            num_heads=2, num_kv_heads=2, d_ff=64, block_q=16, block_k=16)
K = 4
MODES = [("vmap", "float32"), ("scan", "float32"), ("scan", "bfloat16"), ("scan", "int8"),
         ("remat", "float32")]


@functools.lru_cache(maxsize=None)
def _models(name="tiny"):
    if name == "tiny":
        return jax_build_model(JaxModelConfig(**TINY)), build_model(ModelConfig(**TINY))
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    return (jax_build_model(jax_get_config(name).reduced().with_(**f32)),
            build_model(get_config(name).reduced().with_(**f32)))


@functools.lru_cache(maxsize=None)
def _jax_params(seed, name="tiny"):
    return jax.jit(_models(name)[0].init)(jax.random.PRNGKey(seed))


def _params(seed, name="tiny"):
    """The JAX parameters of ``seed`` and the port's copy of them."""
    p = _jax_params(seed, name)
    return p, model_params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_round(mode, proposal_dtype, max_rounds=8, name="tiny", lr=0.05):
    """One jitted JAX round a configuration, shared by the cases."""
    cfg = JaxFedRoundConfig(num_clients=K, local_steps=2, lr=lr, mode=mode,
                            proposal_dtype=proposal_dtype,
                            afa=JaxAFAConfig(max_rounds=max_rounds))
    return jax.jit(jax_make_fed_round(_models(name)[0], cfg))


def _round(mode, proposal_dtype="bfloat16", max_rounds=8, microbatch=1, name="tiny", lr=0.05):
    cfg = FedRoundConfig(num_clients=K, local_steps=2, lr=lr, mode=mode,
                         proposal_dtype=proposal_dtype, microbatch=microbatch,
                         afa=AFAConfig(max_rounds=max_rounds))
    return make_fed_round(_models(name)[1], cfg)


def _fed_batch(K=K, S=2, b=2, l=16, vocab=64, seed=0, byzantine=0):
    """``tests/test_fed.py``'s batch; the first ``byzantine`` clients get the
    train CLI's attack (labels constant, tokens 0)."""
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, (K, S, b, l)).astype(np.int32)
    lab = r.integers(0, vocab, (K, S, b, l)).astype(np.int32)
    lab[:byzantine] = 0
    tok[:byzantine] = 0
    return {"tokens": tok, "labels": lab}


def _rep(alpha, beta, blocked):
    return (JaxRep(jnp.asarray(alpha, jnp.float32), jnp.asarray(beta, jnp.float32),
                   jnp.asarray(blocked)),
            ReputationState(torch.tensor(alpha, dtype=torch.float32),
                            torch.tensor(beta, dtype=torch.float32), torch.tensor(blocked)))


CASES = {  # params seed, batch seed, byzantine clients, (alpha, beta, blocked)
    "byzantine": (0, 0, 1, ([3.0] * K, [3.0] * K, [False] * K)),
    "blocked": (1, 2, 0, ([5.0, 3.0, 3.0, 4.0], [3.0, 4.0, 9.0, 3.0],
                          [False, False, True, False])),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode,proposal_dtype", MODES, ids=[f"{m}-{d}" for m, d in MODES])
def test_round_matches_jax(mode, proposal_dtype, case):
    pseed, bseed, byz, rep0 = CASES[case]
    jp, tp = _params(pseed)
    batch = _fed_batch(seed=bseed, byzantine=byz)
    jrep, trep = _rep(*rep0)
    n_k = np.asarray([1.0, 2.0, 1.0, 3.0], np.float32)
    agg_j, rep_j, m_j = _jax_round(mode, proposal_dtype)(
        jp, jrep, jnp.asarray(n_k), {k: jnp.asarray(v) for k, v in batch.items()})
    agg_t, rep_t, m_t = _round(mode, proposal_dtype)(
        tp, trep, torch.from_numpy(n_k), {k: torch.from_numpy(v) for k, v in batch.items()})
    # bf16 storage rounds each proposal, and the aggregate, to bf16: an f32
    # proposal 1e-7 off a rounding boundary moves them by one bf16 ulp
    rtol = 2.0 ** -7 if proposal_dtype == "bfloat16" else 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(agg_j), tree_leaves(agg_t)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=1e-6)
    for field in ("alpha", "beta", "blocked"):
        np.testing.assert_array_equal(getattr(rep_t, field).numpy(),
                                      np.asarray(getattr(rep_j, field)), err_msg=field)
    assert float(m_t["good_frac"]) == float(m_j["good_frac"])
    assert int(m_t["afa_rounds"]) == int(m_j["afa_rounds"])
    np.testing.assert_allclose(m_t["similarities"].numpy(), np.asarray(m_j["similarities"]),
                               rtol=1e-5, atol=1e-5)
    if byz:  # the attack is screened out: the byzantine client's beta moved
        assert float(m_t["good_frac"]) == 0.75 and float(rep_t.beta[0]) == 4.0


def _torch_batch(**kw):
    return {k: torch.from_numpy(v) for k, v in _fed_batch(**kw).items()}


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_fed_round_modes_equivalent(mode):
    """``tests/test_fed.py::test_fed_round_modes_equivalent`` on the port."""
    _, params = _params(0)
    rep, n_k, batch = init_reputation(K, device="cpu"), torch.ones(K), _torch_batch()
    agg, _, metrics = _round(mode, "float32")(params, rep, n_k, batch)
    assert float(metrics["good_frac"]) > 0.5
    agg_v, _, _ = _round("vmap")(params, rep, n_k, batch)
    for a, b in zip(tree_leaves(agg), tree_leaves(agg_v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_fed_round_remat_matches_single_screen():
    """``tests/test_fed.py::test_fed_round_remat_matches_single_screen``:
    remat = vmap with ``max_rounds=1``."""
    _, params = _params(1)
    rep, n_k, batch = init_reputation(K, device="cpu"), torch.ones(K), _torch_batch(seed=2)
    agg_v, rep_v, _ = _round("vmap", max_rounds=1)(params, rep, n_k, batch)
    agg_r, rep_r, m_r = _round("remat", max_rounds=1)(params, rep, n_k, batch)
    assert torch.equal(rep_v.alpha, rep_r.alpha) and int(m_r["afa_rounds"]) == 1
    for a, b in zip(tree_leaves(agg_v), tree_leaves(agg_r)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)


def test_fed_round_moves_each_posterior_once():
    """``tests/test_fed.py::test_fed_round_rejects_poisoned_client``: one
    observation a client."""
    _, params = _params(3)
    rep = init_reputation(K, device="cpu")
    _, rep2, _ = _round("vmap")(params, rep, torch.ones(K), _torch_batch(seed=4))
    np.testing.assert_allclose((rep2.alpha + rep2.beta).numpy(),
                               (rep.alpha + rep.beta).numpy() + 1.0)


def test_fed_round_scan_int8_close_to_fp32():
    """``tests/test_fed.py::test_fed_round_scan_int8_close_to_fp32``: int8
    deltas within a twentieth of each leaf's largest update."""
    _, params = _params(9)
    rep, n_k, batch = init_reputation(K, device="cpu"), torch.ones(K), _torch_batch(seed=11)
    agg_f, rep_f, _ = _round("vmap")(params, rep, n_k, batch)
    agg_q, rep_q, _ = _round("scan", "int8")(params, rep, n_k, batch)
    assert torch.equal(rep_f.alpha, rep_q.alpha)
    for a, b, p in zip(tree_leaves(agg_f), tree_leaves(agg_q), tree_leaves(params)):
        delta_scale = float((a - p).abs().max()) + 1e-9
        err = float((a - b).abs().max())
        assert err <= 0.05 * delta_scale + 1e-7, (err, delta_scale)


class _LinearModel:
    """``tests/test_compaction.py``'s linear least-squares model, counting
    its loss evaluations by client (the batch's first target value)."""

    def __init__(self, count=True):
        self.calls = [] if count else None

    def loss_fn(self, params, batch, **kw):
        if self.calls is not None:
            self.calls.append(float(batch["y"].reshape(-1)[0]))
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}


def test_scan_mode_blocked_rows_skipped_and_masked_out():
    """``tests/test_compaction.py::test_scan_mode_blocked_rows_skipped_and_
    masked_out`` on the port: scan = vmap with client 1 blocked, whose loss
    is never evaluated in scan mode and whose posterior stays as it was."""
    rng = np.random.default_rng(0)
    S, b, d = 2, 8, 6
    x = rng.normal(size=(K, S, b, d)).astype(np.float32)
    y = rng.normal(size=(K, S, b)).astype(np.float32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    params = {"w": torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))}
    rep = init_reputation(K, device="cpu")._replace(
        blocked=torch.tensor([False, True, False, False]))
    model = _LinearModel()
    agg_scan, rep2, _ = make_fed_round(model, FedRoundConfig(
        num_clients=K, local_steps=S, proposal_dtype="float32", mode="scan"))(
        params, rep, torch.ones(K), batch)
    # one loss a local step, keyed by the step's first target value
    assert sorted(model.calls) == sorted(float(y[k, t, 0]) for k in (0, 2, 3) for t in range(S))
    agg_vmap, _, _ = make_fed_round(_LinearModel(count=False), FedRoundConfig(
        num_clients=K, local_steps=S, mode="vmap"))(params, rep, torch.ones(K), batch)
    np.testing.assert_allclose(agg_scan["w"].numpy(), agg_vmap["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert bool(rep2.blocked[1]) and float(rep2.alpha[1]) == float(rep.alpha[1])


def test_compact_fed_batch_gathers_live_rows():
    """``tests/test_compaction.py::test_compact_fed_batch_gathers_live_rows``
    on the port, and the refusal to drop a live client."""
    rng = np.random.default_rng(1)
    rep = init_reputation(5, device="cpu")._replace(
        blocked=torch.tensor([False, True, False, True, False]))
    x = rng.normal(size=(5, 3, 2)).astype(np.float32)
    n_k = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    batch_c, n_k_c, rep_c, keep = compact_fed_batch({"x": torch.from_numpy(x)}, n_k, rep,
                                                    pad_to=4)
    np.testing.assert_array_equal(keep, [0, 2, 4])
    assert tuple(batch_c["x"].shape) == (4, 3, 2)
    np.testing.assert_array_equal(n_k_c.numpy(), [1.0, 3.0, 5.0, 0.0])
    np.testing.assert_array_equal(batch_c["x"][:3].numpy(), x[[0, 2, 4]])
    assert not batch_c["x"][3].any()
    assert not rep_c.blocked[:3].any() and rep_c.blocked[3:].all()
    assert float(rep_c.alpha[3]) == 1.0 and float(rep_c.beta[3]) == 1.0
    _, _, _, keep = compact_fed_batch({"x": torch.from_numpy(x)}, n_k, rep)
    np.testing.assert_array_equal(keep, [0, 2, 4])
    with pytest.raises(ValueError, match="refusing to truncate"):
        compact_fed_batch({"x": torch.from_numpy(x)}, n_k, rep, pad_to=2)


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_microbatch_matches_full_batch(mode):
    """Two accumulation chunks a step = the full minibatch's gradient, within
    float32 rounding (the loss is a mean over equal chunks)."""
    _, params = _params(0)
    rep, n_k, batch = init_reputation(K, device="cpu"), torch.ones(K), _torch_batch(seed=5)
    agg1, rep1, _ = _round(mode, "float32")(params, rep, n_k, batch)
    agg2, rep2, _ = _round(mode, "float32", microbatch=2)(params, rep, n_k, batch)
    assert torch.equal(rep1.alpha, rep2.alpha)
    for a, b in zip(tree_leaves(agg1), tree_leaves(agg2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_mamba2_vmap_round_matches_jax():
    """A reduced mamba2-1.3b (f32) round in vmap mode: the SSD's backward
    under ``torch.func.vmap``."""
    name = "mamba2-1.3b"
    cfg = get_config(name).reduced()
    jp, tp = _params(0, name)
    batch = _fed_batch(S=2, b=1, l=24, vocab=cfg.vocab_size, seed=6, byzantine=1)
    jrep, trep = _rep(*CASES["byzantine"][3])
    agg_j, rep_j, m_j = _jax_round("vmap", "bfloat16", name=name, lr=0.5)(
        jp, jrep, jnp.ones((K,)), {k: jnp.asarray(v) for k, v in batch.items()})
    agg_t, rep_t, m_t = _round("vmap", name=name, lr=0.5)(
        tp, trep, torch.ones(K), {k: torch.from_numpy(v) for k, v in batch.items()})
    for a, b in zip(jax.tree_util.tree_leaves(agg_j), tree_leaves(agg_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rep_t.beta.numpy(), np.asarray(rep_j.beta))
    np.testing.assert_allclose(m_t["similarities"].numpy(), np.asarray(m_j["similarities"]),
                               rtol=1e-5, atol=1e-5)
