"""The paper's other scenarios and data on the port, against the JAX package.

* ``run`` on the noisy scenario (MNIST-like), the noisy, flipping and clean
  scenarios on the Spambase-like data (one sigmoid output, binary features,
  ``noisy_features``' 30 % bit-flip branch) and the alie and ipm update
  attacks, with dropout off and the JAX ``params0`` carried over, as
  ``tests/test_torch_slice.py`` runs clean and flipping: identical shards
  and minibatches, per-round similarities within ``SIM_TOL`` of the JAX
  run's, per-round test error within ``ERR_TOL_PP``, equal ``good_mask``
  histories and blocked rounds, on seeds where no screened similarity lies
  within ``SIM_TOL`` of its threshold (asserted);
* the same on AFA's tree form (``KernelPlan.layout="leaf"``, both variants)
  for the noisy scenario, where a decision sits nearest the threshold;
* the four numpy update-space helpers of ``attacks`` against the JAX
  package's, bit for bit on the same numpy inputs and generator;
* the poisoned shards of the noisy scenario byte-identical to the JAX
  package's, on the Spambase-like data (the bit-flip branch) and the
  MNIST-like data (the uniform-noise branch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.attacks as jattacks  # noqa: E402
import repro.fed.simulator as jax_simulator  # noqa: E402
import repro_torch.attacks as tattacks  # noqa: E402
import repro_torch.fed.simulator as torch_simulator  # noqa: E402
from repro.data import make_mnist_like as jax_make_mnist_like  # noqa: E402
from repro.data import make_spambase_like as jax_make_spambase_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed import run as jax_run  # noqa: E402
from repro.fed.workload import DnnWorkload as JDnnWorkload  # noqa: E402
from repro.kernels.policy import resolve_kernel_plan as jax_plan  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import afa as tafa  # noqa: E402
from repro_torch.core.stats import masked_median, masked_std  # noqa: E402
from repro_torch.data import iid_shards, make_mnist_like, make_spambase_like  # noqa: E402
from repro_torch.fed import DnnWorkload, ServerConfig, SimConfig, run  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

ERR_TOL_PP = 0.5      # percentage points: one test sample of 200
SIM_TOL = 1e-6        # similarity gap allowed, and threshold margin required

# K = 10 with 3 bad clients, as the paper's tables; 7 rounds, so a client
# can be blocked (in round min_rounds_to_block() = 6)
SIM_KW = dict(num_clients=10, bad_frac=0.3, rounds=7, local_epochs=2, batch_size=50,
              hidden=(32, 16), dropout=False)
DATASETS = {  # name -> (port maker, JAX maker, kwargs, output units)
    "mnist": (make_mnist_like, jax_make_mnist_like, dict(n_train=1000, n_test=200, dim=64), 10),
    "spambase": (make_spambase_like, jax_make_spambase_like, dict(n_train=1000, n_test=200), 1),
}


def _recording_server(monkeypatch, module, store):
    """Replace ``module.FedServer`` by a subclass recording each round's
    final screening similarities."""
    base = module.FedServer

    class Recording(base):
        def aggregate_tree(self, *args, **kwargs):
            agg, info = super().aggregate_tree(*args, **kwargs)
            store.append(np.asarray(info["similarities"]))
            return agg, info

    monkeypatch.setattr(module, "FedServer", Recording)


def parity_run(monkeypatch, dataset, scenario, seed, *, variant="iterative", launch="fused",
               layout="packed", engine="batched", sim_kw=SIM_KW):
    """The same experiment in both packages, the JAX ``params0`` carried
    over to the port; asserts the parity the module docstring states and
    returns ``(port result, JAX result)``."""
    make, jax_make, data_kw, out_units = DATASETS[dataset]
    K = sim_kw["num_clients"]
    jax_sims, torch_sims = [], []
    _recording_server(monkeypatch, jax_simulator, jax_sims)
    _recording_server(monkeypatch, torch_simulator, torch_sims)
    jres = jax_run(None, JSimConfig(scenario=scenario, seed=seed, engine=engine, **sim_kw),
                   JServerConfig(num_clients=K, afa_variant=variant,
                                 kernel_plan=jax_plan(False, layout)),
                   data=jax_make(seed=seed, **data_kw))

    data_np = make(seed=seed, **data_kw)
    sizes = (data_np.dim, *sim_kw["hidden"], out_units)
    p0 = JDnnWorkload(sizes).init_params(jax.random.PRNGKey(seed))
    p0_np = {k: np.asarray(v) for k, v in p0.items()}
    monkeypatch.setattr(DnnWorkload, "init_params",
                        lambda self, gen, device: params_from_numpy(p0_np, device=device))
    margins = []
    orig = tafa._mark_bad

    def recording_mark_bad(s, mask, xi, ddof):
        mu_bar = masked_median(s, mask)
        band = xi * masked_std(s, mask, ddof=ddof)
        live = s[mask]
        margins.append(float(torch.minimum((live - (mu_bar - band)).abs(),
                                           (live - (mu_bar + band)).abs()).min()))
        return orig(s, mask, xi, ddof)

    monkeypatch.setattr(tafa, "_mark_bad", recording_mark_bad)
    # the packed layout on the kernel route (the kernels' CPU twins); the
    # leaf layout runs AFA's tree form, which launches no kernel
    plan = resolve_kernel_plan(layout == "packed", layout, launch)
    tres = run(None, SimConfig(scenario=scenario, seed=seed, engine=engine, **sim_kw),
               ServerConfig(num_clients=K, afa_variant=variant, kernel_plan=plan),
               data=data_np, device="cpu")

    np.testing.assert_allclose(tres.test_error, jres.test_error, atol=ERR_TOL_PP, rtol=0)
    assert len(torch_sims) == len(jax_sims) == sim_kw["rounds"]
    np.testing.assert_allclose(np.stack(torch_sims), np.stack(jax_sims), atol=SIM_TOL, rtol=0)
    assert margins and min(margins) > SIM_TOL
    for tg, jg in zip(tres.good_mask_history, jres.good_mask_history):
        np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_array_equal(tres.blocked_round, jres.blocked_round)
    return tres, jres


@pytest.mark.parametrize("dataset,scenario", [
    ("mnist", "noisy"), ("spambase", "noisy"), ("spambase", "flipping"),
    ("spambase", "clean"), ("mnist", "alie"), ("mnist", "ipm"),
])
@pytest.mark.parametrize("variant,launch", [("iterative", "fused"), ("gram", "chained")])
def test_scenario_matches_jax(monkeypatch, dataset, scenario, variant, launch):
    tres, _ = parity_run(monkeypatch, dataset, scenario, 3, variant=variant, launch=launch)
    if scenario == "ipm":  # at this size ipm's forged rows are screened out
        np.testing.assert_array_equal(tres.blocked_round, [6, 6, 6] + [-1] * 7)


@pytest.mark.parametrize("dataset", ["mnist", "spambase"])
@pytest.mark.parametrize("variant", ["iterative", "gram"])
def test_tree_form_on_noisy_matches_jax(monkeypatch, dataset, variant):
    parity_run(monkeypatch, dataset, "noisy", 3, variant=variant, layout="leaf")


def _benign(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(7, 301)).astype(np.float32)


@pytest.mark.parametrize("call", [
    lambda m, u, rng: m.byzantine_update_attack(u[0], rng),
    lambda m, u, rng: m.byzantine_update_attack(u[0], rng, 3.0),
    lambda m, u, rng: m.alie_update_attack(u),
    lambda m, u, rng: m.alie_update_attack(u, z_max=0.7),
    lambda m, u, rng: m.ipm_update_attack(u),
    lambda m, u, rng: m.ipm_update_attack(u, eps=2.0),
    lambda m, u, rng: m.sign_flip_update_attack(u[1], u[0]),
    lambda m, u, rng: m.sign_flip_update_attack(u[1], u[0], 1.5),
], ids=["byzantine", "byzantine-scale", "alie", "alie-z", "ipm", "ipm-eps", "sign_flip",
        "sign_flip-scale"])
def test_numpy_update_attacks_match_jax(call):
    u = _benign(5)
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    want = call(jattacks, u, jrng)
    got = call(tattacks, u, trng)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # the caller's generator is consumed the same way
    assert trng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("dataset", ["spambase", "mnist"])
def test_noisy_shards_are_byte_identical(dataset):
    make, jax_make, data_kw, _ = DATASETS[dataset]
    sim = dict(SIM_KW, scenario="noisy", seed=4)
    tsetup = torch_simulator._Setup(make(seed=4, **data_kw), SimConfig(**sim),
                                    torch.device("cpu"))
    jsetup = jax_simulator._Setup(jax_make(seed=4, **data_kw), JSimConfig(**sim))
    data = make(seed=4, **data_kw)
    clean = iid_shards(data.x_train, data.y_train, SIM_KW["num_clients"], seed=4)
    assert len(tsetup.poisoned) == len(jsetup.poisoned) == SIM_KW["num_clients"]
    for k, ((tx, ty), (jx, jy)) in enumerate(zip(tsetup.poisoned, jsetup.poisoned)):
        for t, j in ((tx, jx), (ty, jy)):
            assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
        if k >= 3:
            assert tx.tobytes() == clean[k][0].tobytes()
        elif dataset == "spambase":  # 30 % of the bits flipped, still binary
            assert np.isin(tx, (0.0, 1.0)).all()
            assert 0.25 < float((tx != clean[k][0]).mean()) < 0.35
        else:
            assert not np.array_equal(tx, clean[k][0])
    assert tsetup.rng.bit_generator.state == jsetup.rng.bit_generator.state
