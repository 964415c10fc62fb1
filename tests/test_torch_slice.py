"""The port's main path as a whole against the JAX package.

(a) clean / flipping with dropout off and the JAX ``params0`` carried over:
    identical shards and minibatches, per-round test error within 0.5
    percentage points (one test sample of 200), per-round similarities
    within 1e-6 of the JAX run's, and equal ``good_mask`` histories, on
    seeds where no screened similarity lies within that 1e-6 of its
    threshold, so an f32 difference cannot flip a decision.  (Clients send
    whole models, so similarities sit near 1 and their spread is ~1e-5; the
    gap between the two packages measured at most 3.6e-7 over 16 runs.)
(b) byzantine with the port's own RNG: bad clients blocked in round
    ``min_rounds_to_block()`` (= 6), good clients never;
plus the import hygiene of the package and the device contract of ``run``
and of the public constructors.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.fed.simulator as jax_simulator  # noqa: E402
import repro_torch.fed.simulator as torch_simulator  # noqa: E402
from repro.data import make_mnist_like as jax_make_mnist_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed import run as jax_run  # noqa: E402
from repro.fed.workload import DnnWorkload as JDnnWorkload  # noqa: E402
from repro.fed import init_server_state as jax_init_state  # noqa: E402
from repro_torch.convert import params_from_numpy, server_state_from_numpy  # noqa: E402
from repro_torch.core import afa as tafa  # noqa: E402
from repro_torch.core import init_reputation, min_rounds_to_block  # noqa: E402
from repro_torch.core.stats import masked_median, masked_std  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    DnnWorkload,
    ServerConfig,
    SimConfig,
    SimResult,
    SweepResult,
    init_dnn,
    init_server_state,
    run,
)
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

ERR_TOL_PP = 0.5      # percentage points: one test sample of 200
SIM_TOL = 1e-6        # similarity gap allowed, and threshold margin required

SIM_KW = dict(num_clients=6, bad_frac=1 / 3, rounds=4, local_epochs=1,
              batch_size=50, hidden=(32, 16), dropout=False)
DATA_KW = dict(n_train=600, n_test=200, dim=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_synthetic_data_is_byte_identical():
    a = make_mnist_like(seed=4, **DATA_KW)
    b = jax_make_mnist_like(seed=4, **DATA_KW)
    for x, y in zip(a[:4], b[:4]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


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


@pytest.mark.parametrize("scenario,seed", [("clean", 3), ("flipping", 3)])
@pytest.mark.parametrize("variant,launch", [("iterative", "fused"), ("gram", "chained")])
def test_slice_matches_jax(monkeypatch, scenario, seed, variant, launch):
    data_np = make_mnist_like(seed=seed, **DATA_KW)
    jax_sims, torch_sims = [], []
    _recording_server(monkeypatch, jax_simulator, jax_sims)
    _recording_server(monkeypatch, torch_simulator, torch_sims)
    jsim = JSimConfig(scenario=scenario, seed=seed, **SIM_KW)
    jserver = JServerConfig(num_clients=6, afa_variant=variant)
    jres = jax_run(None, jsim, jserver, data=jax_make_mnist_like(seed=seed, **DATA_KW))

    sizes = (DATA_KW["dim"], *SIM_KW["hidden"], 10)
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
    tsim = SimConfig(scenario=scenario, seed=seed, **SIM_KW)
    tserver = ServerConfig(num_clients=6, afa_variant=variant,
                           kernel_plan=resolve_kernel_plan(True, kernel_launch=launch))
    tres = run(None, tsim, tserver, data=data_np, device="cpu")

    np.testing.assert_allclose(tres.test_error, jres.test_error, atol=ERR_TOL_PP, rtol=0)
    assert len(torch_sims) == len(jax_sims) == SIM_KW["rounds"]
    np.testing.assert_allclose(np.stack(torch_sims), np.stack(jax_sims), atol=SIM_TOL, rtol=0)
    assert margins and min(margins) > SIM_TOL
    for tg, jg in zip(tres.good_mask_history, jres.good_mask_history):
        np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_array_equal(tres.blocked_round, jres.blocked_round)


@pytest.mark.parametrize("variant,launch", [
    ("iterative", "fused"), ("gram", "chained"), ("gram", "fused"),
])
def test_byzantine_clients_block_in_minimum_rounds(variant, launch):
    data = make_mnist_like(n_train=1000, n_test=200, dim=64)
    sim = SimConfig(num_clients=10, scenario="byzantine", rounds=7, local_epochs=1,
                    batch_size=50, hidden=(32, 16), seed=3)
    server = ServerConfig(num_clients=10, afa_variant=variant,
                          kernel_plan=resolve_kernel_plan(True, kernel_launch=launch))
    res = run(None, sim, server, data=data, device="cpu")
    n_min = min_rounds_to_block()
    assert n_min == 6
    np.testing.assert_array_equal(res.blocked_round[res.bad_clients], [n_min] * 3)
    good = np.setdiff1d(np.arange(10), res.bad_clients)
    np.testing.assert_array_equal(res.blocked_round[good], [-1] * len(good))
    assert res.detection_rate == 1.0


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.kernels.build\n"
        "from repro_torch.data import make_mnist_like\n"
        "from repro_torch.fed import ServerConfig, SimConfig, run\n"
        "from repro_torch.kernels.policy import resolve_kernel_plan\n"
        "data = make_mnist_like(n_train=200, n_test=50, dim=16)\n"
        "for v, l in (('iterative', 'fused'), ('gram', 'chained'), ('gram', 'fused')):\n"
        "    run(None, SimConfig(num_clients=4, scenario='byzantine', rounds=2,\n"
        "        local_epochs=1, batch_size=25, hidden=(8, 4)),\n"
        "        ServerConfig(num_clients=4, afa_variant=v,\n"
        "        kernel_plan=resolve_kernel_plan(True, kernel_launch=l)),\n"
        "        data=data, device='cpu')\n"
        "from repro_torch.serve import run_serve_replay\n"
        "run_serve_replay(data, SimConfig(num_clients=4, scenario='byzantine', rounds=2,\n"
        "    local_epochs=1, batch_size=25, hidden=(8, 4)), ServerConfig(num_clients=4),\n"
        "    device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_run_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_mnist_like(n_train=100, n_test=20, dim=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(None, SimConfig(num_clients=2, rounds=1, hidden=(4,)), data=data)


@pytest.mark.parametrize("build", [
    lambda: init_server_state(3),
    lambda: init_reputation(3),
    lambda: params_from_numpy({"w0": np.ones((2, 2), np.float32)}),
    lambda: server_state_from_numpy(jax_init_state(3)),
    lambda: init_dnn(torch.Generator(), (4, 3, 2)),
], ids=["init_server_state", "init_reputation", "params_from_numpy",
        "server_state_from_numpy", "init_dnn"])
def test_constructors_default_to_cuda_and_raise_without_it(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_unported_routes_raise():
    data = make_mnist_like(n_train=100, n_test=20, dim=8)
    sim = SimConfig(num_clients=2, rounds=1, hidden=(4,))
    sweep = run(None, sim, data=data, seeds=[0, 1], device="cpu")
    assert isinstance(sweep, SweepResult) and sweep.blocked_round.shape == (2, 2)
    assert sweep.test_error.shape == (2, 1) and list(sweep.seeds) == [0, 1]
    # the client-sharded engine runs on the fused engine, inside a process
    # group of client_shards ranks (tests/test_torch_client_shards.py)
    with pytest.raises(ValueError, match="client_shards requires engine='fused'"):
        run(None, SimConfig(num_clients=2, rounds=1, hidden=(4,), client_shards=2),
            data=data, device="cpu")
    with pytest.raises(RuntimeError, match="run_sharded"):
        run(None, SimConfig(num_clients=2, rounds=1, hidden=(4,), client_shards=2,
                            engine="fused"), data=data, device="cpu")
    looped = run(None, SimConfig(num_clients=2, rounds=1, hidden=(4,), engine="looped"),
                 data=data, device="cpu")
    assert isinstance(looped, SimResult) and looped.blocked_round.shape == (2,)
