"""The aggregation layout on the port's fused and segmented engines, on the
CPU, at the JAX package's test size (1000 training samples of dimension
196, hidden (64, 32)).  The reference's ``_round_body`` honours
``agg_layout`` (``repro/fed/engine.py:328``), and so does the port's:

* ``"tree"`` hands the stacked tree to the tree dispatch, which packs it
  again: the same bits as ``"packed"`` (test error, ``good_mask`` history,
  blocked rounds), on the fused, fused-eager and segmented engines, for
  AFA and for a rule with no tree form;
* ``"leaf"`` runs AFA's tree form (``core.afa.afa_aggregate_tree``, its
  screening unrolled as the fused body asks) once a round, and makes the
  decisions of the packed run and of the reference's fused run of the
  same layout on the same numpy data and initial parameters: every
  byzantine client blocked in round ``min_rounds_to_block()``, no good one;
* an unknown layout raises, and the client-sharded engine keeps its packed
  layout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import make_mnist_like as jax_make_mnist_like  # noqa: E402
from repro.fed import ServerConfig as JServerConfig  # noqa: E402
from repro.fed import SimConfig as JSimConfig  # noqa: E402
from repro.fed import run as jax_run  # noqa: E402
from repro.fed.workload import DnnWorkload as JDnnWorkload  # noqa: E402
from repro.kernels.policy import resolve_kernel_plan as jresolve_kernel_plan  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import afa as tafa  # noqa: E402
from repro_torch.core import min_rounds_to_block  # noqa: E402
from repro_torch.data import make_mnist_like  # noqa: E402
from repro_torch.fed import DnnWorkload, ServerConfig, SimConfig, run  # noqa: E402
from repro_torch.fed import engine as tengine  # noqa: E402
from repro_torch.kernels.policy import resolve_kernel_plan  # noqa: E402

DATA_KW = dict(n_train=1000, n_test=300, dim=196)
K = 10
# what tests/test_fused_engine.py:74 allows between engines whose streams differ
ENGINE_TOL_PP = 15.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_mnist_like(**DATA_KW)


def _sim(engine, **kw):
    base = dict(num_clients=K, bad_frac=0.3, scenario="byzantine", rounds=8, local_epochs=2,
                batch_size=100, hidden=(64, 32), dropout=True, seed=3, engine=engine)
    return SimConfig(**{**base, **kw})


def _server(layout, rule="afa", **kw):
    return ServerConfig(rule=rule, num_clients=K,
                        kernel_plan=resolve_kernel_plan(False, layout), **kw)


def _same_trajectory(a, b):
    np.testing.assert_array_equal(np.asarray(a.test_error), np.asarray(b.test_error))
    np.testing.assert_array_equal(np.stack(a.good_mask_history), np.stack(b.good_mask_history))
    np.testing.assert_array_equal(a.blocked_round, b.blocked_round)


def _blocks_the_attackers(res):
    bad = np.asarray(res.bad_clients)
    good = np.setdiff1d(np.arange(K), bad)
    blocked = np.asarray(res.blocked_round)
    np.testing.assert_array_equal(blocked[bad], [min_rounds_to_block()] * len(bad))
    np.testing.assert_array_equal(blocked[good], [-1] * len(good))


@pytest.mark.parametrize("engine,rule", [("fused", "afa"), ("fused_eager", "afa"),
                                         ("fused", "mkrum"), ("fused", "comed")])
def test_tree_layout_equals_packed_bit_for_bit(data, engine, rule):
    packed = run(None, _sim(engine), _server("packed", rule), data=data, device="cpu")
    tree = run(None, _sim(engine), _server("tree", rule), data=data, device="cpu")
    _same_trajectory(tree, packed)


def test_tree_layout_equals_packed_on_the_segmented_engine(data):
    sim = _sim("fused", segment_rounds=3)
    packed = run(None, sim, _server("packed"), data=data, device="cpu")
    tree = run(None, sim, _server("tree"), data=data, device="cpu")
    _same_trajectory(tree, packed)
    _blocks_the_attackers(tree)


def test_leaf_layout_runs_afas_tree_form_each_round(data, monkeypatch):
    calls = []
    tree_form = tafa.afa_aggregate_tree

    def counted(*args, **kw):
        calls.append(kw.get("unroll"))
        return tree_form(*args, **kw)

    monkeypatch.setattr(tafa, "afa_aggregate_tree", counted)
    leaf = run(None, _sim("fused"), _server("leaf"), data=data, device="cpu")
    assert calls == [True] * 8   # one a round, its screening unrolled (capturable)
    calls.clear()
    packed = run(None, _sim("fused"), _server("packed"), data=data, device="cpu")
    assert calls == []
    np.testing.assert_array_equal(np.stack(leaf.good_mask_history),
                                  np.stack(packed.good_mask_history))
    np.testing.assert_array_equal(leaf.blocked_round, packed.blocked_round)
    np.testing.assert_allclose(leaf.test_error, packed.test_error, atol=0.02)


def test_leaf_layout_makes_the_references_decisions(monkeypatch):
    """The same numpy data and initial parameters through both packages'
    fused engines with ``agg_layout="leaf"``."""
    kw = dict(num_clients=K, bad_frac=0.3, scenario="byzantine", rounds=8, local_epochs=2,
              batch_size=100, hidden=(64, 32), dropout=True, seed=3, engine="fused")
    jres = jax_run(None, JSimConfig(**kw),
                   JServerConfig(rule="afa", num_clients=K,
                                 kernel_plan=jresolve_kernel_plan(False, "leaf")),
                   data=jax_make_mnist_like(**DATA_KW))
    p0 = JDnnWorkload((196, 64, 32, 10)).init_params(jax.random.PRNGKey(3))
    p0_np = jax.tree_util.tree_map(np.asarray, p0)
    monkeypatch.setattr(DnnWorkload, "init_params",
                        lambda self, gen, device: params_from_numpy(p0_np, device=device))
    tres = run(None, SimConfig(**kw), _server("leaf"), data=make_mnist_like(**DATA_KW),
               device="cpu")
    for res in (tres, jres):
        _blocks_the_attackers(res)
    np.testing.assert_array_equal(np.asarray(tres.bad_clients), np.asarray(jres.bad_clients))
    assert abs(tres.test_error[-1] - jres.test_error[-1]) < ENGINE_TOL_PP


def test_unknown_layout_and_sharded_layout_raise():
    with pytest.raises(ValueError, match="KernelPlan.layout='rows' invalid"):
        run(None, SimConfig(num_clients=K, rounds=2, engine="fused"), _server("rows"),
            data=make_mnist_like(**DATA_KW), device="cpu")

    class _Mesh:
        num_shards = 2

    with pytest.raises(ValueError, match="requires the packed layout"):
        tengine._validate_client_mesh(_Mesh(), None, "afa", K, "tree")
