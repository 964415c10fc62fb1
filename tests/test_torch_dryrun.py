"""The port's one-card dry run (``python -m repro_torch.launch.dryrun``) on
the CPU, on ``device="meta"``.

* the CLI on the combos of ``tests/test_launch.py``'s subprocess dry run
  (smollm-135m train_4k, olmoe-1b-7b decode_32k, mamba2-1.3b long_500k,
  hubert-xlarge decode_32k: a ``skip`` whose reason says "encoder-only"),
  one JSON a combo with its bytes, counted FLOPs and analytic model;
* the argument bytes of every (arch x shape) equal to the bytes of the
  reference's ``eval_shape`` leaves;
* ``flops_counted`` of smollm-135m's and llama3-8b's ``decode_32k`` within
  1 % of ``analytic_flops``: on the plain route the counted projections,
  head and attention einsums are the analytic terms;
* a train step's ``flops_counted`` is its mode's client-training calls
  (``fed.distributed.client_train_calls``) times the local steps times one
  client's step, counted apart; and ``client_train_calls`` is the number
  of calls a round of each mode makes on the CPU;
* ``--device cuda`` refuses without CUDA, and ``--help`` in a fresh process
  loads no ``jax`` and nothing of ``repro``.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALIASES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
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


@functools.lru_cache(maxsize=None)
def _reference_bytes(arch, shape) -> int:
    """Bytes of the reference's ``eval_shape`` argument leaves on a
    one-device mesh."""
    import jax

    b = jax_specs.input_specs(jax_build_model(jax_get_config(arch)), shape,
                              make_test_mesh(data=1, model=1))
    return sum(int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
               for l in jax.tree_util.tree_leaves(b.args))


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"),
    ("olmoe-1b-7b", "decode_32k"),
    ("mamba2-1.3b", "long_500k"),
    ("hubert-xlarge", "decode_32k"),  # -> the reference's skip
])
def test_dryrun_cli_on_meta(tmp_path, capsys, arch, shape):
    rc = dryrun.main(["--arch", arch, "--shape", shape, "--out", str(tmp_path), "--force"])
    assert rc == 0, capsys.readouterr().out
    rec = json.load(open(tmp_path / f"{arch}__{shape}__meta.json"))
    assert rec["num_chips"] == 1 and rec["device"] == "meta"
    if arch == "hubert-xlarge":
        assert rec["status"] == "skip"
        assert "encoder-only" in rec["skip_reason"]
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["meta"]["client_rows"] == 1 and "mesh" not in rec["meta"]
    assert rec["memory"]["argument_bytes"] == _reference_bytes(arch, shape)
    assert rec["memory"]["output_bytes"] > 0
    assert rec["flops_counted"] > 0 and rec["analytic"]["analytic_flops"] > 0
    want_scope = "local training" if shape == "train_4k" else "step"
    assert rec["flops_scope"] == want_scope
    assert "1 ok, 0 skip, 0 error" in capsys.readouterr().out


@pytest.mark.parametrize("arch", list(ALIASES))
def test_argument_bytes_equal_the_reference_s(arch):
    for shape in specs.INPUT_SHAPES:
        bundle = specs.input_specs(build_model(get_config(arch)), shape)
        if bundle.step_kind == "skip":
            continue
        assert dryrun.nbytes(bundle.args) == _reference_bytes(arch, shape), (arch, shape)


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3-8b"])
def test_decode_flops_counted_match_the_analytic_model(tmp_path, arch):
    rec = dryrun.run_one(arch, "decode_32k", str(tmp_path), force=True)
    assert rec["status"] == "ok", rec.get("error")
    analytic = rec["analytic"]["analytic_flops"]
    assert abs(rec["flops_counted"] / analytic - 1.0) < 0.01, (rec["flops_counted"], analytic)
    # the step takes (params, cache, tokens, pos) and returns its f32 logits
    # and the cache it wrote in place
    cfg = get_config(arch)
    params = dryrun.nbytes(build_model(cfg).init(None, "meta"))
    mem = rec["memory"]
    assert mem["output_bytes"] == mem["argument_bytes"] - params - 2 * 128 * 4 \
        + 128 * cfg.vocab_size * 4


def _reduced_counting(mode):
    cfg = get_config("smollm-135m").reduced().with_(fed_mode=mode)
    return build_model(cfg.with_(use_pallas_attention=False, block_q=dryrun.ONE_TILE,
                                 block_k=dryrun.ONE_TILE))


@pytest.mark.parametrize("mode,client_rows", [("vmap", 2), ("scan", 1), ("remat", 1)])
def test_train_flops_counted_are_calls_times_one_client_step(mode, client_rows):
    """On meta at ``train_4k``'s shapes: the count is K (vmap: the K clients
    of one call; scan: K calls) or 3K (remat) times S times the FLOPs of one
    client's gradient on one local step's batch."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.fed.distributed import client_train_calls

    model = _reduced_counting(mode)
    bundle = specs.input_specs(model, "train_4k", client_rows=client_rows)
    rec = dryrun.count_step(model, bundle, {})
    params, _, _, batch = bundle.args
    K, S = batch["labels"].shape[:2]
    one = {n: v[0, 0] for n, v in batch.items()}
    leaves = [l.requires_grad_() for l in tree_leaves(params)]
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(model.loss_fn(params, one)[0], leaves)
    per_client = {"vmap": K, "scan": K, "remat": 3 * K}[mode]
    assert rec["flops_calls"] == client_train_calls(mode, K)
    assert rec["flops_counted"] == per_client * S * fc.get_total_flops() > 0


@pytest.mark.parametrize("mode", ["vmap", "scan", "remat"])
def test_client_train_calls_are_the_round_s(monkeypatch, mode):
    """``client_train_calls`` = the ``_client_train`` / ``_clients_train``
    calls one round of ``make_fed_round`` makes, no client blocked (CPU,
    K = 3, one local step of one 8-token sequence)."""
    from repro_torch.core import ReputationState
    from repro_torch.fed import distributed
    from repro_torch.launch.steps import build_step

    calls = []
    for name in ("_client_train", "_clients_train"):
        real = getattr(distributed, name)
        monkeypatch.setattr(distributed, name,
                            lambda *a, _real=real, **kw: (calls.append(1), _real(*a, **kw))[1])
    cfg = get_config("smollm-135m").reduced().with_(fed_mode=mode, fed_clients=3)
    model = build_model(cfg)
    bundle = specs.input_specs(model, "train_4k", client_rows=3, device="cpu",
                               global_batch=3, local_steps=1)
    params, rep, n_k, batch = bundle.args
    batch = {n: v[..., :8] for n, v in batch.items()}
    K = batch["labels"].shape[0]
    step = build_step(model, bundle, local_steps=1)
    step(params, ReputationState(rep.alpha, rep.beta, torch.zeros((K,), dtype=torch.bool)),
         n_k, batch)
    assert len(calls) == distributed.client_train_calls(mode, K) and K == 3


def test_cuda_dry_run_refuses_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--device", "cuda",
                     "--out", str(tmp_path)])


def test_dryrun_module_imports_no_jax():
    """``python -m repro_torch.launch.dryrun --help`` in a fresh process
    exits 0 without importing jax or repro."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--variant" in out.stdout and "--device" in out.stdout
