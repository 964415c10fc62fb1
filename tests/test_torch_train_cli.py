"""The port's train launcher (``repro_torch.launch.train``) on the CPU.

* ``tests/test_cli.py``'s train checks through the port's ``main`` with
  ``--device cpu``: a reduced run writes a checkpoint, which loads back bit
  for bit through ``load_pytree``; one byzantine client of four is screened
  (``good_frac=0.75``);
* ``make_fed_batches`` gives the reference's arrays from the same seed for
  a dense, a VLM and an audio config, the eval batch drawn first;
* the ``--workload lora`` route runs and saves its adapters;
* ``--help`` in a fresh process imports no ``jax``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import make_token_stream as jax_make_token_stream  # noqa: E402
from repro.launch.train import make_fed_batches as jax_make_fed_batches  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import init_reputation  # noqa: E402
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.launch.train import main, make_fed_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU workloads: the suite
    runs several workers at once, and torch's thread pool oversubscribed by
    them runs these ~20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_cli_reduced_checkpoint_round_trip(tmp_path, capsys):
    """``tests/test_cli.py::test_train_cli_reduced`` on the port; the
    checkpoint loads back into a template of the run's tree bit for bit."""
    ck = tmp_path / "ck.msgpack"
    rc = main([
        "--arch", "smollm-135m", "--reduced", "--rounds", "2", "--clients", "4",
        "--local-steps", "1", "--batch", "1", "--seq", "32", "--ckpt", str(ck),
        "--device", "cpu",
    ])
    assert rc == 0 and ck.exists()
    assert capsys.readouterr().out.splitlines()[-1] == f"saved {ck}"
    cfg = get_config("smollm-135m").reduced().with_(param_dtype="float32",
                                                    compute_dtype="float32")
    template = {"params": build_model(cfg).init(torch.Generator(), "cpu"),
                "rep": init_reputation(4, device="cpu")._asdict()}
    restored = load_pytree(str(ck), template)
    assert restored["rep"]["blocked"].dtype == torch.bool
    np.testing.assert_array_equal((restored["rep"]["alpha"] + restored["rep"]["beta"]).numpy(),
                                  [8.0] * 4)
    again = tmp_path / "again.msgpack"
    save_pytree(str(again), restored)
    assert again.read_bytes() == ck.read_bytes()
    for a, t in zip(tree_leaves(restored), tree_leaves(template)):
        assert a.dtype == t.dtype and a.shape == t.shape


def test_train_cli_byzantine_screens_clients(capsys):
    """``tests/test_cli.py::test_train_cli_byzantine_screens_clients`` on
    the port."""
    rc = main([
        "--arch", "smollm-135m", "--reduced", "--rounds", "2", "--clients", "4",
        "--local-steps", "2", "--batch", "2", "--seq", "64", "--byzantine", "1",
        "--device", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "good_frac=0.75" in out
    assert all(line.startswith("round ") and "eval_loss=" in line and "afa_rounds=" in line
               for line in out.splitlines())


@pytest.mark.parametrize("arch", ["smollm-135m", "paligemma-3b", "hubert-xlarge"])
def test_make_fed_batches_matches_reference(arch):
    """The same seed gives the reference's arrays: the eval batch, then a
    round's K clients, a VLM's patches and an audio model's frames drawn
    after the tokens."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jstream = jax_make_token_stream(vocab=jcfg.vocab_size, n=2_000)
    tstream = make_token_stream(vocab=tcfg.vocab_size, n=2_000)
    np.testing.assert_array_equal(tstream.tokens, jstream.tokens)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for K, S, b in ((1, 1, 2), (3, 2, 2)):
        want = jax_make_fed_batches(jcfg, jstream, jrng, K=K, S=S, b=b, seq=16)
        got = make_fed_batches(tcfg, tstream, trng, K=K, S=S, b=b, seq=16, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_train_cli_lora_route(tmp_path, capsys):
    ck = tmp_path / "lora.msgpack"
    rc = main([
        "--arch", "smollm-135m", "--reduced", "--workload", "lora", "--rounds", "2",
        "--clients", "3", "--byzantine", "1", "--local-steps", "1", "--batch", "2",
        "--seq", "16", "--ckpt", str(ck), "--device", "cpu",
    ])
    assert rc == 0 and ck.exists()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("lora workload: adapter_dim=")
    assert [line.split(":")[0] for line in out[1:3]] == ["round 0", "round 1"]
    assert out[-1] == f"saved {ck}"


def test_train_help_imports_no_jax():
    code = ("import sys\n"
            "from repro_torch.launch import train\n"
            "try:\n"
            "    train.main(['--help'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro', 'msgpack'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--workload" in res.stdout
