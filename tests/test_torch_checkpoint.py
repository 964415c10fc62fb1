"""The port's checkpoints against the JAX package's.

* The port's msgpack codec gives ``msgpack.packb(payload,
  use_bin_type=True)``'s bytes and reads them back as ``msgpack.unpackb``
  does, at every header width;
* a checkpoint written by either package loads in the other on float32,
  int32 and bool leaves, and the two packages write the same bytes for the
  same tree (a bfloat16 leaf too: dtype ``<V2`` and its raw words);
* the port's bfloat16 round trip is bit for bit (the reference cannot read
  such a leaf back, so it is not the oracle there);
* ``tests/test_fed.py::test_checkpoint_roundtrip`` on the port's tiny LM,
  with ``latest_checkpoint``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro_torch.checkpoint import latest_checkpoint, load_pytree, save_pytree  # noqa: E402
from repro_torch.checkpoint.io import packb, treedef_str, unpackb  # noqa: E402
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


def _tree(seed=0):
    """Nested float32, int32 and bool leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "b": rng.normal(size=(4,)).astype(np.float32),
                   "scalar": np.float32(1.5)},
        "rep": {"alpha": np.asarray([3.0, 4.0], np.float32),
                "blocked": np.asarray([False, True]),
                "rounds": rng.integers(-5, 5, size=(2, 3)).astype(np.int32)},
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_codec_matches_msgpack():
    msgpack = pytest.importorskip("msgpack")
    leaf = {b"__nd__": True, b"dtype": "<f4", b"shape": [2, 3], b"data": b"\x00" * 24}
    payload = {
        "treedef": "PyTreeDef({'a': *})", "leaves": [leaf] * 3,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63],
        "strs": ["", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "y" * 70_000, "héllo"],
        "bins": [b"", b"z" * 255, b"z" * 256, b"z" * 70_000],
        "lists": [list(range(15)), list(range(16)), list(range(70_000))],
        "maps": [{str(i): i for i in range(15)}, {str(i): None for i in range(16)},
                 {str(i): False for i in range(70_000)}],
        b"bin key": [None, True, False],
    }
    want = msgpack.packb(payload, use_bin_type=True)
    assert packb(payload) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)
    with pytest.raises(ValueError):
        unpackb(want + b"\x00")
    with pytest.raises(ValueError):
        unpackb(want[:-1])


def test_treedef_string_is_jax_s():
    tree = _tree()
    assert treedef_str(_as_torch(tree)) == str(jax.tree_util.tree_structure(tree))


def test_port_checkpoint_loads_in_reference(tmp_path):
    tree = _tree(1)
    path = str(tmp_path / "port.msgpack")
    save_pytree(path, _as_torch(tree))
    got = jax_load(path, jax.tree_util.tree_map(jnp.asarray, _tree(2)))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(got)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_reference_checkpoint_loads_in_port(tmp_path):
    tree = _tree(3)
    path = str(tmp_path / "ref.msgpack")
    jax_save(path, jax.tree_util.tree_map(jnp.asarray, tree))
    template = _as_torch(_tree(4))
    got = load_pytree(path, template)
    for a, b, t in zip(jax.tree_util.tree_leaves(tree), tree_leaves(got), tree_leaves(template)):
        assert b.dtype == t.dtype and b.shape == t.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_both_packages_write_the_same_bytes(tmp_path):
    """One tree, float32, int32, bool and bfloat16 leaves: the port's file is
    the reference's, byte for byte."""
    tree = _tree(5)
    bf = np.asarray([1.5, -2.25, 3.0, 1e-3, -0.0], np.float32)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["params"]["half"] = jnp.asarray(bf, jnp.bfloat16)
    ttree = _as_torch(tree)
    ttree["params"]["half"] = torch.from_numpy(bf).to(torch.bfloat16)
    jax_save(str(tmp_path / "ref.msgpack"), jtree)
    save_pytree(str(tmp_path / "port.msgpack"), ttree)
    ref_bytes = (tmp_path / "ref.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == ref_bytes
    leaves = unpackb(ref_bytes)["leaves"]
    assert leaves[1][b"dtype"] == "<V2"   # params.half, in sorted key order


def test_bf16_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "inner": {"v": torch.tensor([float("inf"), -0.0, 1e-30, -65504.0]).bfloat16(),
                      "f": torch.randn((3,), generator=g)}}
    path = str(tmp_path / "bf16.msgpack")
    save_pytree(path, tree)
    got = load_pytree(path, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert b.dtype == a.dtype
        assert torch.equal(b.view(torch.int16) if b.dtype == torch.bfloat16 else b,
                           a.view(torch.int16) if a.dtype == torch.bfloat16 else a)
    with pytest.raises(ValueError, match="bfloat16 template"):
        load_pytree(path, {"w": tree["w"].float(), "inner": tree["inner"]})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"w": tree["w"]})


def test_checkpoint_roundtrip_tiny_lm(tmp_path):
    """``tests/test_fed.py::test_checkpoint_roundtrip`` on the port."""
    model = build_model(ModelConfig(
        name="fed-lm", family="dense", num_layers=2, d_model=32, vocab_size=64,
        num_heads=2, num_kv_heads=2, d_ff=64, block_q=16, block_k=16))
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    path = str(tmp_path / "ckpt_000010.msgpack")
    save_pytree(path, params)
    restored = load_pytree(path, params)
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert torch.equal(a, b)
    save_pytree(str(tmp_path / "ckpt_000020.msgpack"), params)
    (tmp_path / "ckpt_final.msgpack").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_000020.msgpack")
    assert latest_checkpoint(str(tmp_path / "missing")) is None
