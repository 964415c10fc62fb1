"""The twin of the f32 flash-attention arithmetic (3xTF32), on the CPU.

``repro_torch.kernels.ref.flash_attention_3xtf32_ref`` states what the f32
kernel (``flash_attn_tf32x3_kernel`` in ``csrc/attn_kernels.cu``) computes on
the tensor cores: q k^T and p.v each as three exact products of TF32 halves
(lo hi' + hi lo' + hi hi', split as ``ref.tf32_split``), summed over 64-key
tiles, around the TPU kernel's online softmax in f32 with the folded exp2.
Held here, at ``chip_smoke.py``'s ``ATTN_SHAPES`` (GQA, ragged Lq/Lk,
D = 16..128, causal Lq > Lk) and its element-load shapes (D = 20, 18):

* against the JAX package's Pallas flash kernel in interpret mode, in f32,
  at atol = rtol = 2e-4 (``tests/test_kernels.py``'s tolerance for it);
* against the exact twin ``flash_attention_ref`` within 1e-6 max |v|: 3xTF32
  is as close to exact attention as f32 is;
* a 1xTF32 variant and a variant with the lo hi' product dropped each miss
  ``TF32_ATTN_RTOL`` max |v| from the twin, the tolerance ``chip_smoke.py``
  holds the kernel to, so the card's check sees such a fault.

The CUDA kernel is held against this twin on the card by ``chip_smoke.py``.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jax_flash_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATTN_SHAPES = [  # (b, lq, lk, hq, hkv, d), causal: chip_smoke.py's ATTN_SHAPES
    ((2, 64, 64, 4, 2, 32), True), ((2, 64, 64, 4, 2, 32), False),
    ((1, 100, 100, 2, 1, 64), True), ((1, 100, 100, 2, 1, 64), False),
    ((2, 33, 65, 4, 4, 16), True), ((2, 33, 65, 4, 4, 16), False),
    ((1, 256, 256, 8, 2, 128), True), ((1, 256, 256, 8, 2, 128), False),
    ((1, 300, 130, 6, 2, 64), True),
]
ELEMENT_LOADS = [((1, 77, 77, 4, 2, d), causal) for d in (20, 18) for causal in (True, False)]
TF32_ATTN_RTOL = 3e-6   # chip_smoke.py's TF32_ATTN_RTOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, lq, lk, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d)))


def _ids(case):
    shape, causal = case
    return "x".join(map(str, shape)) + ("-causal" if causal else "-full")


def _err_over_v(got, want, v):
    return float((got - want).abs().max()) / float(v.abs().max())


@pytest.mark.parametrize("case", ATTN_SHAPES, ids=_ids)
def test_3xtf32_twin_matches_the_pallas_kernel(case):
    shape, causal = case
    q, k, v = _qkv(*shape, seed=sum(shape))
    want = np.asarray(jax_flash_kernel(q, k, v, causal=causal, interpret=True))
    got = ref.flash_attention_3xtf32_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ATTN_SHAPES + ELEMENT_LOADS, ids=_ids)
def test_3xtf32_twin_is_as_close_as_f32_to_exact_attention(case):
    shape, causal = case
    t = [torch.from_numpy(a) for a in _qkv(*shape, seed=5 + sum(shape))]
    got = ref.flash_attention_3xtf32_ref(*t, causal=causal)
    want = ref.flash_attention_ref(*t, causal=causal)
    assert _err_over_v(got, want, t[2]) <= 1e-6


@pytest.mark.parametrize("terms", [2, 1], ids=["one-lo-term-dropped", "1xTF32"])
@pytest.mark.parametrize("case", ATTN_SHAPES[::2] + ELEMENT_LOADS[1:], ids=_ids)
def test_a_faulty_product_misses_the_chip_tolerance(case, terms):
    """Both faults read >= 5x the tolerance from the kernel's twin."""
    shape, causal = case
    t = [torch.from_numpy(a) for a in _qkv(*shape, seed=7 + sum(shape))]
    twin = ref.flash_attention_3xtf32_ref(*t, causal=causal)
    faulty = ref.flash_attention_3xtf32_ref(*t, causal=causal, terms=terms)
    assert _err_over_v(faulty, twin, t[2]) > 5 * TF32_ATTN_RTOL


def test_3xtf32_twin_tiles_as_the_kernel_does():
    """The twin's default key tile is the kernel's, and a different tile
    changes only the summation order."""
    default = inspect.signature(ref.flash_attention_3xtf32_ref).parameters["block_k"].default
    assert default == ops.ATTN_TC_BLOCK_K == 64
    t = [torch.from_numpy(a) for a in _qkv(1, 150, 150, 4, 2, 32, seed=9)]
    a = ref.flash_attention_3xtf32_ref(*t)
    b = ref.flash_attention_3xtf32_ref(*t, block_k=16)
    assert _err_over_v(a, b, t[2]) <= 1e-6


def test_cpu_route_takes_the_exact_twin_in_f32_and_counts_no_launch():
    t = [torch.from_numpy(a) for a in _qkv(1, 70, 70, 4, 2, 20, seed=4)]
    ops.reset_launch_counts()
    got = ops.flash_attention(*t, causal=True)
    assert torch.equal(got, ref.flash_attention_ref(*t, causal=True))
    assert ops.LAUNCH_COUNTS["flash_attn"] == ops.LAUNCH_COUNTS["flash_attn_tc"] == 0
