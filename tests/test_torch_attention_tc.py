"""The twin of the tensor-core flash-attention arithmetic, on the CPU.

``repro_torch.kernels.ref.flash_attention_tc_ref`` states what the bf16/f16
kernel (``flash_attn_tc_kernel`` in ``csrc/attn_kernels.cu``) computes: the
TPU kernel's online softmax in f32 over 64-key tiles, with p rounded to the
input dtype before p.v and l summed from the unrounded p.  Held here

* against the JAX package's Pallas flash kernel in interpret mode, in bf16
  and f16, at ``chip_smoke.py``'s ``ATTN_SHAPES`` (GQA, ragged Lq/Lk,
  D = 16..128, causal Lq > Lk): atol = rtol = 2e-2 in bf16 (one rounding of
  outputs of magnitude ~1) and 2.5e-3 in f16 (the same bound scaled by
  f16's three extra mantissa bits);
* against the exact twin ``flash_attention_ref`` on f32 inputs, where the
  rounding of p is a no-op: within 1e-6;
* against the exact twin in bf16 and f16 at a causal (1, 1024, 3, 64) case:
  within one output ulp at v's scale (2^-7 max|v| in bf16, 2^-10 in f16), so
  rounding p costs no more than the output's own rounding.

The CUDA kernel is held against this twin on the card by ``chip_smoke.py``.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATTN_SHAPES = [  # (b, lq, lk, hq, hkv, d), causal: chip_smoke.py's ATTN_SHAPES
    ((2, 64, 64, 4, 2, 32), True), ((2, 64, 64, 4, 2, 32), False),
    ((1, 100, 100, 2, 1, 64), True), ((1, 100, 100, 2, 1, 64), False),
    ((2, 33, 65, 4, 4, 16), True), ((2, 33, 65, 4, 4, 16), False),
    ((1, 256, 256, 8, 2, 128), True), ((1, 256, 256, 8, 2, 128), False),
    ((1, 300, 130, 6, 2, 64), True),
]
LOW = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2.0 ** -7),
       "float16": (jnp.float16, torch.float16, 2.5e-3, 2.0 ** -10)}


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


@pytest.mark.parametrize("dtype", list(LOW))
@pytest.mark.parametrize("case", ATTN_SHAPES, ids=_ids)
def test_tc_twin_matches_the_pallas_kernel(case, dtype):
    (shape, causal), (jdt, tdt, tol, _) = case, LOW[dtype]
    low = [jnp.asarray(a, jdt) for a in _qkv(*shape, seed=sum(shape))]
    want = np.asarray(jax_flash_kernel(*low, causal=causal, interpret=True)).astype(np.float32)
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in low]
    got = ref.flash_attention_tc_ref(*t, causal=causal)
    assert got.dtype == tdt and got.shape == t[0].shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ATTN_SHAPES + [((1, 20, 7, 2, 1, 8), True)], ids=_ids)
def test_tc_twin_on_f32_is_the_exact_twin(case):
    shape, causal = case
    t = [torch.from_numpy(a) for a in _qkv(*shape, seed=3 + sum(shape))]
    got = ref.flash_attention_tc_ref(*t, causal=causal)
    want = ref.flash_attention_ref(*t, causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", list(LOW))
def test_rounding_p_costs_at_most_one_output_ulp(dtype):
    """Causal (1, 1024, 3, 64): p rounded to the input dtype keeps the output
    within 2^-7 max|v| (bf16) / 2^-10 max|v| (f16) of the exact softmax
    rounded once to that dtype."""
    _, tdt, _, ulp = LOW[dtype]
    t = [torch.from_numpy(a).to(tdt) for a in _qkv(1, 1024, 1024, 3, 3, 64, seed=15)]
    got = ref.flash_attention_tc_ref(*t, causal=True).float()
    want = ref.flash_attention_ref(*t, causal=True).float()
    bound = ulp * float(t[2].float().abs().max())
    assert float((got - want).abs().max()) <= bound


def test_tc_twin_tiles_as_the_kernel_does():
    """The twin's default key tile is the kernel's, and a different tile
    changes only the summation order."""
    default = inspect.signature(ref.flash_attention_tc_ref).parameters["block_k"].default
    assert default == ops.ATTN_TC_BLOCK_K == 64
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 150, 150, 4, 2, 32, seed=9)]
    a = ref.flash_attention_tc_ref(*t).float()
    b = ref.flash_attention_tc_ref(*t, block_k=16).float()
    assert float((a - b).abs().max()) <= 2.0 ** -7 * float(t[2].float().abs().max())


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    buf = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    out = buf[1:].view(shape)
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


@pytest.mark.parametrize("dtype,d,misalign,vec", [
    (torch.bfloat16, 64, False, True),
    (torch.float16, 128, False, True),
    (torch.bfloat16, 20, False, False),     # D % 8 != 0: element loads
    (torch.float16, 64, True, False),       # q not 16-byte aligned: element loads
    (torch.float32, 64, False, True),       # f32: 4 elements in 16 bytes
    (torch.float32, 18, False, False),      # D % 4 != 0: element loads
])
def test_attn_flags_ask_for_16_byte_copies_only_where_they_are_possible(dtype, d, misalign,
                                                                        vec):
    shape = (2, 16, 4, d)
    q = _misaligned(shape, dtype) if misalign else torch.zeros(shape, dtype=dtype)
    k = torch.zeros((2, 16, 2, d), dtype=dtype)
    out = torch.empty_like(k)
    for causal in (True, False):
        flags = ops.attn_flags(q, k, k, out, causal=causal)
        assert flags == int(causal) | (int(vec) << 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cpu_route_takes_the_exact_twin_and_counts_no_launch(dtype):
    """On the CPU every dtype takes the exact twin, and neither kernel's
    count moves; the tensor-core kernel has its own count."""
    t = [torch.from_numpy(a).to(dtype) for a in _qkv(1, 70, 70, 4, 2, 20, seed=4)]
    ops.reset_launch_counts()
    got = ops.flash_attention(*t, causal=True)
    assert torch.equal(got, ref.flash_attention_ref(*t, causal=True))
    assert ops.LAUNCH_COUNTS["flash_attn"] == ops.LAUNCH_COUNTS["flash_attn_tc"] == 0
