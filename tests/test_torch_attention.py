"""The port's attention against the JAX package's, on the same numpy inputs.

* ``repro_torch.kernels.ops.flash_attention`` on the CPU takes the kernel's
  plain twin (exact softmax in f32 with the TPU kernel's mask); it is held
  against the JAX package's Pallas flash kernel run in interpret mode, at
  the shapes of ``tests/test_kernels.py:200-205`` in both mask modes,
  including the causal Lq != Lk case the JAX package's own oracle cannot
  check (its causal mask is aligned bottom-right, the kernel's top-left).
  f32 within 2e-4, the tolerance those tests hold the Pallas kernel to;
  bf16 within 2e-2 (one bf16 rounding of outputs of magnitude ~1).
* ``repro_torch.models.attention.flash_attention`` (the plain blocked
  attention that the LoRA workload trains through) against
  ``repro/models/attention.py:51`` with key padding, prefix-LM and GQA,
  within 2e-5 (f32, same algorithm, different einsum orders).

The CUDA kernel itself is held against the twin on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash_kernel  # noqa: E402
from repro.models.attention import flash_attention as jax_blocked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.attention import flash_attention as blocked  # noqa: E402

KERNEL_SHAPES = [  # (b, lq, lk, hq, hkv, d), tests/test_kernels.py:200-205
    (2, 64, 64, 4, 2, 32),
    (1, 100, 100, 2, 1, 64),
    (2, 33, 65, 4, 4, 16),
    (1, 256, 256, 8, 2, 128),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, lq, lk, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, lk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, lk, hkv, d)).astype(np.float32)
    return q, k, v


def _twin(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return ops.flash_attention(*t, **kw).float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_twin_matches_the_pallas_kernel(shape, causal):
    q, k, v = _qkv(*shape, seed=sum(shape))
    want = np.asarray(jax_flash_kernel(q, k, v, causal=causal, interpret=True))
    got = _twin(q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_twin_matches_the_pallas_kernel_in_bf16():
    q, k, v = _qkv(2, 48, 48, 4, 2, 32, seed=7)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_flash_kernel(*bf, causal=True, interpret=True)).astype(np.float32)
    got = _twin(*(np.array(a.astype(jnp.float32)) for a in bf), dtype=torch.bfloat16,
                causal=True)
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_flash_twin_gqa_reads_the_repeated_kv_head():
    """GQA (Hq = 6 over Hkv = 2): the twin equals plain multi-head attention
    on kv heads repeated as jnp.repeat(k, 3, axis=2) does, and the kernel."""
    q, k, v = _qkv(2, 40, 40, 6, 2, 16, seed=11)
    rep = [np.repeat(a, 3, axis=2) for a in (k, v)]
    np.testing.assert_allclose(_twin(q, k, v), _twin(q, *rep), rtol=1e-6, atol=1e-6)
    want = np.asarray(jax_flash_kernel(q, k, v, causal=True, interpret=True))
    np.testing.assert_allclose(_twin(q, k, v), want, rtol=2e-4, atol=2e-4)


def test_flash_twin_causal_mask_is_top_left_for_lq_above_lk():
    """Lq > Lk, causal: query i sees keys j <= i; rows i >= Lk see every key."""
    q, k, v = _qkv(1, 20, 7, 2, 1, 8, seed=3)
    want = np.asarray(jax_flash_kernel(q, k, v, causal=True, interpret=True))
    got = _twin(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[:, 7:], _twin(q, k, v, causal=False)[:, 7:],
                               rtol=1e-6, atol=1e-6)


def test_flash_attention_raises_under_grad():
    """No backward, as in the JAX package: a grad request raises instead of
    returning an output that silently carries no gradient."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 1, 8, seed=0))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == (1, 8, 2, 8)


def test_flash_attention_checks_its_operands():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 8, seed=1))
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.flash_attention(q, k.half(), v)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 4, 1, 129))
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.zeros((1, 4, 2, 8), device="meta")
        ops.flash_attention(m, m, m)


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,prefix,q_offset,bq,bk", [
    (2, 37, 37, 4, 2, 16, True, 0, 0, 16, 16),    # padded last blocks, GQA
    (1, 24, 24, 4, 4, 8, False, 0, 0, 8, 16),     # full attention
    (2, 30, 30, 6, 3, 8, True, 5, 0, 8, 8),       # prefix-LM span
    (1, 9, 21, 2, 1, 8, True, 0, 12, 4, 8),       # q offset, Lq != Lk
])
def test_blocked_attention_matches_jax(b, lq, lk, hq, hkv, d, causal, prefix, q_offset, bq, bk):
    q, k, v = _qkv(b, lq, lk, hq, hkv, d, seed=lq + lk + d)
    kw = dict(causal=causal, prefix_len=prefix, q_offset=q_offset, block_q=bq, block_k=bk)
    want = np.asarray(jax_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = blocked(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_blocked_attention_trains_and_equals_the_twin():
    """The plain route is differentiable, and at Lq == Lk it computes what the
    kernel's twin computes."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 33, 33, 4, 2, 16, seed=5))
    q.requires_grad_(True)
    out = blocked(q, k, v, causal=True, block_q=8, block_k=16)
    (g,) = torch.autograd.grad(out.square().sum(), q)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    with torch.no_grad():
        np.testing.assert_allclose(out.detach().numpy(),
                                   ops.flash_attention(q.detach(), k, v).numpy(),
                                   rtol=2e-5, atol=2e-5)
