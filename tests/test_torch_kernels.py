"""The port's kernel wrappers against the JAX package's Pallas wrappers.

On the CPU each wrapper of ``repro_torch.kernels.ops`` takes its kernel's
plain twin; the JAX side runs its Pallas kernels in interpret mode, as the
JAX package's own tests do.  Same numpy inputs for both; floats agree to
rtol 1e-5 (f32, different summation orders), discrete outputs exactly.
The CUDA kernels themselves are held against these twins on the card by
``chip_smoke.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

RTOL = 1e-5
SHAPES = [(1, 7), (8, 300), (13, 517)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(K, D, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(K, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    c = rng.random(K).astype(np.float32)
    return u, w, c


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("K,D", SHAPES)
def test_weighted_sum_twin_matches_pallas(K, D):
    u, _, c = _inputs(K, D, 0)
    got = ops.weighted_sum(torch.from_numpy(c), torch.from_numpy(u))
    _close(got, jops.weighted_sum(c, u, interpret=True))


@pytest.mark.parametrize("K,D", SHAPES)
def test_cosine_sim_twin_matches_pallas(K, D):
    u, w, _ = _inputs(K, D, 1)
    got = ops.cosine_sim(torch.from_numpy(u), torch.from_numpy(w))
    _close(got, jops.cosine_sim(u, w, interpret=True))


def test_cosine_sim_clamps_squared_norms_like_ops():
    """A zero row: the EPS clamp on the squared norm gives sim 0, not NaN."""
    u = np.zeros((3, 40), np.float32)
    u[1] = 1.0
    w = np.ones(40, np.float32)
    got = ops.cosine_sim(torch.from_numpy(u), torch.from_numpy(w))
    _close(got, jops.cosine_sim(u, w, interpret=True))
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("K,D", SHAPES)
def test_gram_twin_matches_pallas(K, D):
    u, _, _ = _inputs(K, D, 2)
    _close(ops.gram(torch.from_numpy(u)), jops.gram(u, interpret=True))


def _screen_inputs(K, D, n_bad, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=D).astype(np.float32)
    u = base + 0.3 * rng.normal(size=(K, D)).astype(np.float32)
    u[:n_bad] = base + 20.0 * rng.normal(size=(n_bad, D)).astype(np.float32)
    pn = (rng.random(K) * 100 + 50).astype(np.float32)
    mask0 = np.ones(K, bool)
    mask0[-1] = False
    return u.astype(np.float32), pn, mask0


@pytest.mark.parametrize("K,D,n_bad,max_rounds,seed", [
    (10, 400, 3, 8, 0), (12, 257, 4, 8, 1), (16, 300, 0, 8, 2), (10, 200, 3, 0, 3),
    (9, 128, 2, 1, 4),
])
def test_afa_screen_twin_matches_pallas(K, D, n_bad, max_rounds, seed):
    u, pn, mask0 = _screen_inputs(K, D, n_bad, seed)
    kw = dict(xi0=2.0, delta_xi=0.5, max_rounds=max_rounds, ddof=0)
    agg, good, rounds, sims = ops.afa_screen(
        torch.from_numpy(u), torch.from_numpy(pn), torch.from_numpy(mask0), **kw)
    jagg, jgood, jrounds, jsims = jops.afa_screen(u, pn, mask0, interpret=True, **kw)
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    assert int(rounds) == int(jrounds)
    _close(agg, jagg)
    _close(sims, jsims)


# (K, live count m): m = 0, 1, even and odd, every row live
MASKED = [(1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (7, 0), (7, 1), (7, 4), (7, 7),
          (10, 0), (10, 1), (10, 6), (10, 7), (10, 10)]


def _rank_inputs(K, D, m, ties, seed):
    """Updates (integers in [-2, 2] when ``ties``, so most columns hold equal
    values) and a mask with ``m`` live rows at random positions."""
    rng = np.random.default_rng(seed)
    if ties:
        u = rng.integers(-2, 3, size=(K, D)).astype(np.float32)
    else:
        u = rng.normal(size=(K, D)).astype(np.float32)
    mask = np.zeros(K, bool)
    mask[rng.permutation(K)[:m]] = True
    return u, mask


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("K,D", [(1, 5), (2, 130), (7, 300), (10, 600)])
def test_coord_median_twin_equals_pallas(K, D, ties):
    """Without a mask: pure selection, so the twin equals the kernel exactly."""
    u, _ = _rank_inputs(K, D, K, ties, K)
    got = ops.coord_median(torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.coord_median(u, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.median(u, axis=0))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("K,m", MASKED)
def test_masked_coord_median_twin_equals_pallas(K, m, ties):
    """Ranks among the live rows only, 0 where none is live: exact."""
    u, mask = _rank_inputs(K, 257, m, ties, 10 * K + m)
    got = ops.coord_median(torch.from_numpy(u), torch.from_numpy(mask))
    want = np.asarray(jops.coord_median(u, mask, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    if m == 0:
        assert not got.any()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("trim", [0, 1, 3])
@pytest.mark.parametrize("K,m", [(1, 1), (2, 2), (7, 0), (7, 4), (7, 7), (10, 6), (10, 7),
                                 (10, 10)])
def test_trimmed_mean_twin_matches_pallas(K, m, trim, ties):
    """Includes m <= 2 trim, where both take the masked mean."""
    u, mask = _rank_inputs(K, 257, m, ties, 100 * K + 10 * m + trim)
    got = ops.trimmed_mean(torch.from_numpy(u), torch.from_numpy(mask), trim=trim)
    _close(got, jops.trimmed_mean(u, mask, trim=trim, interpret=True))


def test_rank_wrappers_check_their_operands():
    u = torch.ones((3, 8))
    with pytest.raises(ValueError, match="K=3"):
        ops.coord_median(u, torch.ones(2, dtype=torch.bool))
    with pytest.raises(TypeError, match="1-D bool/int"):
        ops.trimmed_mean(u, torch.ones(3), trim=1)
    with pytest.raises(ValueError, match="trim"):
        ops.trimmed_mean(u, torch.ones(3, dtype=torch.bool), trim=-1)
    with pytest.raises(ValueError, match="operands on"):
        ops.coord_median(u, torch.ones(3, dtype=torch.bool, device="meta"))


def test_median_by_compare_count_equals_sort():
    rng = np.random.default_rng(5)
    from repro_torch.core.stats import masked_median

    for _ in range(20):
        x = torch.from_numpy(rng.integers(0, 4, size=9).astype(np.float32))
        m = torch.from_numpy(rng.random(9) < 0.7)
        assert float(ref.masked_median_cc(x, m)) == float(masked_median(x, m))


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launch_counts()
    u, w, c = (torch.from_numpy(a) for a in _inputs(4, 50, 6))
    ops.weighted_sum(c, u)
    ops.cosine_sim(u, w)
    ops.gram(u)
    ops.afa_screen(u, c, torch.ones(4, dtype=torch.bool), xi0=2.0, delta_xi=0.5,
                   max_rounds=2)
    m = torch.tensor([True, False, True, True])
    ops.coord_median(u)
    ops.coord_median(u, m)
    ops.trimmed_mean(u, m, trim=1)
    qkv = torch.ones((1, 4, 2, 8))
    ops.flash_attention(qkv, qkv, qkv)
    ops.flash_attention(qkv.bfloat16(), qkv.bfloat16(), qkv.bfloat16())
    assert ops.LAUNCH_COUNTS == {"weighted_sum": 0, "cosine_sim": 0, "gram": 0,
                                 "afa_screen": 0, "coord_median": 0,
                                 "coord_median_masked": 0, "trimmed_mean": 0,
                                 "flash_attn": 0, "flash_attn_tc": 0}


def test_wrappers_check_their_operands():
    u = torch.ones((3, 8))
    with pytest.raises(TypeError, match="float32"):
        ops.gram(u.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.gram(torch.ones((8, 3)).T)
    with pytest.raises(ValueError, match="2-D"):
        ops.gram(torch.ones(8))
    with pytest.raises(ValueError, match="weights"):
        ops.weighted_sum(torch.ones(2), u)
    with pytest.raises(ValueError, match="width"):
        ops.cosine_sim(u, torch.ones(7))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gram(torch.ones((3, 8), device="meta"))
    with pytest.raises(ValueError, match="K="):
        ops.afa_screen(u, torch.ones(2), torch.ones(3, dtype=torch.bool), xi0=2.0,
                       delta_xi=0.5, max_rounds=1)


def _ctype(decl):
    """The ctypes type that passes a C parameter declared as ``decl``."""
    import ctypes

    if "*" in decl:
        return ctypes.c_void_p
    if "long long" in decl:
        return ctypes.c_longlong
    if "float" in decl:
        return ctypes.c_float
    assert re.search(r"\bint\b", decl), decl
    return ctypes.c_int


def test_ctypes_signatures_match_the_cuda_source():
    """Every C function the wrappers bind exists in the sources with the
    declared parameters, kind by kind: a pointer as c_void_p, a long long as
    c_longlong, a float as c_float, an int as c_int (a mismatch would pass
    garbage pointers or cut a 64-bit value)."""
    src = "".join((build.CSRC / name).read_text() for name in build.SOURCES)
    found = {
        name: params for name, params in re.findall(
            r"^int (repro_\w+)\(([^)]*)\)", src, flags=re.MULTILINE | re.DOTALL)
    }
    assert set(found) == set(build.SIGNATURES)
    for name, params in found.items():
        kinds = [_ctype(p) for p in params.split(",")] if params.strip() else []
        assert kinds == list(build.SIGNATURES[name]), name


def test_build_key_follows_the_source():
    assert build.source_hash() == build.source_hash()
    assert len(build.source_hash()) == 16
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
