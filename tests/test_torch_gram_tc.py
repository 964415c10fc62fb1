"""The Gram kernel's tensor-core arithmetic (3xTF32) and its geometry, on the CPU.

``ref.gram_3xtf32_ref`` is the twin of ``gram_tf32x3_kernel``'s arithmetic:
a bit-exact TF32 split x = hi + lo (``cvt.rna.tf32.f32``: to nearest, ties
away from zero), u_i u_j ~ lo_i hi_j + hi_i lo_j + hi_i hi_j summed in
float64.  It is held to the f32 twin ``ref.gram_ref``, to the JAX package's
Pallas gram (interpret mode) and to an exact float64 Gram within ``RTOL`` =
1e-5 of each part's largest magnitude (diagonal and off-diagonal apart, as
``chip_smoke.py`` holds the kernel), at small shapes and at the paper DNN's
D = 535,818 on screening-like inputs.  1xTF32 (hi_i hi_j alone) misses that
tolerance there, which is why the kernel does not use it.  ``gram_geometry``
is the split, tile and copy-width plan that the C entries check (their
refusal of a plan the operand breaks is checked on the card, in
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-5
D_PAPER = 535_818
D_ADAPTER = 460_800
SM_COUNT = 132


def _parts(g):
    g = np.asarray(g, np.float64)
    off = ~np.eye(g.shape[0], dtype=bool)
    return {"diagonal": np.diagonal(g), "off-diagonal": g[off]}


def _within(got, want, rtol=RTOL):
    """max |got - want| <= rtol * max |want| on each part; returns the errors."""
    errs = {}
    for (label, a), b in zip(_parts(got).items(), _parts(want).values()):
        if a.size:
            errs[label] = (float(np.abs(a - b).max()), rtol * float(np.abs(b).max()))
    return errs


def _assert_within(got, want, rtol=RTOL):
    for label, (err, tol) in _within(got, want, rtol).items():
        assert err <= tol, f"{label}: max |diff| {err} > {tol}"


def _screen_like(K, D, seed):
    """chip_smoke.py's screening inputs: a benign cluster around one base
    vector, the first 30 % of the rows byzantine (20x the noise)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=D).astype(np.float32)
    u = base + 0.3 * rng.normal(size=(K, D)).astype(np.float32)
    n_bad = (3 * K) // 10
    u[:n_bad] = base + 20.0 * rng.normal(size=(n_bad, D)).astype(np.float32)
    return u.astype(np.float32)


def _tf32_by_frexp(x):
    """TF32 rounding computed another way: 11 significant bits, half away."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5)
    return np.ldexp(r / 2.0**11, e)


# --- the split ------------------------------------------------------------


def test_tf32_round_keeps_ten_mantissa_bits_and_rounds_ties_away():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, 4096),
                        [1.0, 0.0, -0.0, 3e38, 1e-40]]).astype(np.float32)
    hi = ref.tf32_round(torch.from_numpy(x)).numpy()
    assert not (hi.view(np.int32) & 0x1FFF).any()
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(hi[normal], _tf32_by_frexp(x[normal]).astype(np.float32))
    ties = np.array([1 + 2**-11, -(1 + 2**-11), 1 + 2**-10 + 2**-11, 1 + 2**-11 - 2**-23],
                    np.float32)
    got = ref.tf32_round(torch.from_numpy(ties)).numpy()
    np.testing.assert_array_equal(got, np.array([1 + 2**-10, -(1 + 2**-10), 1 + 2**-9, 1.0],
                                                np.float32))
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = ref.tf32_round(special)
    assert torch.isinf(out[:2]).all() and torch.isnan(out[2])


@pytest.mark.parametrize("scale", [1e-20, 1.0, 1e20])  # lo stays a normal f32
def test_tf32_split_reconstructs_to_2_pow_minus_22(scale):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=100_000) * scale).astype(np.float32))
    hi, lo = ref.tf32_split(x)
    for t in (hi, lo):
        assert not (t.numpy().view(np.int32) & 0x1FFF).any()
    x64 = x.double()
    rel = ((hi.double() + lo.double() - x64).abs() / x64.abs()).max().item()
    assert rel <= 2.0**-22


# --- the twin against the f32 Gram, the Pallas gram and float64 ----------------


@pytest.mark.parametrize("K,D", [(1, 7), (8, 300), (13, 517), (40, 3001)])
def test_3xtf32_twin_matches_f32_and_pallas_gram(K, D):
    rng = np.random.default_rng(K + D)
    u = rng.normal(size=(K, D)).astype(np.float32)
    tw = ref.gram_3xtf32_ref(torch.from_numpy(u)).numpy()
    _assert_within(tw, ref.gram_ref(torch.from_numpy(u)).numpy())
    _assert_within(tw, np.asarray(jops.gram(u, interpret=True)))
    exact = u.astype(np.float64) @ u.astype(np.float64).T
    _assert_within(tw, exact)


@pytest.fixture(scope="module")
def paper_screen():
    u = _screen_like(10, D_PAPER, seed=7)
    return u, u.astype(np.float64) @ u.astype(np.float64).T


def test_3xtf32_twin_within_rtol_at_the_paper_dnn_width(paper_screen):
    u, exact = paper_screen
    tw = ref.gram_3xtf32_ref(torch.from_numpy(u)).numpy()
    _assert_within(tw, exact)
    _assert_within(tw, ref.gram_ref(torch.from_numpy(u)).numpy())
    _assert_within(tw, np.asarray(jops.gram(u, interpret=True)))


def test_1xtf32_misses_the_tolerance_at_the_paper_dnn_width(paper_screen):
    """hi_i hi_j alone: the record of why the kernel runs three products."""
    u, exact = paper_screen
    hi = ref.tf32_round(torch.from_numpy(u)).double()
    one = (hi @ hi.T).numpy()
    err, tol = _within(one, exact)["off-diagonal"]
    assert err > 10 * tol


def test_afa_screen_twin_takes_a_given_gram():
    u = _screen_like(10, 4000, seed=3)
    rng = np.random.default_rng(3)
    pn = torch.from_numpy((rng.random(10) * 100 + 50).astype(np.float32))
    mask0 = torch.ones(10, dtype=torch.bool)
    mask0[-1] = False
    U = torch.from_numpy(u)
    kw = dict(xi0=2.0, delta_xi=0.5, max_rounds=8)
    plain = ref.afa_screen_ref(U, pn, mask0, **kw)
    tc = ref.afa_screen_ref(U, pn, mask0, gram=ref.gram_3xtf32_ref(U), **kw)
    assert torch.equal(plain[1], tc[1]) and int(plain[2]) == int(tc[2])
    for a, b in ((plain[0], tc[0]), (plain[3], tc[3])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=RTOL * float(a.abs().max()))


# --- the geometry -----------------------------------------------------------------


@pytest.mark.parametrize("D,ptr,width", [(D_PAPER, 1 << 20, 8), (D_ADAPTER, 1 << 20, 16),
                                         (D_ADAPTER, (1 << 20) + 8, 8),
                                         (D_ADAPTER, (1 << 20) + 4, 4), (1001, 1 << 20, 4)])
def test_gram_geometry_takes_the_widest_copy_the_operand_allows(D, ptr, width):
    assert ops.gram_geometry(10, D, ptr, SM_COUNT).width == width


def test_gram_geometry_tiles_k200_in_upper_pairs_within_1p5x():
    geo = ops.gram_geometry(200, D_PAPER, 1 << 20, SM_COUNT)
    assert (geo.tile_rows, geo.ntiles, geo.npairs, geo.entries) == (32, 7, 28, 20_100)
    assert geo.npairs * geo.tile_rows**2 <= 1.5 * geo.entries
    assert ops.gram_geometry(10, D_PAPER, 1 << 20, SM_COUNT)[:3] == (16, 1, 1)
    assert ops.gram_geometry(16, D_PAPER, 1 << 20, SM_COUNT).tile_rows == 16


@pytest.mark.parametrize("sms", [114, SM_COUNT])  # H100 PCIe, H100 SXM
@pytest.mark.parametrize("K,D", [(10, D_PAPER), (200, D_PAPER), (6, D_ADAPTER)])
def test_gram_geometry_fills_the_card(K, D, sms):
    geo = ops.gram_geometry(K, D, 1 << 20, sms)
    assert geo.npairs * geo.nsplit >= 4 * sms


@pytest.mark.parametrize("K,D", [(1, 1), (1, 7), (6, D_ADAPTER), (10, D_PAPER), (17, 100),
                                 (200, D_PAPER), (1536, D_PAPER), (3000, 50_000)])
def test_gram_geometry_covers_d_and_keeps_partials_within_the_cap(K, D):
    geo = ops.gram_geometry(K, D, 1 << 20, SM_COUNT)
    # what the C entry checks before it launches
    assert geo.chunk % ops.GRAM_TILE_D == 0 and 1 <= geo.nsplit <= 65535
    assert (geo.nsplit - 1) * geo.chunk < D <= geo.nsplit * geo.chunk
    assert geo.ntiles == -(-K // geo.tile_rows)
    assert geo.npairs == geo.ntiles * (geo.ntiles + 1) // 2
    assert geo.entries == K * (K + 1) // 2
    if geo.nsplit > 1:  # the Gram and row-norm partials of afa_screen
        assert 4 * geo.nsplit * (geo.entries + K) <= ops.GRAM_PARTIALS_CAP


def test_gram_geometry_refuses_an_empty_operand():
    with pytest.raises(ValueError, match="empty"):
        ops.gram_geometry(0, 10, 1 << 20, SM_COUNT)
