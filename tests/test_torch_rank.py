"""The rank kernel's plan, its wrapper's buffers, its twins and a model of its
selection, on the CPU.

``ops.rank_geometry`` plans the kernel behind ``coord_median`` and
``trimmed_mean``: for K <= 32 the register path (a row bucket, the widest
load the operands allow, a grid of resident blocks), above it the selection
path (one block per 32-column tile).  The C entry checks the plan against
the operands; these tests hold the planner to what it checks.

``ops._rank_cuda`` takes the bound library explicitly, so a stand-in library
records what it passes: a bool mask in place (no device operation), an
integer mask compared with 0 first, the plan; a failed launch raises.

The twins equal the JAX package's Pallas kernels (interpret mode) at K on
both sides of the two paths' border, with tied, +-0.0 and +-inf columns.
``ref.trimmed_mean_rowsum_ref`` (the kernel's own arithmetic: kept values
added in row order, one division) keeps exactly the compare-count set.  A
model of the selection path (on the order-preserving key, -0.0 mapped to
+0.0: extraction near either end, a radix select between, ties by row) and
of the register path's pair compares picks the compare-count's element bit
for bit.  The kernel itself runs only
on the card, where ``chip_smoke.py`` holds it to these twins bit for bit.
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
BASE = 1 << 20   # a 256-byte aligned address
MAX_K = 1760     # repro_rank_max_k on the card


# --- the plan ----------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sms", [114, SM_COUNT])  # H100 PCIe, H100 SXM
@pytest.mark.parametrize("K,D", [(1, 1), (1, 7), (2, 64), (3, 1001), (6, D_ADAPTER),
                                 (10, D_PAPER), (16, 4099), (17, 4096), (32, D_ADAPTER),
                                 (32, D_PAPER), (33, 4099), (200, D_PAPER), (MAX_K, 50_000)])
def test_rank_geometry_covers_d_with_whole_groups(K, D, sms):
    geo = ops.rank_geometry(K, D, BASE, sms)
    if K <= ops.RANK_REG_MAX_K:
        v = geo.width // 4
        assert geo.bucket == next(b for b in (8, 16, 32) if K <= b)
        assert geo.bucket * v <= ops.RANK_REG_MAX_VALUES
        # what the C entry checks: whole groups cover D, at least one group a thread
        assert D % v == 0
        assert 1 <= geo.blocks <= -(-(D // v) // ops.RANK_THREADS)
        # and no more blocks than stay resident
        assert geo.blocks <= ops._rank_ctas_per_sm(geo.bucket, v) * sms
    else:
        assert (geo.bucket, geo.width) == (0, 4)
        assert (geo.blocks - 1) * ops.RANK_TILE < D <= geo.blocks * ops.RANK_TILE


@pytest.mark.parametrize("K,D,ptr,width", [(10, D_PAPER, BASE, 8), (6, D_ADAPTER, BASE, 16),
                                           (10, D_ADAPTER, BASE, 16), (16, D_ADAPTER, BASE, 16),
                                           (17, D_ADAPTER, BASE, 8), (32, D_ADAPTER, BASE, 8),
                                           (6, D_ADAPTER, BASE + 8, 8),
                                           (6, D_ADAPTER, BASE + 4, 4), (10, D_PAPER, BASE + 4, 4),
                                           (3, 4099, BASE, 4), (1, 2, BASE, 8)])
def test_rank_geometry_takes_the_widest_load_the_operands_allow(K, D, ptr, width):
    assert ops.rank_geometry(K, D, ptr, SM_COUNT).width == width


@pytest.mark.parametrize("K,D,blocks", [(10, D_PAPER, 4 * SM_COUNT),
                                        (6, D_ADAPTER, D_ADAPTER // 4 // 256)])
def test_rank_geometry_fills_the_card_on_the_main_path(K, D, blocks):
    """The paper DNN's K = 10: four blocks on every SM; LoRA's K = 6 (16-byte
    loads): fewer, one column group a thread."""
    geo = ops.rank_geometry(K, D, BASE, SM_COUNT)
    assert geo.blocks == blocks
    assert ops._rank_ctas_per_sm(geo.bucket, geo.width // 4) == 4


def test_rank_geometry_refuses_an_empty_operand():
    with pytest.raises(ValueError, match="empty"):
        ops.rank_geometry(0, 10, BASE, SM_COUNT)
    with pytest.raises(ValueError, match="empty"):
        ops.rank_geometry(3, 0, BASE, SM_COUNT)


# --- the wrapper, through a stand-in library ---------------------------------------


class StandInLibrary:
    """Records each C entry's arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = {}

    def repro_rank_max_k(self):
        return MAX_K

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return self.rc
        return entry


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(ops, "_sm_count", lambda index: SM_COUNT)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64, None])
@pytest.mark.parametrize("K,D,trim", [(10, 4098, None), (6, 4096, 1), (40, 4099, 3),
                                      (10, 4098, 2)])
def test_rank_wrapper_passes_a_bool_mask_in_place_and_the_plan(sms, dtype, K, D, trim):
    u = torch.randn((K, D))
    mask = None if dtype is None else (torch.arange(K) % 3 != 0).to(dtype)
    lib = StandInLibrary()
    op = "coord_median" if trim is None else "trimmed_mean"
    out = ops._rank_cuda(op, lib, 7, u, mask, trim=trim)
    args = lib.calls["repro_" + op]
    up, mp, op_, k, d = args[:5]
    assert (up, op_, k, d) == (u.data_ptr(), out.data_ptr(), K, D)
    assert out.shape == (D,) and out.dtype == torch.float32
    # a bool mask is read in place; an integer one is compared with 0 first
    if dtype is None:
        assert mp is None
    else:
        assert (mp == mask.data_ptr()) == (dtype == torch.bool)
    geo = ops.rank_geometry(K, D, u.data_ptr() | out.data_ptr(), SM_COUNT)
    rest = args[5:] if trim is None else args[6:]
    assert rest == (geo.bucket, geo.blocks, geo.width, 7)
    if trim is not None:
        assert args[5] == trim


@pytest.mark.parametrize("op", ["coord_median", "trimmed_mean"])
def test_rank_wrapper_raises_when_the_launch_fails(sms, op):
    u = torch.randn((5, 64))
    with pytest.raises(RuntimeError, match="cudaError 98"):
        ops._rank_cuda(op, StandInLibrary(rc=98), 0, u, torch.ones(5, dtype=torch.bool),
                       trim=None if op == "coord_median" else 1)


@pytest.mark.parametrize("K", [MAX_K, MAX_K + 1])
def test_rank_wrapper_refuses_k_beyond_the_tile_and_nothing_below(sms, K):
    u = torch.zeros((K, 3))
    lib = StandInLibrary()
    if K > MAX_K:
        with pytest.raises(ValueError, match=f"K={K} clients exceed the {MAX_K}"):
            ops._rank_cuda("coord_median", lib, 0, u, None)
        assert not lib.calls
    else:
        ops._rank_cuda("coord_median", lib, 0, u, None)
        assert "repro_coord_median" in lib.calls


# --- the twins against the Pallas kernels, across the paths' border ----------------

SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0], np.float32)


def _inputs(K, D, m, seed):
    """Normal values; a third of the columns integers in [-2, 2] (ties), a
    sixth drawn from +-0.0, +-inf and +-1, one column all -0.0, one all
    +0.0 and -0.0 mixed; ``m`` live rows at random positions."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(K, D)).astype(np.float32)
    n_tie, n_spec = D // 3, D // 6
    u[:, :n_tie] = rng.integers(-2, 3, size=(K, n_tie))
    u[:, n_tie:n_tie + n_spec] = rng.choice(SPECIALS, size=(K, n_spec))
    u[:, -1] = -0.0
    u[:, -2] = rng.choice(SPECIALS[:2], size=K)
    mask = np.zeros(K, bool)
    mask[rng.permutation(K)[:m]] = True
    return u, mask


def _same(got, want):
    """Equal as floats (NaN where NaN): -0.0 and +0.0 alike."""
    np.testing.assert_array_equal(np.asarray(got, np.float32), np.asarray(want, np.float32))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=RTOL * scale)


BORDER = [(31, 31), (31, 17), (32, 32), (32, 1), (33, 33), (33, 20), (64, 64), (64, 7),
          (200, 200), (200, 197)]


@pytest.mark.parametrize("K,m", BORDER)
def test_coord_median_twin_equals_pallas_across_the_border(K, m):
    u, mask = _inputs(K, 130, m, 7 * K + m)
    ut, mt = torch.from_numpy(u), torch.from_numpy(mask)
    if m == K:
        _same(ops.coord_median(ut), jops.coord_median(u, interpret=True))
    _same(ops.coord_median(ut, mt), jops.coord_median(u, mask, interpret=True))


@pytest.mark.parametrize("trim", [0, 3])
@pytest.mark.parametrize("K,m", BORDER + [(33, 6)])
def test_trimmed_mean_twins_match_pallas_across_the_border(K, m, trim):
    """The sort twin and the row-order twin, both against the Pallas
    kernel; (33, 6) with trim 3 takes the masked mean."""
    u, mask = _inputs(K, 130, m, 11 * K + m + trim)
    ut, mt = torch.from_numpy(u), torch.from_numpy(mask)
    want = jops.trimmed_mean(u, mask, trim=trim, interpret=True)
    _close(ops.trimmed_mean(ut, mt, trim=trim), want)
    _close(ref.trimmed_mean_rowsum_ref(ut, mt, trim=trim), want)


# --- the kernel's arithmetic and selection, modelled -------------------------------


def _compare_count_rank(u, live):
    """(K, D) ranks by compare-count among the live rows (ties by row);
    meaningful at live rows."""
    K = u.shape[0]
    x = u[:, None, :]   # x_i
    y = u[None, :, :]   # x_k
    idx = torch.arange(K)
    before = (idx[None, :] < idx[:, None])[:, :, None]
    counted = live[None, :, None] & ((y < x) | ((y == x) & before))
    return counted.sum(dim=1)


def _row_order_sum(u, keep, cnt):
    acc = torch.zeros(u.shape[1])
    for k in range(u.shape[0]):
        acc = torch.where(keep[k], acc + u[k], acc)
    return acc / torch.full_like(acc, float(cnt))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("trim", [0, 1, 3])
@pytest.mark.parametrize("K,m", [(1, 1), (7, 0), (7, 6), (10, 7), (33, 33), (64, 40),
                                 (200, 197)])
def test_rowsum_twin_keeps_exactly_the_compare_count_set(K, m, trim):
    u, mask = _inputs(K, 96, m, 13 * K + m + trim)
    ut, mt = torch.from_numpy(u), torch.from_numpy(mask)
    got = ref.trimmed_mean_rowsum_ref(ut, mt, trim=trim)
    if m <= 2 * trim:
        keep, cnt = mt[:, None].expand_as(ut), max(m, 1)
    else:
        rank = _compare_count_rank(ut, mt)
        keep, cnt = mt[:, None] & (rank >= trim) & (rank < m - trim), m - 2 * trim
    assert torch.equal(_bits(got), _bits(_row_order_sum(ut, keep, cnt)))
    _close(got, ref.trimmed_mean_ref(ut, mt, trim=trim))


def _keys(u):
    """The order-preserving image of f32 values as int64 in [0, 2^32), -0.0
    mapped to +0.0's key (rank_kernels.cu order_key)."""
    b = _bits(u).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    return torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


ALL = 0xFFFFFFFF
EXTRACT_MAX = 16   # rank_kernels.cu kExtractMax


def _select(keys, live, t):
    """The selection path per column (rank_kernels.cu select_key and
    nth_equal): the key of rank t, found one distinct key at a time from the
    nearer end when t is within EXTRACT_MAX of it, else by a radix select
    with one-bit digits (the largest p with #{key < p} <= t, bit by bit from
    the top); then the (t - #{key < p})-th row with that key, in row order.
    Dead rows hold all-ones keys."""
    m = int(live.sum())
    k = torch.where(live[:, None], keys, ALL)
    D = keys.shape[1]
    if t < EXTRACT_MAX or m - 1 - t < EXTRACT_MAX:
        top = t >= EXTRACT_MAX
        goal = m - 1 - t if top else t
        passed = torch.zeros(D, dtype=torch.int64)  # keys stepped past from that end
        cur = torch.where(k < ALL, k, -1).max(dim=0).values if top else k.min(dim=0).values
        p = torch.zeros(D, dtype=torch.int64)
        done = torch.zeros(D, dtype=torch.bool)
        for _ in range(goal + 1):
            n = (k == cur).sum(dim=0)
            hit = ~done & (passed + n > goal)
            p = torch.where(hit, cur, p)
            done |= hit
            passed = torch.where(done, passed, passed + n)
            nxt = (torch.where(k < cur, k, -1).max(dim=0).values if top
                   else torch.where(k > cur, k, ALL).min(dim=0).values)
            cur = torch.where(done, cur, nxt)
        assert done.all()
    else:
        p = torch.zeros(D, dtype=torch.int64)
        for b in range(31, -1, -1):
            q = p | (1 << b)
            p = torch.where((k < q).sum(dim=0) <= t, q, p)
    j = t - (k < p).sum(dim=0)
    eq = k == p
    row = ((torch.cumsum(eq.int(), dim=0) == j + 1) & eq).int().argmax(dim=0)
    return p, row


@pytest.mark.parametrize("K,m", [(33, 33), (33, 2), (64, 64), (64, 31), (200, 197), (300, 300)])
def test_selection_model_picks_the_compare_count_element(K, m):
    u, mask = _inputs(K, 160, m, 17 * K + m)
    ut, mt = torch.from_numpy(u), torch.from_numpy(mask)
    rank = _compare_count_rank(ut, mt)
    cols = torch.arange(ut.shape[1])
    # both ends, the trimmed mean's bounds at trim 3, either side of the
    # extraction's reach, the median's ranks
    ts = {0, min(3, m - 1), max(m - 4, 0), m - 1, min(15, m - 1), min(16, m - 1),
          max(m - 16, 0), max(m - 17, 0), (m - 1) // 2, m // 2}
    for t in sorted(ts):
        want_row = ((rank == t) & mt[:, None]).int().argmax(dim=0)
        key, row = _select(_keys(ut), mt, t)
        assert torch.equal(row, want_row)
        assert torch.equal(_bits(ut[row, cols]), _bits(ut[want_row, cols]))
        assert torch.equal(key, _keys(ut[want_row, cols]))


@pytest.mark.parametrize("bucket,m", [(8, 1), (8, 5), (8, 8), (16, 7), (16, 10), (16, 16),
                                      (32, 17), (32, 31), (32, 32)])
def test_packed_ranks_give_the_compare_count_rank_and_select_it(bucket, m):
    """The register path's ranks, packed (rank_kernels.cu rank_base and
    rank_column): rank i in a field of 4 bits (buckets 8 and 16) or 8 (bucket
    32), the fields from m on all ones; every pair (k < i) first counted
    toward k, then each pair with x_k <= x_i moving its count from k to i.
    The live fields equal the compare-count ranks, no field leaves [0, m - 1]
    on the way (so no carry or borrow crosses into a neighbour), and the
    zero fields of w ^ (t in every field) mark exactly the row of rank t and
    no padding field; the trimmed mean's unsigned test r - trim < m - 2 trim
    keeps exactly the ranks trim <= r < m - trim."""
    bits = 4 if bucket <= 16 else 8
    per = 32 // bits
    field = (1 << bits) - 1
    ones = sum(1 << (bits * j) for j in range(per))
    u, _ = _inputs(m, 160, m, 19 * m + bucket)
    x = torch.from_numpy(u).double()
    w = torch.zeros((bucket // per, x.shape[1]), dtype=torch.int64)
    count = torch.zeros((m, x.shape[1]), dtype=torch.int64)  # the live fields, kept apart
    for k in range(bucket):
        w[k // per] += (m - 1 - k if k < m else field) << (bits * (k % per))
        if k < m:
            count[k] = m - 1 - k
    for i in range(1, m):
        for k in range(i):
            le = (x[k] <= x[i]).long()
            w[i // per] += le << (bits * (i % per))
            w[k // per] -= le << (bits * (k % per))
            count[i] += le
            count[k] -= le
            assert bool(((count[[i, k]] >= 0) & (count[[i, k]] <= m - 1)).all())
    assert bool((w >= 0).all() & (w < 2 ** 32).all())
    fields = torch.stack([(w[i // per] >> (bits * (i % per))) & field for i in range(bucket)])
    assert torch.equal(fields[:m], count)
    assert bool((fields[m:] == field).all())
    rank = _compare_count_rank(x.float(), torch.ones(m, dtype=torch.bool))
    assert torch.equal(fields[:m], rank)
    for t in sorted({0, (m - 1) // 2, m // 2, m - 1}):
        z = w ^ (t * ones)
        hit = torch.stack([(z[i // per] & (field << (bits * (i % per)))) == 0
                           for i in range(bucket)])
        assert torch.equal(hit[:m], rank == t) and not hit[m:].any()
    for trim in range(0, (m + 1) // 2):
        kept = ((fields - trim) & 0xFFFFFFFF) < m - 2 * trim
        assert torch.equal(kept[:m], (rank >= trim) & (rank < m - trim)) and not kept[m:].any()


@pytest.mark.parametrize("K,m", [(10, 7), (33, 33), (200, 197)])
def test_median_twin_takes_the_selected_elements_bits(K, m):
    """The median of the chosen elements' own bits (-0.0 kept), as the
    kernel reads them."""
    u, mask = _inputs(K, 96, m, 23 * K + m)
    ut, mt = torch.from_numpy(u), torch.from_numpy(mask)
    keys, cols = _keys(ut), torch.arange(ut.shape[1])
    _, lo = _select(keys, mt, (m - 1) // 2)
    _, hi = _select(keys, mt, m // 2)
    want = 0.5 * (ut[lo, cols] + ut[hi, cols])
    assert torch.equal(_bits(ref.coord_median_ref(ut, mt)), _bits(want))
    assert torch.signbit(want[-1])  # the all -0.0 column keeps its sign
