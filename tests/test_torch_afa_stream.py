"""The cosine kernel's plan, the screening wrappers' buffers and the screen's
index-order chains, on the CPU.

``ops.cosine_geometry`` plans the one-launch cosine kernel: its grid from
the card's SM count, the widest load that U's and w's pointers and D
allow.  The C entry checks the plan
against the operands; these tests hold the planner to what it checks
(D covered exactly by whole column groups, a split count within one wave).

The ``_*_cuda`` wrappers take the bound library explicitly, so a stand-in
library records what they pass: the cosine's padded, 16-byte aligned
partial rows; the screen's one buffer, its bool mask passed in place (no
device operation) and an integer mask compared with 0 first; the per-stream
ticket counter.  The kernels themselves run only on the card, where
``chip_smoke.py`` holds them to their twins.

On the CPU, ``ops.afa_screen`` takes bool and integer masks alike; its
result equals ``ref.afa_screen_ref``'s on the bool mask, and the JAX
package's Pallas screen (interpret mode) within RTOL.

The screen kernel's scalar chains add +0.0 for a dead client in place of
skipping it; the last test checks, in f32, that this gives the bits of the
chain that skips.
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


# --- the cosine kernel's plan -------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sms", [114, SM_COUNT])  # H100 PCIe, H100 SXM
@pytest.mark.parametrize("K,D", [(1, 1), (1, 7), (2, 64), (3, 1001), (10, 513), (6, D_ADAPTER),
                                 (10, D_PAPER), (200, D_PAPER), (1536, 50_000)])
def test_cosine_geometry_covers_d_with_whole_groups_in_one_wave(K, D, sms):
    geo = ops.cosine_geometry(K, D, BASE, sms)
    v = geo.width // 4
    # what the C entry checks before it launches
    assert D % v == 0
    assert geo.chunk >= v and geo.chunk % v == 0
    assert (geo.nsplit - 1) * geo.chunk < D <= geo.nsplit * geo.chunk
    assert 1 <= geo.nsplit <= ops.COSINE_CTAS_PER_SM * sms


@pytest.mark.parametrize("D,ptr,width", [(D_PAPER, BASE, 8), (D_ADAPTER, BASE, 16),
                                         (D_ADAPTER, BASE + 8, 8), (D_ADAPTER, BASE + 4, 4),
                                         (D_PAPER, BASE + 4, 4), (1001, BASE, 4), (6, BASE, 8)])
def test_cosine_geometry_takes_the_widest_load_the_operands_allow(D, ptr, width):
    assert ops.cosine_geometry(10, D, ptr, SM_COUNT).width == width


def test_cosine_geometry_narrows_the_load_to_the_less_aligned_operand():
    u, w = BASE, BASE + 8  # U 16-byte aligned, w only 8
    assert ops.cosine_geometry(10, D_ADAPTER, u, SM_COUNT).width == 16
    assert ops.cosine_geometry(10, D_ADAPTER, u | w, SM_COUNT).width == 8


@pytest.mark.parametrize("K,D", [(10, D_PAPER), (6, D_ADAPTER), (200, D_PAPER), (3, 100_000)])
def test_cosine_geometry_fills_the_card_or_gives_every_thread_a_group(K, D):
    geo = ops.cosine_geometry(K, D, BASE, SM_COUNT)
    full_wave = geo.nsplit == ops.COSINE_CTAS_PER_SM * SM_COUNT
    assert full_wave or geo.chunk // (geo.width // 4) == ops.COSINE_THREADS
    if D == D_PAPER:  # the paper DNN: two blocks on every SM
        assert full_wave


@pytest.mark.parametrize("D", [1, 100, 1024])
def test_cosine_geometry_gives_a_short_d_one_block(D):
    geo = ops.cosine_geometry(3, D, BASE, SM_COUNT)
    assert geo.nsplit == 1 and geo.chunk >= D
    assert geo.chunk // (geo.width // 4) >= ops.COSINE_THREADS


def test_cosine_geometry_refuses_an_empty_operand():
    with pytest.raises(ValueError, match="empty"):
        ops.cosine_geometry(0, 10, BASE, SM_COUNT)
    with pytest.raises(ValueError, match="empty"):
        ops.cosine_geometry(3, 0, BASE, SM_COUNT)


# --- the wrappers' buffers, through a stand-in library ------------------------------


class StandInLibrary:
    """Records each C entry's arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = {}

    def repro_screen_max_k(self):
        return 1528

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return self.rc
        return entry


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(ops, "_sm_count", lambda index: SM_COUNT)


def _screen_inputs(K, D, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=D).astype(np.float32)
    u = base + 0.3 * rng.normal(size=(K, D)).astype(np.float32)
    u[:(3 * K) // 10] = base + 20.0 * rng.normal(size=((3 * K) // 10, D)).astype(np.float32)
    pn = (rng.random(K) * 100 + 50).astype(np.float32)
    mask0 = np.ones(K, bool)
    mask0[-1] = False
    return torch.from_numpy(u), torch.from_numpy(pn), torch.from_numpy(mask0)


@pytest.mark.parametrize("K,D", [(1, 7), (10, 4098), (6, 4096)])
def test_cosine_wrapper_passes_padded_rows_of_partials_and_the_stream_ticket(sms, K, D):
    u, _, _ = _screen_inputs(K, D, 0)
    w = u[0].clone()
    lib = StandInLibrary()
    sims = ops._cosine_sim_cuda(lib, 7, u, w)
    (up, wp, part, sp, ticket, k, d, nsplit, chunk, width,
     stream) = lib.calls["repro_cosine_sim"]
    geo = ops.cosine_geometry(K, D, u.data_ptr() | w.data_ptr(), SM_COUNT)
    assert (up, wp, k, d, stream) == (u.data_ptr(), w.data_ptr(), K, D, 7)
    assert (nsplit, chunk, width) == (geo.nsplit, geo.chunk, geo.width)
    # 2 K + 1 rows of nsplit floats padded to a multiple of 4, read as float4
    pstride = -(-nsplit // 4) * 4
    assert part % 16 == 0
    assert sp == sims.data_ptr() == part + 4 * (2 * K + 1) * pstride
    assert sims.shape == (K,) and sims.dtype == torch.float32
    assert ticket == ops._ticket(u.device, 7).data_ptr()


def test_the_ticket_counter_is_one_zeroed_int32_per_stream():
    dev = torch.device("cpu")
    a, b = ops._ticket(dev, 101), ops._ticket(dev, 102)
    assert a is ops._ticket(dev, 101) and a is not b
    assert a.dtype == torch.int32 and a.shape == (1,) and int(a) == 0


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
def test_screen_wrapper_reads_a_bool_mask_in_place(sms, dtype):
    K, D = 10, 4098
    u, pn, mask0 = _screen_inputs(K, D, 1)
    mask = mask0.to(dtype)
    lib = StandInLibrary()
    agg, good, rounds, sims = ops._afa_screen_cuda(lib, 5, u, pn, mask, xi0=2.0,
                                                   delta_xi=0.5, max_rounds=8, ddof=0)
    args = lib.calls["repro_afa_screen"]
    (up, pnp, mp, pg, pun, g, rn, wts, ag, gd, rd, sm, ticket) = args[:13]
    assert (up, pnp) == (u.data_ptr(), pn.data_ptr())
    # a bool mask is read in place; an integer one is compared with 0 first
    assert (mp == mask.data_ptr()) == (dtype == torch.bool)
    assert (ag, gd, rd, sm) == (agg.data_ptr(), good.data_ptr(), rounds.data_ptr(),
                                sims.data_ptr())
    assert agg.data_ptr() % 16 == 0 and agg.shape == (D,) and agg.dtype == torch.float32
    assert good.dtype == torch.bool and good.shape == (K,)
    assert rounds.dtype == torch.int32 and rounds.shape == ()
    assert sims.shape == (K,) and sims.dtype == torch.float32
    assert ticket == ops._ticket(u.device, 5).data_ptr()
    geo = ops.gram_geometry(K, D, u.data_ptr(), SM_COUNT)
    assert args[13:20] == (K, D, geo.tile_rows, geo.nsplit, geo.chunk, geo.width, 2.0)
    assert args[-1] == 5
    # one buffer: its float scratch apart from the outputs
    ptrs = sorted([(agg.data_ptr(), 4 * D), (sims.data_ptr(), 4 * K), (wts, 4 * K),
                   (pg, 4 * geo.nsplit * geo.entries), (pun, 4 * geo.nsplit * K),
                   (g, 4 * K * K), (rn, 4 * K), (rounds.data_ptr(), 4), (good.data_ptr(), K)])
    for (p, n), (q, _) in zip(ptrs, ptrs[1:]):
        assert p + n <= q


@pytest.mark.parametrize("entry", ["cosine", "screen"])
def test_wrappers_raise_when_the_launch_fails(sms, entry):
    u, pn, mask0 = _screen_inputs(4, 64, 2)
    lib = StandInLibrary(rc=98)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        if entry == "cosine":
            ops._cosine_sim_cuda(lib, 0, u, u[0].clone())
        else:
            ops._afa_screen_cuda(lib, 0, u, pn, mask0, xi0=2.0, delta_xi=0.5, max_rounds=8,
                                 ddof=0)


# --- the CPU route with bool and integer masks ----------------------------------------


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
@pytest.mark.parametrize("K,D,max_rounds,seed", [(10, 400, 8, 0), (6, 256, 8, 1),
                                                 (9, 128, 1, 2), (10, 200, 0, 3)])
def test_afa_screen_takes_bool_and_integer_masks(dtype, K, D, max_rounds, seed):
    u, pn, mask0 = _screen_inputs(K, D, seed)
    mask = mask0.to(dtype) * (2 if dtype != torch.bool else 1)  # any nonzero is live
    kw = dict(xi0=2.0, delta_xi=0.5, max_rounds=max_rounds, ddof=0)
    got = ops.afa_screen(u, pn, mask, **kw)
    want = ref.afa_screen_ref(u, pn, mask0, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    jagg, jgood, jrounds, jsims = jops.afa_screen(u.numpy(), pn.numpy(), mask0.numpy(),
                                                  interpret=True, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jgood))
    assert int(got[2]) == int(jrounds)
    for a, b in ((got[0], jagg), (got[3], jsims)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * max(float(np.abs(b).max()), 1e-30))


# --- the screen's chains -----------------------------------------------------------------


def _chain(values, live, skip):
    acc = np.float32(0.0)
    for x, keep in zip(values, live):
        if keep:
            acc = np.float32(acc + x)
        elif not skip:
            acc = np.float32(acc + np.float32(0.0))
    return acc


@pytest.mark.parametrize("seed", range(6))
def test_adding_plus_zero_for_dead_clients_keeps_the_chain_bits(seed):
    rng = np.random.default_rng(seed)
    K = 40
    values = rng.normal(size=K).astype(np.float32)
    values[rng.random(K) < 0.2] = np.float32(-0.0)
    values[rng.random(K) < 0.1] *= np.float32(1e-30)
    live = rng.random(K) < (0.5 if seed % 2 else 0.05)
    skipped = _chain(values, live, skip=True)
    added = _chain(values, live, skip=False)
    assert skipped.tobytes() == added.tobytes()
    # the chain never holds -0.0: it starts at +0.0 and -0.0 + x needs x = -0.0
    assert not (added == 0 and np.signbit(added))
