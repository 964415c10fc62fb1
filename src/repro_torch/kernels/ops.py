"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Counterpart of ``repro/kernels/ops.py``.  Every wrapper checks device, dtype,
shape and contiguity, then

* for a CPU tensor takes the kernel's plain twin (``kernels/ref.py``);
* for a CUDA tensor launches the kernel on the current stream, or raises.

There is no fallback from the kernel to the twin.  ``LAUNCH_COUNTS`` holds
one plain integer per kernel, raised by one where its wrapper launches it
(CPU calls do not count), so a run can show that it went through the
kernels.  A call made while the stream is captured into a CUDA graph
launches nothing and is not counted: the graph's replays launch the
kernels, and only a profiler trace sees them.  Scratch for the split-D partial sums is allocated here with
``torch.empty``; the kernels allocate nothing.  The scratch is released
when a wrapper returns, possibly before its kernels ran: PyTorch's caching
allocator hands that memory out again only to later work on the same
stream, which runs after them.  ``cosine_sim`` and ``afa_screen`` sum their
partials in the launch that wrote them: the block that draws the last
ticket from an integer counter does it, and leaves the counter at 0
(``_ticket``).  The ``_*_cuda`` functions take the bound library and the
stream explicitly, and allocate their outputs and scratch with ``alloc``
(``torch.empty``; ``analysis.sanitize`` passes one that fills each buffer
with a sentinel, to see which elements the kernels store).

``recording()`` logs every wrapper call made inside it as a
``WrapperCall`` (name, device and the geometry the call's kernels take), on
the twin route and on the card alike, for ``repro_torch.analysis``;
``LAUNCH_COUNTS`` keeps counting the card's launches only.  Next to each
wrapper, its kernels and the wrapper itself register their declared
geometry in ``kernels/meta.py``: the grid, the blocks' write maps on the
outputs and the partial scratch, and the accumulation kind.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.build import load_library
from repro_torch.kernels.meta import Intervals, Launch
from repro_torch.utils.regions import TWIN, region

LAUNCH_COUNTS = {"weighted_sum": 0, "cosine_sim": 0, "gram": 0, "afa_screen": 0,
                 "coord_median": 0, "coord_median_masked": 0, "trimmed_mean": 0,
                 "flash_attn": 0, "flash_attn_tc": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


class WrapperCall(NamedTuple):
    """One wrapper call: the wrapper's launch-count name, the operands'
    device, and the geometry its kernels take (``kernels/meta.py``); on the
    card also the multiprocessor count (``sms``)."""

    name: str
    device: torch.device
    params: dict


_RECORDINGS: list = []


@contextlib.contextmanager
def recording():
    """Log every wrapper call made inside the block: yields a list that
    receives one ``WrapperCall`` a call, whatever its route (the twin on the
    CPU, the kernel on the card, a call recorded into a CUDA graph)."""
    log: list = []
    _RECORDINGS.append(log)
    try:
        yield log
    finally:
        _RECORDINGS[:] = [other for other in _RECORDINGS if other is not log]


def _record(name: str, t: torch.Tensor, **params) -> None:
    if not _RECORDINGS:
        return
    if t.device.type == "cuda":
        params["sms"] = _sm_count(t.device.index)
    call = WrapperCall(name, t.device, params)
    for log in _RECORDINGS:
        log.append(call)


def _twin():
    """The span of a twin's operations (``utils.regions.TWIN``): the card
    launches the kernel in their place, so host reads there do not count."""
    return region(TWIN)


def _count_launch(name: str) -> None:
    """One launch of ``name``'s kernel, unless the call was recorded into a
    CUDA graph."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCH_COUNTS[name] += 1


def _check_tensor(op: str, what: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{op}: {what} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{op}: {what} must be torch.float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{op}: {what} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {what} must be contiguous")


def _check_mask(op: str, what: str, mask, K: int) -> None:
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"{op}: {what} must be a torch.Tensor, got {type(mask).__name__}")
    if mask.ndim != 1 or mask.dtype not in (torch.bool, torch.int32, torch.int64):
        raise TypeError(f"{op}: {what} must be a 1-D bool/int tensor, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if mask.shape[0] != K:
        raise ValueError(f"{op}: {what} length {mask.shape[0]} != K={K}")


def _on_card(op: str, *tensors) -> bool:
    """True for CUDA operands (launch the kernel), False for CPU ones (take
    the twin); anything else raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{op}: no kernel for device {dev}")


def _check_rc(op: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA kernel launch failed with cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_TICKETS: dict = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The int32 counter from which the blocks of a ``cosine_sim`` or
    ``afa_screen`` launch on ``stream`` draw their tickets; the block that
    draws the last one sums the partials and sets the counter back to 0, so
    it is 0 at every launch without a device operation of its own (it is
    zeroed once, at its first use).  One counter per stream: launches on one
    stream run one after the other, but launches on two streams may run at
    once, and blocks of both drawing from one counter could take each
    other's last ticket."""
    key = (device.index, stream)
    counter = _TICKETS.get(key)
    if counter is None:
        counter = _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return counter


# ---------------------------------------------------------------------------
# weighted sum  (replaces repro/kernels/weighted_sum.py:30 weighted_sum)
# ---------------------------------------------------------------------------


def weighted_sum(weights: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """(K,), (K, d) -> (d,) reputation-weighted aggregate (f32)."""
    _check_tensor("weighted_sum", "updates", updates, 2)
    _check_tensor("weighted_sum", "weights", weights, 1)
    if weights.shape[0] != updates.shape[0]:
        raise ValueError(
            f"weighted_sum: {weights.shape[0]} weights for {updates.shape[0]} rows"
        )
    _record("weighted_sum", updates, K=updates.shape[0], D=updates.shape[1],
            ptr=updates.data_ptr())
    if not _on_card("weighted_sum", weights, updates):
        with _twin():
            return ref.weighted_sum_ref(updates, weights)
    out = _weighted_sum_cuda(load_library(), _stream(updates), weights, updates)
    _count_launch("weighted_sum")
    return out


def _weighted_sum_cuda(lib, stream, weights, updates, alloc=torch.empty):
    K, D = updates.shape
    out = alloc((D,), dtype=torch.float32, device=updates.device)
    _check_rc("weighted_sum", lib.repro_weighted_sum(
        weights.data_ptr(), updates.data_ptr(), out.data_ptr(), K, D, stream))
    return out


def _copy_width(ptr: int, D: int) -> int:
    """The widest load (16, 8 or 4 bytes) that ``ptr`` and a row of ``D``
    floats allow (a fresh output is at least 256-byte aligned)."""
    return next(w for w in (16, 8, 4) if ptr % w == 0 and (4 * D) % w == 0)


def _resident_grid(items: int, p: dict) -> int:
    """``resident_grid`` of ``afa_kernels.cu``: blocks of 256 threads that
    cover ``items`` once, at most ``meta.RESIDENT_BLOCKS_PER_SM`` an SM (the
    most the occupancy calculator can return for 256-thread blocks)."""
    return max(1, min(_ceil_div(items, 256), int(p["sms"]) * meta.RESIDENT_BLOCKS_PER_SM))


def _ws_groups(p: dict) -> tuple:
    v = _copy_width(p["ptr"], p["D"]) // 4
    return p["D"] // v, v


meta.register_kernel_geometry(
    "weighted_sum_kernel", "per-block",
    grid=lambda p: _resident_grid(_ws_groups(p)[0], p),
    writes=lambda p, grid: {p.get("out", "out"): meta.grid_stride(
        _ws_groups(p)[0], grid, 256, _ws_groups(p)[1], p["D"])},
    reads=lambda p: {p["weights"]: Intervals.span(0, p["K"])} if "weights" in p else {},
    notes="a grid-stride loop over column groups; each thread walks k in order")
meta.register_wrapper_geometry(
    "weighted_sum", buffers=lambda p: {"out": (p["D"], "out")},
    launches=lambda p: [Launch("weighted_sum_kernel", p)])


# ---------------------------------------------------------------------------
# cosine similarity  (replaces repro/kernels/cosine_sim.py:49 cosine_sim_parts)
# ---------------------------------------------------------------------------


def cosine_sim(updates: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    """(K, d), (d,) -> (K,) cosine similarities (f32); the divide clamps the
    SQUARED norms at EPS, as ``repro/kernels/ops.py`` does.  On the card one
    launch: blocks over column chunks write partial sums, and the block
    that draws the last ticket sums them in a fixed order and divides."""
    _check_tensor("cosine_sim", "updates", updates, 2)
    _check_tensor("cosine_sim", "agg", agg, 1)
    if agg.shape[0] != updates.shape[1]:
        raise ValueError(
            f"cosine_sim: agg width {agg.shape[0]} != updates width {updates.shape[1]}"
        )
    _record("cosine_sim", updates, K=updates.shape[0], D=updates.shape[1],
            ptr=updates.data_ptr() | agg.data_ptr())
    if not _on_card("cosine_sim", updates, agg):
        with _twin():
            return ref.cosine_sim_ref(updates, agg)
    out = _cosine_sim_cuda(load_library(), _stream(updates), updates, agg)
    _count_launch("cosine_sim")
    return out


COSINE_CTAS_PER_SM = 2      # blocks of the cosine kernel per multiprocessor (kCosineBlocksPerSM)
COSINE_THREADS = 512        # threads of a cosine block (kCosineThreads)


class CosineGeometry(NamedTuple):
    """How the cosine kernel cuts a (K, D) operand, passed to the C entry,
    which checks it against the operands."""

    nsplit: int        # blocks, one column chunk each
    chunk: int         # columns per block, whole groups of width / 4
    width: int         # bytes per load: 16, 8 or 4


def cosine_geometry(K: int, D: int, ptr: int, sms: int) -> CosineGeometry:
    """The cosine kernel's geometry for a (K, D) f32 operand on a card with
    ``sms`` multiprocessors; ``ptr`` is U's address OR w's (so its
    alignment is the lesser of the two).

    The widest load that ``ptr`` and the row length ``4 D`` bytes allow;
    ``COSINE_CTAS_PER_SM`` blocks on each multiprocessor, each a chunk of
    whole column groups, at least one group per thread (so a short D takes
    fewer blocks); the split count is at most ``COSINE_CTAS_PER_SM * sms``."""
    K, D = int(K), int(D)
    if K < 1 or D < 1:
        raise ValueError(f"cosine_sim: empty operand ({K}, {D})")
    width = next(w for w in (16, 8, 4) if ptr % w == 0 and (4 * D) % w == 0)
    v = width // 4
    groups = max(_ceil_div(D // v, COSINE_CTAS_PER_SM * int(sms)), COSINE_THREADS)
    chunk = groups * v
    return CosineGeometry(_ceil_div(D, chunk), chunk, width)


def _cosine_sim_cuda(lib, stream, updates, agg, alloc=torch.empty):
    K, D = updates.shape
    geo = cosine_geometry(K, D, updates.data_ptr() | agg.data_ptr(),
                          _sm_count(updates.device.index))
    npart = (2 * K + 1) * _ceil_div(geo.nsplit, 4) * 4   # rows padded for float4 reads
    buf = alloc((npart + K,), dtype=torch.float32, device=updates.device)
    part, sims = torch.split(buf, (npart, K))
    _check_rc("cosine_sim", lib.repro_cosine_sim(
        updates.data_ptr(), agg.data_ptr(), part.data_ptr(), sims.data_ptr(),
        _ticket(updates.device, stream).data_ptr(),
        K, D, geo.nsplit, geo.chunk, geo.width, stream))
    return sims


def _cosine_rows(p: dict) -> tuple:
    """(blocks, the partial rows' stride, rows 2 K + 1)."""
    geo = cosine_geometry(p["K"], p["D"], p["ptr"], p["sms"])
    return geo.nsplit, _ceil_div(geo.nsplit, 4) * 4, 2 * p["K"] + 1


def _cosine_writes(p: dict, grid: int) -> dict:
    nsplit, pstride, rows = _cosine_rows(p)
    b = np.arange(grid, dtype=np.int64)
    r = np.arange(rows, dtype=np.int64)
    slots = r[None, :] * pstride + b[:, None]              # row r's slot b, each block
    pad = Intervals.of(r * pstride + nsplit, (r + 1) * pstride, grid - 1)
    return {"part": Intervals.cat([Intervals.of(slots, slots + 1, b[:, None]), pad])}


def _cosine_last_writes(p: dict) -> dict:
    _, pstride, rows = _cosine_rows(p)
    first = np.arange(rows, dtype=np.int64) * pstride      # each row's sum, in its slot 0
    return {"part": Intervals.of(first, first + 1, meta.TICKET_STAGE),
            "sims": Intervals.span(0, p["K"])}


meta.register_kernel_geometry(
    "cosine_sim_kernel", "ticket",
    grid=lambda p: _cosine_rows(p)[0], writes=_cosine_writes,
    reads=lambda p: {"part": Intervals.span(0, _cosine_rows(p)[2] * _cosine_rows(p)[1])},
    last_writes=_cosine_last_writes,
    notes="block b owns slot b of every partial row; the last block pads the rows")
meta.register_wrapper_geometry(
    "cosine_sim",
    buffers=lambda p: {"part": (_cosine_rows(p)[2] * _cosine_rows(p)[1], "scratch"),
                       "sims": (p["K"], "out")},
    launches=lambda p: [Launch("cosine_sim_kernel", p)])


# ---------------------------------------------------------------------------
# Gram matrix  (replaces repro/kernels/gram.py:56 gram)
# ---------------------------------------------------------------------------

GRAM_TILE_D = 64                 # columns per stage of the Gram kernel (kGramTileD)
GRAM_CTAS_PER_SM = 8             # CTAs the split count aims for on each multiprocessor
GRAM_PARTIALS_CAP = 8 * 2**20    # bytes of Gram and row-norm partials at most (L2-resident)


class GramGeometry(NamedTuple):
    """How the Gram kernel cuts a (K, D) operand, passed to the C entries,
    which check it against the operands."""

    tile_rows: int     # rows of an output tile: 16 for K <= 16, else 32
    ntiles: int        # row blocks, ceil(K / tile_rows)
    npairs: int        # upper tile pairs ti <= tj, the grid's x
    nsplit: int        # column splits, the grid's y
    chunk: int         # columns per split, a multiple of GRAM_TILE_D
    width: int         # bytes per cp.async copy: 16, 8 or 4
    entries: int       # upper-triangle entries K (K + 1) / 2


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def gram_geometry(K: int, D: int, ptr: int, sms: int, *,
                  plan_rows: int | None = None) -> GramGeometry:
    """The Gram kernel's geometry for a (K, D) f32 operand at address ``ptr``
    on a card with ``sms`` multiprocessors.

    Tiles of 16 rows for K <= 16, else 32 (at K = 200: 28 upper pairs, 1.43x
    the 20,100 entries); enough column splits for ``GRAM_CTAS_PER_SM`` CTAs
    on each multiprocessor, fewer where the partials would pass
    ``GRAM_PARTIALS_CAP`` or a split would hold less than one stage; the
    widest cp.async copy that ``ptr`` and the row length ``4 D`` bytes
    allow.

    The column splits are planned for ``plan_rows`` rows (K when None, at
    least K).  An entry of the Gram sums D in the chunks of the split, so a
    run whose rows are compacted into fewer (the segmented fused engine)
    passes its full K here, and every bucket sums in the one-shot run's
    chunks.  Tiles and pairs are K's own."""
    K, D = int(K), int(D)
    if K < 1 or D < 1:
        raise ValueError(f"gram: empty operand ({K}, {D})")
    P = K if plan_rows is None else int(plan_rows)
    if P < K:
        raise ValueError(f"gram: plan_rows={P} < K={K}")
    width = next(w for w in (16, 8, 4) if ptr % w == 0 and (4 * D) % w == 0)
    bt = 16 if K <= 16 else 32
    ntiles = _ceil_div(K, bt)
    npairs = ntiles * (ntiles + 1) // 2
    entries = K * (K + 1) // 2
    plan_tiles = _ceil_div(P, 16 if P <= 16 else 32)
    plan_entries = P * (P + 1) // 2
    cap = max(GRAM_PARTIALS_CAP // (4 * (plan_entries + P)), 1)
    target = GRAM_CTAS_PER_SM * int(sms)
    n = max(1, min(_ceil_div(target, plan_tiles * (plan_tiles + 1) // 2), cap,
                   _ceil_div(D, GRAM_TILE_D), 65535))
    chunk = _ceil_div(_ceil_div(D, n), GRAM_TILE_D) * GRAM_TILE_D
    return GramGeometry(bt, ntiles, npairs, _ceil_div(D, chunk), chunk, width, entries)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gram_geometry_for(updates: torch.Tensor, plan_rows=None) -> GramGeometry:
    K, D = updates.shape
    return gram_geometry(K, D, updates.data_ptr(), _sm_count(updates.device.index),
                         plan_rows=plan_rows)


def gram(updates: torch.Tensor, *, plan_rows: int | None = None) -> torch.Tensor:
    """(K, d) -> (K, K) Gram matrix U U^T (f32).  On the card: 3xTF32 on the
    tensor cores with f32 sums (``ref.gram_3xtf32_ref`` is that arithmetic's
    twin), the column splits planned for ``plan_rows`` rows
    (``gram_geometry``); on the CPU: the f32 twin ``ref.gram_ref``."""
    _check_tensor("gram", "updates", updates, 2)
    _record("gram", updates, K=updates.shape[0], D=updates.shape[1], ptr=updates.data_ptr(),
            plan_rows=plan_rows)
    if not _on_card("gram", updates):
        with _twin():
            return ref.gram_ref(updates)
    out = _gram_cuda(load_library(), _stream(updates), updates, plan_rows)
    _count_launch("gram")
    return out


def _gram_cuda(lib, stream, updates, plan_rows=None, alloc=torch.empty):
    K, D = updates.shape
    geo = _gram_geometry_for(updates, plan_rows)
    pg = alloc((geo.nsplit * geo.entries,), dtype=torch.float32, device=updates.device)
    g = alloc((K, K), dtype=torch.float32, device=updates.device)
    _check_rc("gram", lib.repro_gram(
        updates.data_ptr(), pg.data_ptr(), g.data_ptr(), K, D,
        geo.tile_rows, geo.nsplit, geo.chunk, geo.width, stream))
    return g


def _gram_geo(p: dict) -> GramGeometry:
    return gram_geometry(p["K"], p["D"], p["ptr"], p["sms"], plan_rows=p.get("plan_rows"))


def _upper_entries(K: int, bt: int):
    """Rows, columns and tile pair of the upper-triangle entries of a K x K
    Gram, in ``tri_index`` order; pair ``(ti, tj)`` is numbered as the
    kernel's ``blockIdx.x`` walks them."""
    i, j = np.triu_indices(K)
    ntiles = _ceil_div(K, bt)
    ti, tj = i // bt, j // bt
    return i, j, ti * ntiles - ti * (ti - 1) // 2 + (tj - ti)


def _gram_partial_writes(p: dict, grid: int) -> dict:
    """Block (pair, split), numbered ``split * npairs + pair``, stores the
    split's partial of every entry of its tile pair (and, on a diagonal pair
    with ``norms``, of its rows' squared norms)."""
    geo = _gram_geo(p)
    i, _, pair = _upper_entries(p["K"], geo.tile_rows)
    s = np.arange(geo.nsplit, dtype=np.int64)[:, None]
    pos = np.arange(i.shape[0], dtype=np.int64)[None, :] * geo.nsplit + s
    out = {"pg": Intervals.of(pos, pos + 1, s * geo.npairs + pair[None, :])}
    if p.get("norms"):
        rows = np.arange(p["K"], dtype=np.int64)
        ti = rows // geo.tile_rows
        diag = ti * geo.ntiles - ti * (ti - 1) // 2
        pos = rows[None, :] * geo.nsplit + s
        out["pun"] = Intervals.of(pos, pos + 1, s * geo.npairs + diag[None, :])
    return out


meta.register_kernel_geometry(
    "gram_tf32x3_kernel", "split-partials",
    grid=lambda p: _gram_geo(p).npairs * _gram_geo(p).nsplit,
    writes=_gram_partial_writes,
    notes="entry-major partials: entry e's split s at e * nsplit + s")


def _reduce_writes(p: dict, grid: int) -> dict:
    """Warp w of the grid-stride loop (block ``(w mod 8 grid) / 8``) writes
    G[i, j] and G[j, i] of upper entry w, then the row norms."""
    K = p["K"]
    i, j, _ = _upper_entries(K, 16)
    w = np.arange(i.shape[0], dtype=np.int64)
    block = (w % (8 * grid)) // 8
    off = i != j
    lower = (j * K + i)[off]
    g = Intervals.cat([Intervals.of(i * K + j, i * K + j + 1, block),
                       Intervals.of(lower, lower + 1, block[off])])
    out = {p["g"]: g}
    if p.get("norms"):
        k = np.arange(K, dtype=np.int64)
        out["rn"] = Intervals.of(k, k + 1, ((w.shape[0] + k) % (8 * grid)) // 8)
    return out


def _reduce_reads(p: dict) -> dict:
    ne = p["K"] * (p["K"] + 1) // 2
    nsplit = _gram_geo(p).nsplit
    reads = {"pg": Intervals.span(0, ne * nsplit)}
    if p.get("norms"):
        reads["pun"] = Intervals.span(0, p["K"] * nsplit)
    return reads


meta.register_kernel_geometry(
    "gram_reduce_kernel", "per-block",
    grid=lambda p: _resident_grid(p["K"] * (p["K"] + 1) // 2 * 32, p),
    writes=_reduce_writes, reads=_reduce_reads,
    notes="one warp an entry, in a grid-stride loop; the splits summed in order")
meta.register_wrapper_geometry(
    "gram",
    buffers=lambda p: {"pg": (_gram_geo(p).nsplit * _gram_geo(p).entries, "scratch"),
                       "g": (p["K"] * p["K"], "out")},
    launches=lambda p: [Launch("gram_tf32x3_kernel", p),
                        Launch("gram_reduce_kernel", dict(p, g="g"))])


# ---------------------------------------------------------------------------
# fused AFA screening  (replaces repro/kernels/afa_screen.py:223 afa_screen_call)
# ---------------------------------------------------------------------------


def afa_screen(updates: torch.Tensor, pn: torch.Tensor, mask0: torch.Tensor, *,
               xi0: float, delta_xi: float, max_rounds: int, ddof: int = 0,
               plan_rows: int | None = None):
    """Algorithm 1 through the screening kernel -> ``(aggregate (d,),
    good_mask (K,) bool, rounds () int32, sims (K,))``.

    ``pn`` is the (K,) weight vector ``p_k * n_k``, ``mask0`` the (K,)
    initial participation (bool or integer; any nonzero entry is live).  On
    the card three launches: the Gram and row-norm partials (3xTF32 on the
    tensor cores); their reduce, whose last block runs the screen; the
    weighted sum of U with the final weights."""
    _check_tensor("afa_screen", "updates", updates, 2)
    _check_tensor("afa_screen", "pn", pn, 1)
    K = updates.shape[0]
    _check_mask("afa_screen", "mask0", mask0, K)
    if pn.shape[0] != K:
        raise ValueError(f"afa_screen: pn length {pn.shape[0]} != K={K}")
    kw = dict(xi0=float(xi0), delta_xi=float(delta_xi),
              max_rounds=int(max_rounds), ddof=int(ddof))
    _record("afa_screen", updates, K=K, D=updates.shape[1], ptr=updates.data_ptr(),
            plan_rows=plan_rows)
    if not _on_card("afa_screen", updates, pn, mask0):
        with _twin():
            return ref.afa_screen_ref(updates, pn, mask0, **kw)
    out = _afa_screen_cuda(load_library(), _stream(updates), updates, pn, mask0,
                           plan_rows=plan_rows, **kw)
    _count_launch("afa_screen")
    return out


def _afa_screen_cuda(lib, stream, updates, pn, mask0, *, xi0, delta_xi,
                     max_rounds, ddof, plan_rows=None, alloc=torch.empty):
    """Three launches: the Gram partials, their reduce with the screen in
    its last block, and the aggregate.  The kernels read ``mask0`` and write
    ``good`` as one byte per client, torch.bool's storage, so a bool mask
    costs no device operation here (an integer one is compared with 0
    first)."""
    K, D = updates.shape
    max_k = lib.repro_screen_max_k()
    if K > max_k:
        raise ValueError(
            f"afa_screen: K={K} clients exceed the {max_k} the one-block screen "
            "holds in shared memory"
        )
    if mask0.dtype != torch.bool:
        mask0 = mask0 != 0
    mask0 = mask0.contiguous()
    geo = _gram_geometry_for(updates, plan_rows)
    # one buffer, carved into the outputs and the kernels' scratch: floats
    # (agg first, at the allocation's alignment, for the aggregate's vector
    # stores), the int32 round count, then one byte per client for good
    sizes = (D, K, K, geo.nsplit * geo.entries, geo.nsplit * K, K * K, K, 1)
    nfloat = sum(sizes)
    buf = alloc((4 * nfloat + K,), dtype=torch.uint8, device=updates.device)
    agg, sims, weights, pg, pun, G, rn, rounds = torch.split(
        buf[:4 * nfloat].view(torch.float32), sizes)
    rounds = rounds.view(torch.int32)
    good = buf[4 * nfloat:].view(torch.bool)
    _check_rc("afa_screen", lib.repro_afa_screen(
        updates.data_ptr(), pn.data_ptr(), mask0.data_ptr(), pg.data_ptr(), pun.data_ptr(),
        G.data_ptr(), rn.data_ptr(), weights.data_ptr(), agg.data_ptr(), good.data_ptr(),
        rounds.data_ptr(), sims.data_ptr(), _ticket(updates.device, stream).data_ptr(),
        K, D, geo.tile_rows, geo.nsplit, geo.chunk, geo.width, xi0, delta_xi, max_rounds,
        ddof, stream))
    return agg, good, rounds[0], sims


def _screen_reads(p: dict) -> dict:
    K = p["K"]
    return {**_reduce_reads(p), "G": Intervals.span(0, K * K), "rn": Intervals.span(0, K)}


meta.register_kernel_geometry(
    "afa_reduce_screen_kernel", "ticket",
    grid=lambda p: _resident_grid((p["K"] * (p["K"] + 1) // 2 + p["K"]) * 32, p),
    writes=_reduce_writes, reads=_screen_reads,
    last_writes=lambda p: {name: Intervals.span(0, n) for name, n in
                           (("weights", p["K"]), ("good", p["K"]), ("rounds", 1),
                            ("sims", p["K"]))},
    notes="the Gram reduce; the block that draws the last ticket screens")
meta.register_wrapper_geometry(
    "afa_screen",
    buffers=lambda p: {"pg": (_gram_geo(p).nsplit * _gram_geo(p).entries, "scratch"),
                       "pun": (_gram_geo(p).nsplit * p["K"], "scratch"),
                       "G": (p["K"] * p["K"], "scratch"), "rn": (p["K"], "scratch"),
                       "weights": (p["K"], "scratch"), "agg": (p["D"], "out"),
                       "good": (p["K"], "out"), "rounds": (1, "out"),
                       "sims": (p["K"], "out")},
    launches=lambda p: [Launch("gram_tf32x3_kernel", dict(p, norms=True)),
                        Launch("afa_reduce_screen_kernel", dict(p, norms=True, g="G")),
                        Launch("weighted_sum_kernel", dict(p, out="agg", weights="weights"))])


# ---------------------------------------------------------------------------
# coordinate-wise median  (replaces repro/kernels/coord_median.py:37
# _coord_median_kernel and :51 _coord_median_masked_kernel)
# ---------------------------------------------------------------------------


def coord_median(updates: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(K, d) [+ (K,) mask] -> (d,) coordinate-wise median (f32).

    The median of the live rows, by compare-count rank with ties broken by
    client index; 0 where no row is live.  K is never padded.  On the card
    one launch (``rank_geometry``).  A call without a mask counts as a
    ``coord_median`` launch, one with a mask as ``coord_median_masked``."""
    _check_tensor("coord_median", "updates", updates, 2)
    operands = (updates,)
    if mask is not None:
        _check_mask("coord_median", "mask", mask, updates.shape[0])
        operands = (updates, mask)
    _record("coord_median" if mask is None else "coord_median_masked", updates,
            K=updates.shape[0], D=updates.shape[1], ptr=updates.data_ptr())
    if not _on_card("coord_median", *operands):
        with _twin():
            return ref.coord_median_ref(updates, mask)
    out = _rank_cuda("coord_median", load_library(), _stream(updates), updates, mask)
    _count_launch("coord_median" if mask is None else "coord_median_masked")
    return out


# ---------------------------------------------------------------------------
# coordinate-wise trimmed mean  (replaces repro/kernels/trimmed_mean.py:33
# _trimmed_mean_kernel)
# ---------------------------------------------------------------------------


def trimmed_mean(updates: torch.Tensor, mask: torch.Tensor, *, trim: int) -> torch.Tensor:
    """(K, d), (K,) mask -> (d,) coordinate-wise trimmed mean (f32): the live
    values of rank ``trim <= r < m - trim`` averaged, or the masked mean when
    the live count ``m <= 2 trim``.  On the card the kernel adds the kept
    values in ascending row order and divides once
    (``ref.trimmed_mean_rowsum_ref`` is that arithmetic's twin); on the CPU:
    the sort twin ``ref.trimmed_mean_ref``."""
    _check_tensor("trimmed_mean", "updates", updates, 2)
    _check_mask("trimmed_mean", "mask", mask, updates.shape[0])
    trim = int(trim)
    if trim < 0:
        raise ValueError(f"trimmed_mean: trim={trim} must be >= 0")
    _record("trimmed_mean", updates, K=updates.shape[0], D=updates.shape[1],
            ptr=updates.data_ptr())
    if not _on_card("trimmed_mean", updates, mask):
        with _twin():
            return ref.trimmed_mean_ref(updates, mask, trim=trim)
    out = _rank_cuda("trimmed_mean", load_library(), _stream(updates), updates, mask, trim=trim)
    _count_launch("trimmed_mean")
    return out


RANK_THREADS = 256          # threads of a rank block (kRankThreads)
RANK_REG_MAX_K = 32         # the register path's largest K (kRegMaxK)
RANK_REG_MAX_VALUES = 64    # values a thread of the register path holds at most (kRegMaxValues)
RANK_TILE = 32              # columns of a selection block's tile (kTile)


class RankGeometry(NamedTuple):
    """How the rank kernel cuts a (K, D) operand, passed to the C entries,
    which check it against the operands."""

    bucket: int        # rows a register-path thread holds: 8, 16 or 32; 0 on the selection path
    blocks: int        # the grid
    width: int         # bytes per load: 16, 8 or 4 (4 on the selection path)


def _rank_ctas_per_sm(bucket: int, v: int) -> int:
    """Blocks of the register path on one multiprocessor (the kernel's launch
    bounds): four where ``bucket (v + 1) <= 48`` (a thread's values, with
    room for its ranks and addresses within 64 registers), else two."""
    return 4 if bucket * (v + 1) <= 48 else 2


def rank_geometry(K: int, D: int, ptr: int, sms: int) -> RankGeometry:
    """The rank kernel's plan for a (K, D) f32 operand on a card with ``sms``
    multiprocessors; ``ptr`` is U's address OR the output's.

    K <= ``RANK_REG_MAX_K``: the register path.  Rows in a bucket of 8, 16 or
    32; the widest load that ``ptr`` and the row length ``4 D`` bytes allow
    within ``RANK_REG_MAX_VALUES`` values a thread; as many blocks as stay
    resident (``_rank_ctas_per_sm`` an SM), no more than one column group a
    thread.  Above: the selection path, one block per ``RANK_TILE`` columns
    and 4-byte copies."""
    K, D = int(K), int(D)
    if K < 1 or D < 1:
        raise ValueError(f"rank: empty operand ({K}, {D})")
    if K > RANK_REG_MAX_K:
        return RankGeometry(0, _ceil_div(D, RANK_TILE), 4)
    bucket = next(b for b in (8, 16, 32) if K <= b)
    width = next(w for w in (16, 8, 4) if ptr % w == 0 and (4 * D) % w == 0
                 and bucket * (w // 4) <= RANK_REG_MAX_VALUES)
    v = width // 4
    blocks = min(_ceil_div(D // v, RANK_THREADS), _rank_ctas_per_sm(bucket, v) * int(sms))
    return RankGeometry(bucket, blocks, width)


def _rank_cuda(op, lib, stream, updates, mask, *, trim=None, alloc=torch.empty):
    """One launch of the median (``trim`` None) or the trimmed mean, on
    ``rank_geometry``'s plan.  The kernel reads the mask as one byte per
    client, torch.bool's storage, so a bool mask costs no device operation
    here (an integer one is compared with 0 first); ``mask`` None passes a
    null pointer (every row live)."""
    K, D = updates.shape
    max_k = lib.repro_rank_max_k()
    if K > max_k:
        raise ValueError(f"{op}: K={K} clients exceed the {max_k} a 32-column "
                         "shared-memory tile holds")
    out = alloc((D,), dtype=torch.float32, device=updates.device)
    if mask is not None:
        if mask.dtype != torch.bool:
            mask = mask != 0
        mask = mask.contiguous()
    mptr = None if mask is None else mask.data_ptr()
    geo = rank_geometry(K, D, updates.data_ptr() | out.data_ptr(),
                        _sm_count(updates.device.index))
    plan = (geo.bucket, geo.blocks, geo.width, stream)
    if trim is None:
        rc = lib.repro_coord_median(updates.data_ptr(), mptr, out.data_ptr(), K, D, *plan)
    else:
        rc = lib.repro_trimmed_mean(updates.data_ptr(), mptr, out.data_ptr(), K, D, trim, *plan)
    _check_rc(op, rc)
    return out


def _rank_geo(p: dict) -> RankGeometry:
    return rank_geometry(p["K"], p["D"], p["ptr"], p["sms"])


meta.register_kernel_geometry(
    "rank_regs_kernel", "per-block",
    grid=lambda p: _rank_geo(p).blocks,
    writes=lambda p, grid: {"out": meta.grid_stride(
        p["D"] // (_rank_geo(p).width // 4), grid, RANK_THREADS, _rank_geo(p).width // 4,
        p["D"])},
    notes="a grid-stride loop over column groups, K <= RANK_REG_MAX_K")
meta.register_kernel_geometry(
    "rank_select_kernel", "per-block",
    grid=lambda p: _ceil_div(p["D"], RANK_TILE),
    writes=lambda p, grid: {"out": Intervals.of(
        np.arange(grid, dtype=np.int64) * RANK_TILE,
        np.minimum((np.arange(grid, dtype=np.int64) + 1) * RANK_TILE, p["D"]),
        np.arange(grid, dtype=np.int64))},
    notes="one block a tile of RANK_TILE columns, K > RANK_REG_MAX_K")
for _name in ("coord_median", "coord_median_masked", "trimmed_mean"):
    meta.register_wrapper_geometry(
        _name, buffers=lambda p: {"out": (p["D"], "out")},
        launches=lambda p: [Launch("rank_regs_kernel" if _rank_geo(p).bucket
                                   else "rank_select_kernel", p)])


# ---------------------------------------------------------------------------
# flash attention  (replaces repro/kernels/flash_attn.py:76 flash_attention_bh
# and its body :33 _flash_attn_kernel, through repro/kernels/ops.py:319)
# ---------------------------------------------------------------------------

# kernel dtype codes of repro_flash_attn
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ATTN_MAX_D = 128
ATTN_TC_BLOCK_K = 64   # keys per tile of both attention kernels (kBK in attn_kernels.cu)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(B, Lq, Hq, D), (B, Lk, Hkv, D) x2 -> (B, Lq, Hq, D) attention, scale
    1/sqrt(D), returned in q's dtype.

    The mask is the TPU kernel's: causal keys ``kpos <= qpos`` aligned
    top-left, so ``Lq != Lk`` is allowed; query head h reads kv head
    ``h // (Hq / Hkv)``.  Both kernels run on the tensor cores (``mma.sync``
    with f32 accumulation); which one depends on the dtype:

    * float32: ``flash_attn_tf32x3_kernel`` (counted as ``flash_attn``),
      3xTF32: each operand of q k^T and p.v splits into two TF32 halves, and
      three exact products (lo hi', hi lo', hi hi') take the place of one f32
      product; the tensor cores sum at most 64 d columns or 64 keys into a
      zeroed tile, and the softmax and the recurrence are f32.  It reads as
      close to exact attention as f32 does;
      ``ref.flash_attention_3xtf32_ref`` is its twin;
    * bfloat16 / float16: ``flash_attn_tc_kernel`` (``mma.sync`` m16n8k16;
      counted as ``flash_attn_tc``).  q k^T is exact products summed in f32
      and the softmax is f32, but p is rounded to the input dtype before
      p.v -- the one place the arithmetic leaves f32;
      ``ref.flash_attention_tc_ref`` is its twin.

    Tiles load by 16-byte copies when D is a multiple of the elements in 16
    bytes and every pointer is 16-byte aligned (``attn_flags``), else
    element by element (the same kernel).  Both kernels take 64 query rows
    by ``ATTN_TC_BLOCK_K`` = 64 keys per tile and D <= ``ATTN_MAX_D``.
    ``block_q``/``block_k`` are the JAX wrapper's tile hints, checked and
    otherwise unused.  On the CPU the call takes the
    exact twin ``ref.flash_attention_ref`` for every dtype.  There is no
    backward (the JAX package has none either): the call raises when grad is
    enabled and any operand requires grad."""
    op = "flash_attention"
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {what} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in _ATTN_DTYPES:
            raise TypeError(f"{op}: {what} must be float32, bfloat16 or float16, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{op}: {what} must be 4-D (B, L, H, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {what} must be contiguous")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{op}: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    B, Lq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{op}: k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    Lk, Hkv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{op}: Hq={Hq} query heads are not a multiple of Hkv={Hkv}")
    if not 1 <= D <= ATTN_MAX_D:
        raise ValueError(f"{op}: head dim D={D} outside the kernel's 1..{ATTN_MAX_D}")
    if Lk < 1:
        raise ValueError(f"{op}: no keys (Lk=0)")
    if int(block_q) < 1 or int(block_k) < 1:
        raise ValueError(f"{op}: block hints must be positive, got {block_q}, {block_k}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            f"{op}: the kernel has no backward, as the JAX package's Pallas kernel has "
            "none; run it under torch.no_grad() or train through the plain blocked "
            "attention (use_pallas_attention=False)"
        )
    _record("flash_attn" if q.dtype == torch.float32 else "flash_attn_tc", q, B=B, Lq=Lq,
            Lk=Lk, Hq=Hq, Hkv=Hkv, D=D, causal=bool(causal))
    if not _on_card(op, q, k, v):
        with _twin():
            return ref.flash_attention_ref(q, k, v, causal=causal)
    out = _flash_attention_cuda(load_library(), _stream(q), q, k, v, causal=causal)
    _count_launch("flash_attn" if q.dtype == torch.float32 else "flash_attn_tc")
    return out


def attn_flags(q, k, v, out, *, causal: bool) -> int:
    """``repro_flash_attn``'s flags: bit 0 causal; bit 1 16-byte tile copies,
    where D is a multiple of the elements in 16 bytes (4 in f32, 8 in
    bf16/f16) and every pointer is 16-byte aligned."""
    vec = (q.shape[-1] % (16 // q.element_size()) == 0
           and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    return int(bool(causal)) | (int(vec) << 1)


def _flash_attention_cuda(lib, stream, q, k, v, *, causal, alloc=torch.empty):
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    out = alloc(q.shape, dtype=q.dtype, device=q.device)
    _check_rc("flash_attention", lib.repro_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ATTN_DTYPES[q.dtype],
        B, Lq, Lk, Hq, Hkv, D, 1.0 / D ** 0.5, attn_flags(q, k, v, out, causal=causal),
        stream))
    return out


ATTN_BLOCK_Q = 64   # query rows of a block of both attention kernels (kBQ in attn_kernels.cu)


def _attn_grid(p: dict) -> int:
    return _ceil_div(p["Lq"], ATTN_BLOCK_Q) * p["B"] * p["Hq"]


def _attn_writes(p: dict, grid: int) -> dict:
    """Block x takes query block ``nq - 1 - x mod nq`` of (batch, head)
    ``x / nq`` and stores its rows of that head: D floats a row of the
    (B, Lq, Hq, D) output."""
    B, Lq, Hq, D = p["B"], p["Lq"], p["Hq"], p["D"]
    nq = _ceil_div(Lq, ATTN_BLOCK_Q)
    x = np.arange(grid, dtype=np.int64)[:, None]
    row = (nq - 1 - x % nq) * ATTN_BLOCK_Q + np.arange(ATTN_BLOCK_Q, dtype=np.int64)[None, :]
    b, h = (x // nq) // Hq, (x // nq) % Hq
    start = ((b * Lq + row) * Hq + h) * D
    keep = np.broadcast_to(row < Lq, start.shape)
    return {"out": Intervals.of(start[keep], start[keep] + D,
                                np.broadcast_to(x, start.shape)[keep])}


for _name, _kernel in (("flash_attn", "flash_attn_tf32x3_kernel"),
                       ("flash_attn_tc", "flash_attn_tc_kernel")):
    meta.register_kernel_geometry(
        _kernel, "per-block", grid=_attn_grid, writes=_attn_writes,
        notes="one block a (64-query block, batch x query head); the key loop in registers")
    meta.register_wrapper_geometry(
        _name, buffers=lambda p: {"out": (p["B"] * p["Lq"] * p["Hq"] * p["D"], "out")},
        launches=lambda p, _kernel=_kernel: [Launch(_kernel, p)])


def pairwise_sq_dists_from_gram(g: torch.Tensor) -> torch.Tensor:
    """(K, K) Gram matrix -> (K, K) squared euclidean distances, clamped at 0."""
    sq = torch.diagonal(g)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * g, min=0.0)
