"""Declared geometry of every hand-written CUDA kernel of the port.

Counterpart of ``repro/kernels/meta.py``.  Each ``__global__`` kernel of
``csrc/*.cu`` registers a :class:`KernelGeometry` next to its wrapper in
``kernels/ops.py``: its grid as a function of the wrapper's geometry
(``ops.cosine_geometry``, ``ops.gram_geometry``, ``ops.rank_geometry``, the
flash tiles), the write map of its blocks on the outputs and the partial
scratch, what its last block or a later launch reads of them, and its
accumulation kind.  Each wrapper registers a :class:`WrapperGeometry`: the
buffers it allocates and the launches one call makes.  The declaration is
the contract; ``repro_torch.analysis.races`` rebuilds the blocks of every
recorded call from it and proves the blocks write disjoint elements, that
every element a later reader takes was written, and that the write map
agrees with the declared kind.

``accumulation`` vocabulary (the TPU kernels' sequential-grid accumulators
have no counterpart here: a CUDA grid runs its blocks in parallel):

* ``"per-block"`` — every block writes its own tiles of the outputs;
* ``"split-partials"`` — every block writes its own slot of a partial
  scratch, which a later launch sums in a fixed order;
* ``"ticket"`` — every block writes its own partials, and the block that
  draws the last ticket from an integer counter (``LastBlock`` in
  ``afa_kernels.cu``) sums them in the same launch;
* ``"single-block"`` — one block by construction.

A write map is a set of index intervals on a named buffer, each tagged with
the block that stores it (:class:`Intervals`), so a call at K = 200,
D = 535,818 is checked as a few hundred thousand intervals, not element by
element.  ``DEVICE_OPS_PER_CALL`` is the table of the device kernels one
wrapper call launches at the main path's K, which ``chip_smoke.py`` and the
linter both read.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

ACCUMULATION_KINDS = ("per-block", "split-partials", "ticket", "single-block")

H100_SMS = 132                 # multiprocessors of an H100 SXM
RESIDENT_BLOCKS_PER_SM = 8     # 2,048 threads an SM / 256: the most a resident grid takes
TICKET_STAGE = -1              # the block id the last block's stores are tagged with

# the device kernels of this repository, by the names a profiler trace shows
KERNEL_NAMES = ("weighted_sum_kernel", "cosine_sim_kernel", "gram_tf32x3_kernel",
                "gram_reduce_kernel", "afa_reduce_screen_kernel", "rank_regs_kernel",
                "rank_select_kernel", "flash_attn_tf32x3_kernel", "flash_attn_tc_kernel")

# device operations of one wrapper call at the main path's K, all this
# repository's kernels: cosine_sim one launch (its partials summed by the
# last block), afa_screen three (the Gram partials; their reduce with the
# screen in its last block; the aggregate), gram two (the partials; their
# reduce), each rank wrapper one (the register path; a bool mask read in
# place), with no copy, fill or elementwise op from the wrappers
DEVICE_OPS_PER_CALL = {"weighted_sum": ("weighted_sum_kernel",),
                       "cosine_sim": ("cosine_sim_kernel",),
                       "gram": ("gram_tf32x3_kernel", "gram_reduce_kernel"),
                       "afa_screen": ("gram_tf32x3_kernel", "afa_reduce_screen_kernel",
                                      "weighted_sum_kernel"),
                       "coord_median": ("rank_regs_kernel",),
                       "coord_median_masked": ("rank_regs_kernel",),
                       "trimmed_mean": ("rank_regs_kernel",),
                       "flash_attn": ("flash_attn_tf32x3_kernel",),
                       "flash_attn_tc": ("flash_attn_tc_kernel",)}


class Intervals(NamedTuple):
    """Half-open index intervals ``[starts[i], ends[i])`` of one buffer, each
    stored by block ``blocks[i]`` (``TICKET_STAGE`` for the last block)."""

    starts: np.ndarray
    ends: np.ndarray
    blocks: np.ndarray

    @staticmethod
    def of(starts, ends, blocks) -> "Intervals":
        starts, ends, blocks = (np.asarray(x, np.int64) for x in (starts, ends, blocks))
        starts, ends, blocks = (x.ravel() for x in np.broadcast_arrays(starts, ends, blocks))
        keep = ends > starts
        return Intervals(starts[keep], ends[keep], blocks[keep])

    @staticmethod
    def span(start: int, end: int, block: int = TICKET_STAGE) -> "Intervals":
        return Intervals.of([start], [end], [block])

    @staticmethod
    def cat(parts) -> "Intervals":
        parts = list(parts)
        if not parts:
            return Intervals.of([], [], [])
        return Intervals(*(np.concatenate(x) for x in zip(*parts)))


def grid_stride(items: int, blocks: int, threads: int, width: int, limit: int) -> Intervals:
    """The elements a grid-stride loop stores: thread t of block b takes
    items ``b threads + t + k blocks threads``, each ``width`` elements,
    so block b stores ``[(b + k blocks) threads width, ... + threads width)``
    cut at ``limit``."""
    per_pass = blocks * threads
    passes = -(-items // per_pass)
    b = np.arange(blocks, dtype=np.int64)
    k = np.arange(passes, dtype=np.int64)
    first = (b[None, :] + k[:, None] * blocks) * threads          # (passes, blocks)
    starts = first * width
    ends = np.minimum(np.minimum(first + threads, items) * width, limit)
    return Intervals.of(starts, ends, np.broadcast_to(b[None, :], first.shape))


class Launch(NamedTuple):
    """One kernel launch of a wrapper call: the kernel and the geometry its
    declaration reads."""

    kernel: str
    params: dict


class KernelGeometry(NamedTuple):
    """Declared contract of one ``__global__`` kernel.

    ``grid(params)`` is its block count; ``writes(params, grid)`` the blocks'
    stores, by buffer; ``reads(params)`` what it reads of buffers an earlier
    launch of the call or, for a ticket kernel, its own blocks wrote (by
    buffer, as intervals); ``last_writes(params)`` the last block's stores
    (ticket kernels)."""

    name: str
    accumulation: str
    grid: Callable[[dict], int]
    writes: Callable[[dict, int], dict]
    reads: Callable[[dict], dict] | None = None
    last_writes: Callable[[dict], dict] | None = None
    notes: str = ""


class WrapperGeometry(NamedTuple):
    """One wrapper of ``kernels/ops.py``: ``buffers(params)`` the tensors it
    allocates, ``name -> (elements, role)`` with role ``"out"`` (returned:
    every element must be written) or ``"scratch"``; ``launches(params)``
    the kernels one call launches, in order."""

    name: str
    buffers: Callable[[dict], dict]
    launches: Callable[[dict], list]


KERNEL_GEOMETRY: dict[str, KernelGeometry] = {}
WRAPPER_GEOMETRY: dict[str, WrapperGeometry] = {}


def register_kernel_geometry(name: str, accumulation: str, *, grid, writes, reads=None,
                             last_writes=None, notes: str = "") -> KernelGeometry:
    """Register a kernel's declared geometry (idempotent per name)."""
    if accumulation not in ACCUMULATION_KINDS:
        raise ValueError(f"accumulation {accumulation!r} invalid; expected one of "
                         f"{ACCUMULATION_KINDS}")
    if accumulation == "ticket" and (reads is None or last_writes is None):
        raise ValueError(f"kernel {name!r}: a ticket kernel declares what its last block "
                         "reads and writes")
    geom = KernelGeometry(name, accumulation, grid, writes, reads, last_writes, notes)
    KERNEL_GEOMETRY[name] = geom
    return geom


def register_wrapper_geometry(name: str, *, buffers, launches) -> WrapperGeometry:
    geom = WrapperGeometry(name, buffers, launches)
    WRAPPER_GEOMETRY[name] = geom
    return geom


def device_ops(name: str, params: dict) -> tuple:
    """The device kernels one call of wrapper ``name`` launches at its
    recorded geometry (``DEVICE_OPS_PER_CALL`` is this at the main path's
    K)."""
    return tuple(launch.kernel for launch in WRAPPER_GEOMETRY[name].launches(params))
