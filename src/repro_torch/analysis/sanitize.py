"""The kernels' declared write maps held to the kernels themselves, on the card.

``races`` proves the declarations of ``kernels/meta.py`` race-free; this
module checks, on the card, that the compiled kernels do what the
declarations say, at small edge shapes of each of the nine kernels (the
wrappers' geometry, the Gram and rank edge shapes of ``chip_smoke.py``,
one short causal flash call a dtype).  Both checks call the wrappers' own
``kernels.ops._*_cuda`` functions, the path the port runs, and differ only
in the allocator they pass:

* ``sentinel_checks``: every output and scratch allocation is filled with a
  NaN sentinel, with ``GUARD_BYTES`` more past its end, and the elements
  that changed must be exactly the declared write map's (a partial the
  kernel never wrote stays a sentinel; a store outside the map changes one
  it should not); each allocation's bytes must also equal its declared
  buffers' (``LAYOUT``);
* ``run_sanitizer``: ``compute-sanitizer`` (``racecheck``: shared-memory
  hazards; ``initcheck``: every global element a kernel reads was written;
  then ``memcheck`` and ``synccheck`` while the budget lasts) over the same
  cases in a child process (``python -m repro_torch.analysis.sanitize
  CASES.json``) on ``torch.empty``'s unwritten memory, filtered to this
  repository's kernels (``--kernel-name``).  A missing
  ``compute-sanitizer`` raises.  A probe of the CUDA runtime alone runs
  first; a sanitizer that refuses the device there runs no tool, and the
  result says which tools were not run.

Everything but the CPU test of ``sentinel_checks`` (a stand-in library)
needs the card and the built kernel library.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

SENTINEL32 = 0x7FC0DEAD          # a float32 NaN no kernel computes; its bytes are not 0 or 1
SENTINEL16 = 0x7FAD              # a bf16 and an f16 NaN
GUARD_BYTES = 256                # sentinel bytes past each allocation's end
KERNEL_REGEX = ("(weighted_sum|cosine_sim|gram_tf32x3|gram_reduce|afa_reduce_screen|rank_regs|"
                "rank_select|flash_attn_tf32x3|flash_attn_tc)_kernel")
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
TOOLS = ("racecheck", "initcheck")          # run always
OPTIONAL_TOOLS = ("memcheck", "synccheck")  # run while the budget lasts
RANK = ("coord_median", "coord_median_masked", "trimmed_mean")
AFA_KEYS = ("xi0", "delta_xi", "max_rounds", "ddof")
TRIM = 3                         # rows the trimmed-mean cases cut at each end
# the declared buffers (``kernels/meta.py``) that each allocation of a
# wrapper's ``_*_cuda`` function holds, in order
LAYOUT = {"weighted_sum": (("out",),), "cosine_sim": (("part", "sims"),),
          "gram": (("pg",), ("g",)),
          "afa_screen": (("agg", "sims", "weights", "pg", "pun", "G", "rn", "rounds", "good"),),
          **{name: (("out",),) for name in RANK + ("flash_attn", "flash_attn_tc")}}


def edge_cases(gram_edges, rank_ks, rank_layouts) -> list:
    """``(wrapper, params)`` of every case: the streaming wrappers and the
    Gram wrappers at ``gram_edges`` ``(K, D, byte offset)``, the rank
    wrappers at ``rank_ks`` x ``rank_layouts`` ``(D, byte offset)``, and one
    short causal flash call in each dtype.  The screening takes
    ``AFAConfig``'s defaults, the trimmed mean ``TRIM``."""
    from repro_torch.core.afa import AFAConfig

    screen = {k: getattr(AFAConfig(), k) for k in AFA_KEYS}
    cases = []
    for K, D, off in gram_edges:
        for name in ("weighted_sum", "cosine_sim", "gram", "afa_screen"):
            cases.append((name, dict(K=K, D=D, offset=off,
                                     **(screen if name == "afa_screen" else {}))))
    for K in rank_ks:
        for D, off in rank_layouts:
            for name in RANK:
                cases.append((name, dict(K=K, D=D, offset=off,
                                         **({"trim": TRIM} if name == "trimmed_mean" else {}))))
    for dtype in ("float32", "bfloat16", "float16"):
        cases.append(("flash_attn" if dtype == "float32" else "flash_attn_tc",
                      dict(B=2, Lq=100, Lk=100, Hq=4, Hkv=2, D=64, causal=True, dtype=dtype)))
    return cases


def _placed(torch, host, offset: int, device):
    """``host`` copied to ``device``, its data ``offset`` bytes into a fresh
    allocation (a copy from the host: initialized for initcheck)."""
    flat = host.reshape(-1)
    pad = offset // flat.element_size()
    buf = torch.empty((flat.numel() + pad,), dtype=flat.dtype, device=device)
    view = buf[pad:pad + flat.numel()]
    view.copy_(flat)
    return view.view(host.shape)


def _inputs(torch, name: str, p: dict, seed: int, device) -> dict:
    gen = torch.Generator()
    gen.manual_seed(seed)
    if name.startswith("flash"):
        dt = getattr(torch, p["dtype"])
        q = torch.randn((p["B"], p["Lq"], p["Hq"], p["D"]), generator=gen).to(dt)
        kv = [torch.randn((p["B"], p["Lk"], p["Hkv"], p["D"]), generator=gen).to(dt)
              for _ in range(2)]
        return {n: _placed(torch, t, 0, device) for n, t in zip("qkv", [q, *kv])}
    K, D, off = p["K"], p["D"], p["offset"]
    u = torch.randn((K, D), generator=gen)
    u[: (3 * K) // 10] *= 20.0
    ins = {"u": _placed(torch, u, off, device)}
    if name in ("weighted_sum", "afa_screen"):
        ins["c" if name == "weighted_sum" else "pn"] = _placed(
            torch, torch.rand((K,), generator=gen) + 0.5, 0, device)
    if name == "cosine_sim":
        ins["w"] = _placed(torch, torch.randn((D,), generator=gen), 0, device)
    if name in ("afa_screen", "coord_median_masked", "trimmed_mean"):
        mask = torch.ones((K,), dtype=torch.bool)
        mask[-1] = K < 3
        ins["mask"] = _placed(torch, mask, 0, device)
    return ins


def _call(name: str, p: dict, ins: dict, lib, stream: int, alloc):
    """One call of the wrapper's ``kernels.ops._*_cuda`` function, its
    buffers from ``alloc``."""
    from repro_torch.kernels import ops

    u = ins.get("u")
    if name == "weighted_sum":
        return ops._weighted_sum_cuda(lib, stream, ins["c"], u, alloc=alloc)
    if name == "cosine_sim":
        return ops._cosine_sim_cuda(lib, stream, u, ins["w"], alloc=alloc)
    if name == "gram":
        return ops._gram_cuda(lib, stream, u, p.get("plan_rows"), alloc=alloc)
    if name == "afa_screen":
        return ops._afa_screen_cuda(lib, stream, u, ins["pn"], ins["mask"],
                                    plan_rows=p.get("plan_rows"), alloc=alloc,
                                    **{k: p[k] for k in AFA_KEYS})
    if name in RANK:
        return ops._rank_cuda(name, lib, stream, u, ins.get("mask"), trim=p.get("trim"),
                              alloc=alloc)
    return ops._flash_attention_cuda(lib, stream, ins["q"], ins["k"], ins["v"],
                                     causal=p["causal"], alloc=alloc)


class SentinelAlloc:
    """An ``alloc`` for the ``_*_cuda`` functions: each allocation with
    ``GUARD_BYTES`` past its end, every byte filled with the sentinel of the
    dtype's width; ``allocations`` keeps ``(bytes asked, raw bytes, their
    fill)`` of each, in order."""

    def __init__(self, torch):
        self.torch = torch
        self.allocations: list = []

    def __call__(self, shape, *, dtype, device):
        torch = self.torch
        nbytes = int(np.prod(shape)) * dtype.itemsize
        raw = torch.empty((-(-(nbytes + GUARD_BYTES) // 4) * 4,), dtype=torch.uint8,
                          device=device)
        if dtype.itemsize == 2:
            raw.view(torch.int16).fill_(SENTINEL16)
        else:
            raw.view(torch.int32).fill_(SENTINEL32)
        self.allocations.append((nbytes, raw, raw.clone()))
        return raw[:nbytes].view(dtype).view(shape)


def _geometry(name: str, p: dict, ins: dict, alloc: SentinelAlloc, sms: int) -> dict:
    """The geometry the ``_*_cuda`` function planned this call with."""
    if name.startswith("flash"):
        return {k: p[k] for k in ("B", "Lq", "Lk", "Hq", "Hkv", "D", "causal")} | {"sms": sms}
    ptr = ins["u"].data_ptr()
    if name == "cosine_sim":
        ptr |= ins["w"].data_ptr()
    if name in RANK:
        ptr |= alloc.allocations[0][1].data_ptr()
    return dict(K=p["K"], D=p["D"], ptr=ptr, plan_rows=p.get("plan_rows"), sms=sms)


def _declared(name: str, q: dict, kernels: dict | None = None) -> dict:
    """buffer -> bool array of the elements the declarations (``kernels``,
    the registered ones by default) say one call writes (its launches'
    blocks and last blocks)."""
    from repro_torch.kernels import meta

    kernels = meta.KERNEL_GEOMETRY if kernels is None else kernels
    w = meta.WRAPPER_GEOMETRY[name]
    masks = {buf: np.zeros(n + 1, np.int64) for buf, (n, _) in w.buffers(q).items()}
    for la in w.launches(q):
        k = kernels[la.kernel]
        grid = k.grid(la.params)
        stores = dict(k.writes(la.params, grid))
        for buf, iv in (k.last_writes(la.params) if k.last_writes else {}).items():
            stores[buf] = meta.Intervals.cat([stores[buf], iv]) if buf in stores else iv
        for buf, iv in stores.items():
            np.add.at(masks[buf], iv.starts, 1)
            np.add.at(masks[buf], iv.ends, -1)
    return {buf: np.cumsum(m)[:-1] > 0 for buf, m in masks.items()}


def _element_bytes(buf: str, p: dict) -> int:
    return 1 if buf == "good" else 2 if p.get("dtype") in ("bfloat16", "float16") else 4


def _compare(name: str, p: dict, q: dict, alloc: SentinelAlloc, kernels) -> list:
    """Findings of one call: the elements each allocation's buffers changed
    against the declared map, and the guard bytes past each."""
    from repro_torch.kernels import meta

    sizes = {buf: n for buf, (n, _) in meta.WRAPPER_GEOMETRY[name].buffers(q).items()}
    want = _declared(name, q, kernels)
    findings = []
    if len(alloc.allocations) != len(LAYOUT[name]):
        return [f"{len(alloc.allocations)} allocation(s), LAYOUT has {len(LAYOUT[name])}"]
    for (nbytes, raw, fill), bufs in zip(alloc.allocations, LAYOUT[name]):
        changed = (raw != fill).cpu().numpy()
        off = 0
        for buf in bufs:
            es = _element_bytes(buf, p)
            wrote = changed[off:off + sizes[buf] * es].reshape(-1, es).any(axis=1)
            off += sizes[buf] * es
            missed = np.flatnonzero(want[buf] & ~wrote)
            stray = np.flatnonzero(wrote & ~want[buf])
            if missed.size:
                findings.append(f"{buf}: {missed.size} declared element(s) never written, "
                                f"first {int(missed[0])}")
            if stray.size:
                findings.append(f"{buf}: {stray.size} element(s) written outside the declared "
                                f"map, first {int(stray[0])}")
        if off != nbytes:
            findings.append(f"{'+'.join(bufs)}: {nbytes} bytes allocated, {off} declared")
        if changed[nbytes:].any():
            findings.append(f"{'+'.join(bufs)}: {int(changed[nbytes:].sum())} guard byte(s) "
                            "past the allocation written")
    return findings


def sentinel_checks(torch, cases, *, seed: int = 0, kernels: dict | None = None,
                    device="cuda", lib=None) -> list:
    """Each case on sentinel-filled buffers: the rows are ``(wrapper, params,
    findings)``, findings empty where the kernels wrote exactly the elements
    the declarations (``kernels``, the registered ones by default) say.
    ``lib`` is the built kernel library unless given (a stand-in on the
    CPU)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import load_library

    device = torch.device(device)
    lib = load_library() if lib is None else lib
    sms = ops._sm_count(device.index)
    stream = torch.cuda.current_stream().cuda_stream if device.type == "cuda" else 0
    rows = []
    for i, (name, p) in enumerate(cases):
        ins = _inputs(torch, name, p, seed + i, device)
        alloc = SentinelAlloc(torch)
        try:
            _call(name, p, ins, lib, stream, alloc)
        except RuntimeError as e:          # a C entry's cudaError
            rows.append((name, dict(p), [str(e)]))
            continue
        if device.type == "cuda":
            torch.cuda.synchronize()
        rows.append((name, dict(p), _compare(name, p, _geometry(name, p, ins, alloc, sms),
                                             alloc, kernels)))
    return rows


def _summary(text: str) -> dict:
    """Hazards and errors the sanitizer's summary line reports (-1 where it
    printed none)."""
    m = re.search(r"RACECHECK SUMMARY: (\d+) hazards? displayed \((\d+) errors?", text)
    if m:
        return {"hazards": int(m.group(1)), "errors": int(m.group(2))}
    m = re.search(r"ERROR SUMMARY: (\d+) errors?", text)
    return {"hazards": 0, "errors": int(m.group(1)) if m else -1}


_PROBE = ("import ctypes, glob, sys; "
          "lib = ctypes.CDLL(sorted(glob.glob(sys.argv[1] + '/libcudart.so*'))[0]); "
          "sys.exit(lib.cudaFree(None))")


def run_sanitizer(cases, *, budget_s: float, workdir: str) -> dict:
    """``compute-sanitizer --tool T`` over the cases in a child process, for
    each of ``TOOLS`` and then each of ``OPTIONAL_TOOLS`` while the seconds
    spent stay under ``budget_s``.  Returns ``{"refused": message or None,
    "version": ..., "tools": {tool: {"hazards", "errors", "rc", "s",
    "tail"}}, "not_run": [tool, ...]}``.  Raises where the sanitizer is
    missing."""
    exe = SANITIZER if os.path.exists(SANITIZER) else shutil.which("compute-sanitizer")
    if exe is None:
        raise RuntimeError(f"compute-sanitizer not found (looked for {SANITIZER} and on PATH)")
    version = subprocess.run([exe, "--version"], capture_output=True, text=True, timeout=60)
    out = {"executable": exe, "version": (version.stdout.strip().splitlines() or [""])[-1],
           "refused": None, "tools": {}}
    t0 = time.perf_counter()
    # a CUDA context from the runtime alone, without torch: a device the
    # sanitizer refuses shows in a second or two
    probe = subprocess.run(
        [exe, "--tool", "memcheck", sys.executable, "-c", _PROBE,
         os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(exe))), "lib64")],
        capture_output=True, text=True, timeout=120)
    refusal = [ln.strip("= ").strip() for ln in (probe.stdout + probe.stderr).splitlines()
               if "device not supported" in ln.lower()]
    if refusal:
        out["refused"] = refusal[0]
    else:
        path = os.path.join(workdir, "sanitize_cases.json")
        with open(path, "w") as f:
            json.dump(cases, f)
        env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        for tool in TOOLS + OPTIONAL_TOOLS:
            if tool in OPTIONAL_TOOLS and time.perf_counter() - t0 > budget_s:
                break
            t1 = time.perf_counter()
            proc = subprocess.run(
                [exe, "--tool", tool, "--error-exitcode", "9", "--print-limit", "20",
                 "--kernel-name", f"regex={KERNEL_REGEX}", sys.executable, "-m",
                 "repro_torch.analysis.sanitize", path],
                capture_output=True, text=True, env=env, timeout=300)
            text = proc.stdout + proc.stderr
            out["tools"][tool] = {**_summary(text), "rc": proc.returncode,
                                  "s": time.perf_counter() - t1, "tail": text[-2000:]}
    out["not_run"] = [t for t in TOOLS + OPTIONAL_TOOLS if t not in out["tools"]]
    return out


def main(argv=None) -> int:
    """The sanitizer's child: every case once, on ``torch.empty``'s
    unwritten memory (``PYTORCH_NO_CUDA_MEMORY_CACHING``)."""
    import torch

    from repro_torch.kernels.build import load_library

    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        cases = json.load(f)
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    for i, (name, p) in enumerate(cases):
        _call(name, p, _inputs(torch, name, p, i, "cuda"), lib, stream, torch.empty)
    torch.cuda.synchronize()
    print(f"sanitize: {len(cases)} case(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
