#!/usr/bin/env python3
"""A one-off diagnostic of the three kernels that stream the (K, D) update
matrix for AFA on one NVIDIA GPU: ``cosine_sim``, ``afa_screen`` and
``weighted_sum``.  Nothing in the package or in ``chip_smoke.py`` depends on
it, and it may be deleted once its readings are recorded.

    python3 tools/afa_sweep.py [--before PATH/afa_kernels.cu]

Builds the kernels of ``src/repro_torch/kernels/csrc``, prints the
registers and spills of the kernels of ``afa_kernels.cu``, then at (K, D) =
(6, 460,800), (10, 535,818) and (200, 535,818), on ``chip_smoke.py``'s
inputs:

1. holds each kernel's outputs against its twin in ``kernels/ref.py``
   (``chip_smoke.RTOL`` per output; ``good`` and ``rounds`` equal);
2. times each call with ``chip_smoke.time_ms`` (medians of 20 turns, each
   after an L2 flush and a device spin);
3. traces one call of each with ``torch.profiler`` and prints every device
   operation inside it (kernels, copies, fills), with its duration, and the
   gaps between them.

With ``--before``, another copy of ``afa_kernels.cu`` (an earlier kernel
whose C entries take the earlier interface: ``repro_cosine_nsplit`` and
three partial buffers for the cosine, an int32 mask and separate int32
outputs for the screen) is built under ``build/afa_sweep/`` and its entries,
called as its wrappers called them, are checked, timed in the same turns and
traced the same way.  Everything goes to ``chiprun_out/afa_sweep.json``.

Beside the package's own calls it times variants, held to the twin unless
their change breaks the result: the cosine at other grid sizes and load
widths (through the geometry that the C entry takes); ``afa_screen`` at
``max_rounds`` 0, 1 and 2 (the cost of a screening pass); and patched copies
of ``afa_kernels.cu`` built under ``build/afa_sweep/`` (throwaway builds
beside the package's): the cosine without its second stage, or in 256-thread
blocks four an SM; the screen's kernel stopped after the Gram reduce, or
after the reduce and the ticket; the weighted sum with other row batches, one
group per thread, or 4-byte loads; and one with SM-clock stamps (clock64) of
the screen's last block, printed per pass.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((6, 460_800), (10, 535_818), (200, 535_818))
KW = dict(xi0=2.0, delta_xi=0.5, max_rounds=8, ddof=0)
SCREEN_MAX_ROUNDS = (0, 1, 2)  # the screen's cost per pass, beside KW's 8
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the earlier interface of the three entries, as --before's source declares it
BEFORE_SIGNATURES = {
    "repro_cosine_nsplit": (_L,),
    "repro_weighted_sum": (_P, _P, _P, _I, _L, _P),
    "repro_cosine_sim": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _P),
    "repro_afa_screen": (_P,) * 12 + (_I, _L, _I, _I, _L, _I, _F, _F, _I, _I, _P),
}


def ptxas_lines(log: str, keys):
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line for k in keys):
            name = line.split("'")[1].split("_cu_")[-1].lstrip("0123456789")[:60]
            regs = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            yield f"  {name}: " + "; ".join(regs)


def build_before(build, path):
    out = ROOT / "build" / "afa_sweep"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libbefore.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"afa_sweep: {path} failed to build:\n{proc.stdout}{proc.stderr}")
    print(f"before ({path}):")
    for line in ptxas_lines(proc.stdout + proc.stderr, KERNEL_KEYS):
        print(line)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in BEFORE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


KERNEL_KEYS = ("weighted_sum", "cosine", "reduce", "screen")
# patched variants: name -> (kernel, source edits (old, new), held to the twin)
PATCHES = {
    "no second stage": ("cosine_sim", [("  if (!lb.draw()) return;\n  // the last block: warp w",
                                        "  return;\n  // the last block: warp w")], False),
    "256 threads, 4 blocks/SM": ("cosine_sim", [
        ("constexpr int kCosineThreads = 512;\nconstexpr int kCosineBlocksPerSM = 2;",
         "constexpr int kCosineThreads = 256;\nconstexpr int kCosineBlocksPerSM = 4;")], True),
    "reduce only": ("afa_screen", [("  if (!lb.draw()) return;\n  extern __shared__ float smem[];",
                                    "  return;\n  extern __shared__ float smem[];")], False),
    "reduce and ticket": ("afa_screen", [
        ("  if (!lb.draw()) return;\n  extern __shared__ float smem[];",
         "  if (!lb.draw()) return;\n  lb.release();\n  return;\n"
         "  extern __shared__ float smem[];")], False),
    "rows 16": ("weighted_sum", [("constexpr int kSumRows = 8;", "constexpr int kSumRows = 16;")],
                True),
    "rows 4": ("weighted_sum", [("constexpr int kSumRows = 8;", "constexpr int kSumRows = 4;")],
               True),
    "one pass": ("weighted_sum", [("*blocks = (unsigned)(all < cap ? all : cap);",
                                   "*blocks = (unsigned)all;")], True),
    "width 4": ("weighted_sum", [("for (int w = 16; w > 4; w /= 2)",
                                  "for (int w = 4; w > 4; w /= 2)")], True),
}
# the screen with SM-clock stamps (clock64) of its last block: after the
# ticket, after its set-up, after each step of each pass, at the end
STAMPED = [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n__device__ long long g_stamp[64];\n"
     "#define STAMP(i) do { if (threadIdx.x == 0) g_stamp[i] = clock64(); } while (0)\n"),
    ("  gram_reduce_body(pg, pun, G, rn, K, nsplit);\n  if (!lb.draw()) return;\n",
     "  gram_reduce_body(pg, pun, G, rn, K, nsplit);\n  if (!lb.draw()) return;\n  STAMP(0);\n"),
    ("  __syncthreads();\n\n  if (max_rounds == 0) {",
     "  __syncthreads();\n  STAMP(1);\n  if (max_rounds == 0) {"),
    ("    screen_weights(sh, K, &scalar[0]);\n    screen_sims(sh, K, &scalar[1]);\n"
     "    screen_mark_bad(sh, K, xi, ddof, stats, flags);\n",
     "    screen_weights(sh, K, &scalar[0]);\n    STAMP(2 + 3 * rounds);\n"
     "    screen_sims(sh, K, &scalar[1]);\n    STAMP(3 + 3 * rounds);\n"
     "    screen_mark_bad(sh, K, xi, ddof, stats, flags);\n    STAMP(4 + 3 * rounds);\n"),
    ("  if (threadIdx.x == 0) rounds_out[0] = rounds;\n}",
     "  STAMP(40);\n  if (threadIdx.x == 0) rounds_out[0] = rounds;\n}"),
    ("                  max_rounds, ddof);\n  } else {",
     "                  max_rounds, ddof);\n    STAMP(40);\n  } else {"),
    ('extern "C" {\n',
     'extern "C" {\nint repro_stamps(long long* out) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n}\n'),
]


def build_stamped(build):
    out = ROOT / "build" / "afa_sweep"
    out.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "afa_kernels.cu").read_text()
    for old, new in STAMPED:
        if text.count(old) != 1:
            raise RuntimeError(f"afa_sweep: stamp edit no longer matches: {old[:40]!r}")
        text = text.replace(old, new)
    (out / "stamped.cu").write_text(text)
    lib_path = out / "libstamped.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                           str(out / "stamped.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"afa_sweep: stamped build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for entry in ("repro_afa_screen", "repro_screen_max_k"):
        getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
        getattr(lib, entry).restype = ctypes.c_int
    lib.repro_stamps.argtypes = [ctypes.c_void_p]
    lib.repro_stamps.restype = ctypes.c_int
    return lib


def print_stamps(torch, ops, lib, Us, pn, mask0, K):
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        agg, good, rounds, sims = ops._afa_screen_cuda(lib, stream, Us, pn, mask0, **KW)
    torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * 64)()
    if lib.repro_stamps(ctypes.addressof(stamps)):
        raise RuntimeError("afa_sweep: reading the stamps failed")
    n = int(rounds)
    if K <= 32:  # the one-warp screen: its total only
        print(f"afa_screen K={K} last-block SM cycles (one warp, {n} passes): "
              f"{stamps[40] - stamps[0]}")
        return
    marks = {"set-up": 1}
    for r in range(n):
        marks.update({f"pass {r + 1} weights": 2 + 3 * r, f"pass {r + 1} sims": 3 + 3 * r,
                      f"pass {r + 1} mark": 4 + 3 * r})
    marks["final weights"] = 40
    prev = stamps[0]
    parts = []
    for label, i in marks.items():
        parts.append(f"{label} {stamps[i] - prev}")
        prev = stamps[i]
    print(f"afa_screen K={K} last-block SM cycles: " + ", ".join(parts)
          + f"; total {stamps[40] - stamps[0]}")


# geometry variants of the package's cosine: name -> (blocks per SM, pointer bits OR-ed in
# to narrow the load width)
COSINE_GEOMETRIES = {"1 block/SM": (1, 0), "width 4": (2, 4)}


def build_patched(build):
    """One library per PATCHES entry, built in parallel; name -> bound library."""
    out = ROOT / "build" / "afa_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "afa_kernels.cu").read_text()
    procs = {}
    for i, (name, (_, edits, _)) in enumerate(PATCHES.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"afa_sweep: variant {name!r} no longer matches the source")
            text = text.replace(old, new)
        path = out / f"variant{i}.cu"
        path.write_text(text)
        lib_path = out / f"libvariant{i}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"afa_sweep: variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        for entry in ("repro_cosine_sim", "repro_weighted_sum", "repro_afa_screen",
                      "repro_screen_max_k"):
            getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def before_calls(torch, ops, lib):
    """The earlier entries, called as their wrappers called them (the
    scratch, the mask's copy to int32 and ``good != 0`` included)."""
    def rc(name, code):
        if code:
            raise RuntimeError(f"afa_sweep: before {name}: cudaError {code}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def weighted_sum(c, U):
        K, D = U.shape
        out = torch.empty((D,), dtype=torch.float32, device=U.device)
        rc("weighted_sum", lib.repro_weighted_sum(c.data_ptr(), U.data_ptr(), out.data_ptr(),
                                                  K, D, stream()))
        return out

    def cosine_sim(U, w):
        K, D = U.shape
        n = lib.repro_cosine_nsplit(D)
        buf = torch.empty((2 * K * n + n + K,), dtype=torch.float32, device=U.device)
        pdot, pun, pwn, sims = torch.split(buf, (K * n, K * n, n, K))
        rc("cosine_sim", lib.repro_cosine_sim(U.data_ptr(), w.data_ptr(), pdot.data_ptr(),
                                              pun.data_ptr(), pwn.data_ptr(), sims.data_ptr(),
                                              K, D, n, stream()))
        return sims

    def afa_screen(U, pn, mask0, *, xi0, delta_xi, max_rounds, ddof):
        K, D = U.shape
        geo = ops.gram_geometry(K, D, U.data_ptr(), ops._sm_count(U.device.index))
        sizes = (geo.nsplit * geo.entries, geo.nsplit * K, K * K, K, K, D, K)
        buf = torch.empty((sum(sizes),), dtype=torch.float32, device=U.device)
        pg, pun, G, rn, weights, agg, sims = torch.split(buf, sizes)
        ibuf = torch.empty((2 * K + 1,), dtype=torch.int32, device=U.device)
        m0, good, rounds = torch.split(ibuf, (K, K, 1))
        m0.copy_(mask0)
        rc("afa_screen", lib.repro_afa_screen(
            U.data_ptr(), pn.data_ptr(), m0.data_ptr(), pg.data_ptr(), pun.data_ptr(),
            G.data_ptr(), rn.data_ptr(), weights.data_ptr(), agg.data_ptr(), good.data_ptr(),
            rounds.data_ptr(), sims.data_ptr(), K, D, geo.tile_rows, geo.nsplit, geo.chunk,
            geo.width, xi0, delta_xi, max_rounds, ddof, stream()))
        return agg, good != 0, rounds[0], sims

    return {"weighted_sum": weighted_sum, "cosine_sim": cosine_sim, "afa_screen": afa_screen}


def cosine_at(torch, ops, lib, U, w, per_sm, ptr_bits):
    """A cosine entry (the package's or a patched one) with the geometry
    that ``ops.cosine_geometry`` plans for ``per_sm`` blocks on each
    multiprocessor and loads no wider than ``ptr_bits`` allow."""
    K, D = U.shape
    sms = ops._sm_count(U.device.index)
    geo = ops.cosine_geometry(K, D, U.data_ptr() | w.data_ptr() | ptr_bits,
                              max(1, sms * per_sm // ops.COSINE_CTAS_PER_SM))

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        npart = (2 * K + 1) * -(-geo.nsplit // 4) * 4
        buf = torch.empty((npart + K,), dtype=torch.float32, device=U.device)
        part, sims = torch.split(buf, (npart, K))
        rc = lib.repro_cosine_sim(U.data_ptr(), w.data_ptr(), part.data_ptr(), sims.data_ptr(),
                                  ops._ticket(U.device, stream).data_ptr(), K, D, geo.nsplit,
                                  geo.chunk, geo.width, stream)
        if rc:
            raise RuntimeError(f"afa_sweep: cosine variant: cudaError {rc}")
        return sims

    return call


def weighted_sum_with(torch, lib, c, U):
    def call():
        K, D = U.shape
        out = torch.empty((D,), dtype=torch.float32, device=U.device)
        rc = lib.repro_weighted_sum(c.data_ptr(), U.data_ptr(), out.data_ptr(), K, D,
                                    torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"afa_sweep: weighted-sum variant: cudaError {rc}")
        return out

    return call


def inputs(torch, K, D):
    """chip_smoke.py's kernel-phase inputs: U, w and c, and the screening
    matrix Us (a benign cluster, 30 % byzantine rows), pn and mask0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + K)
    U = torch.randn((K, D), generator=gen, device=dev)
    w = torch.randn((D,), generator=gen, device=dev)
    c = torch.rand((K,), generator=gen, device=dev)
    base = torch.randn((D,), generator=gen, device=dev)
    Us = base + 0.3 * torch.randn((K, D), generator=gen, device=dev)
    n_bad = (3 * K) // 10
    Us[:n_bad] = base + 20.0 * torch.randn((n_bad, D), generator=gen, device=dev)
    Us = Us.contiguous()
    pn = torch.rand((K,), generator=gen, device=dev) * 100 + 50
    mask0 = torch.ones((K,), dtype=torch.bool, device=dev)
    mask0[-1] = False
    return U, w, c, Us, pn, mask0


def trace_call(torch, fn, flush, spin_cycles):
    """The device operations of one call of ``fn``: [(name, start us,
    duration us)] in start order.  As ``chip_smoke.time_ms`` times it: after
    a warm call, an L2 flush and a device spin (dropped from the list) that
    keeps the card busy while the host enqueues the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    flush.sum()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(spin_cycles)
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
    return [(name, start, end - start) for start, end, name in spans]


def print_trace(label, ops_list):
    if not ops_list:
        print(f"  trace {label}: no device events recorded")
        return {"label": label, "ops": []}
    t0 = ops_list[0][1]
    end_prev = t0
    rows = []
    for name, start, dur in ops_list:
        gap = start - end_prev
        rows.append({"name": name[:80], "start_us": start - t0, "us": dur, "gap_before_us": gap})
        end_prev = max(end_prev, start + dur)
    span = end_prev - t0
    busy = sum(d for _, _, d in ops_list)
    print(f"  trace {label}: {len(ops_list)} device ops, span {span:.2f} us, busy {busy:.2f} us")
    for r in rows:
        print(f"    {r['us']:8.2f} us (gap before {r['gap_before_us']:6.2f})  {r['name']}")
    return {"label": label, "ops": rows, "span_us": span, "busy_us": busy}


def main() -> None:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--before", help="another afa_kernels.cu (the earlier interface)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("afa_sweep: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import build, ops, ref

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    _, log = build.build_library()
    print("package:")
    for line in ptxas_lines(log, KERNEL_KEYS):
        print(line)
    lib = build.load_library()
    patched = build_patched(build)
    stamped = build_stamped(build)
    before = before_calls(torch, ops, build_before(build, args.before)) if args.before else None

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    a = torch.randn((8192, 8192), device=dev)  # bring the clocks up
    for _ in range(20):
        a @ a
    torch.cuda.synchronize()
    del a
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones((1,), device=dev).sum()  # the first profiler run records no device events
        torch.cuda.synchronize()
    report = {"nvidia_smi": smi, "rows": []}
    for K, D in SHAPES:
        U, w, c, Us, pn, mask0 = inputs(torch, K, D)
        calls = {
            "weighted_sum": ({"package": lambda: ops.weighted_sum(c, U)},
                             lambda: ref.weighted_sum_ref(U, c),
                             lambda impl: lambda: impl(c, U)),
            "cosine_sim": ({"package": lambda: ops.cosine_sim(U, w)},
                           lambda: ref.cosine_sim_ref(U, w),
                           lambda impl: lambda: impl(U, w)),
            "afa_screen": ({"package": lambda: ops.afa_screen(Us, pn, mask0, **KW)},
                           lambda: ref.afa_screen_ref(Us, pn, mask0, **KW),
                           lambda impl: lambda: impl(Us, pn, mask0, **KW)),
        }
        for name, (fns, twin, bind_before) in calls.items():
            if before is not None:
                fns["before"] = bind_before(before[name])
            unchecked = set()
            if name == "cosine_sim":
                for label, (per_sm, bits) in COSINE_GEOMETRIES.items():
                    fns[label] = cosine_at(torch, ops, lib, U, w, per_sm, bits)
            for label, (kernel, _, check) in PATCHES.items():
                if kernel != name:
                    continue
                if name == "cosine_sim":
                    per_sm = 4 if "4 blocks" in label else 2
                    fns[label] = cosine_at(torch, ops, patched[label], U, w, per_sm, 0)
                elif name == "afa_screen":
                    fns[label] = (lambda vlib=patched[label]: ops._afa_screen_cuda(
                        vlib, torch.cuda.current_stream().cuda_stream, Us, pn, mask0, **KW))
                else:
                    fns[label] = weighted_sum_with(torch, patched[label], c, U)
                if not check:
                    unchecked.add(label)
            want = twin()
            want_t = want if isinstance(want, tuple) else (want,)
            errs, outs = {}, {}
            for label, fn in fns.items():
                got = fn()
                outs[label] = got_t = got if isinstance(got, tuple) else (got,)
                if label in unchecked:
                    continue
                checks = chip_smoke.hold_to_twin(torch, name, K, got_t, want_t, chip_smoke.RTOL,
                                                 "twin")
                errs[label] = max((ch["max_abs_err"] / max(ch["twin_max_abs"], 1e-30)
                                   for ch in checks), default=0.0)
            same = None
            if "before" in outs:
                same = all(torch.equal(a, b) for a, b in zip(outs["package"], outs["before"]))
                print(f"{name} K={K}: package and before bit-identical: {same}")
            # parent, change, (variants,) change, parent: the two twice a turn
            order = {"before": fns.get("before"), **fns, "package ": fns["package"],
                     "before ": fns.get("before")}
            times = chip_smoke.time_ms(torch, {k: f for k, f in order.items() if f}, flush)
            print(f"{name} K={K} D={D}: " + "; ".join(
                f"{label.strip()} {ms:.4f} ms" for label, ms in times.items())
                + "; error of scale " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            if name == "afa_screen":
                print(f"afa_screen K={K}: rounds={int(outs['package'][2])}")
                print_stamps(torch, ops, stamped, Us, pn, mask0, K)
                by_rounds = {}
                for m in SCREEN_MAX_ROUNDS:
                    kw = {**KW, "max_rounds": m}
                    by_rounds[f"package max_rounds={m}"] = (
                        lambda kw=kw: ops.afa_screen(Us, pn, mask0, **kw))
                    if before is not None:
                        by_rounds[f"before max_rounds={m}"] = (
                            lambda kw=kw: before["afa_screen"](Us, pn, mask0, **kw))
                rt = chip_smoke.time_ms(torch, by_rounds, flush)
                times.update(rt)
                print(f"afa_screen K={K}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in rt.items()))
            traces = [print_trace(f"{name} K={K} {label}",
                                  trace_call(torch, fn, flush, chip_smoke.SPIN_CYCLES))
                      for label, fn in fns.items() if label in ("package", "before")]
            report["rows"].append({"kernel": name, "K": K, "D": D, "ms": times, "rel_err": errs,
                                   "bit_identical_to_before": same, "traces": traces})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "afa_sweep.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
