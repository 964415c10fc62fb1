#!/usr/bin/env python3
"""A one-off diagnostic of the rank kernels behind ``coord_median`` (with and
without a mask) and ``trimmed_mean`` on one NVIDIA GPU.  Nothing in the
package or in ``chip_smoke.py`` depends on it, and it may be deleted once
its readings are recorded.

    python3 tools/rank_sweep.py [--before PATH/rank_kernels.cu]

Builds the kernels of ``src/repro_torch/kernels/csrc`` and prints the
registers and spills of the kernels of ``rank_kernels.cu``; then at (K, D) =
(6, 460,800), (10, 535,818) and (200, 535,818), on ``chip_smoke.py``'s
inputs (a mask with ``dead`` dead rows; the masked median on values
rounded to quarters, so most columns hold ties):

1. holds each call's output against its twins in ``kernels/ref.py``: the
   medians equal ``coord_median_ref``, the trimmed mean equals
   ``trimmed_mean_rowsum_ref`` and lies within ``chip_smoke.RTOL`` of
   ``trimmed_mean_ref``; every output compared bit for bit;
2. times each call with ``chip_smoke.time_ms`` (medians of 20 turns, each
   after an L2 flush and a device spin);
3. traces one call of each with ``torch.profiler`` and prints every device
   operation inside it (kernels, copies, fills) with its duration.

With ``--before``, another copy of ``rank_kernels.cu`` whose C entries take
the earlier interface (an int32 mask, no plan) is built under
``build/rank_sweep/`` and called as its wrapper called it (the mask copied
to int32 on every masked call); its outputs are compared with the
package's bit for bit, and it is timed in the same turns (parent, package,
package, parent) and traced the same way.

Beside the package's own calls it times variants, each held to the
package's outputs bit for bit unless its change breaks the result: the
register path on other plans (``GRIDS``: blocks an SM and load widths,
through the plan the C entry takes), and patched copies of
``rank_kernels.cu`` built under ``build/rank_sweep/`` (``PATCHES``,
throwaway builds beside the package's: the compares replaced by a sum of
the live values; synthetic values in place of the loads; the ranks made
but nothing selected; every rank by the radix select; six blocks an SM).
Everything goes to ``chiprun_out/rank_sweep.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (K, D, dead rows, trim): chip_smoke.py's kernel phase at K = 10 and 200,
# and the LoRA phase's K = 6 with a trim that keeps one value
SHAPES = ((6, 460_800, 1, 2), (10, 535_818, 3, 3), (200, 535_818, 3, 3))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the earlier interface, as --before's source declares it
BEFORE_SIGNATURES = {
    "repro_rank_max_k": (),
    "repro_coord_median": (_P, _P, _P, _I, _L, _P),
    "repro_trimmed_mean": (_P, _P, _P, _I, _L, _I, _P),
}


# patched copies of rank_kernels.cu: name -> (source edits (old, new), held to the package)
PATCHES = {
    "stream only": ([("    for (int v = 0; v < V; ++v) y[v] = rank_column<KB, V, kTrim>"
                      "(x, v, m, trim, base);",
                      "    for (int v = 0; v < V; ++v) {\n      float s = 0.f;\n"
                      "      for (int r = 0; r < KB; ++r)\n        if (r < m) s += x[r][v];\n"
                      "      y[v] = s;\n    }")], False),
    "compares only": ([("    load_live<KB, W>(u + g * V, D, live, m, x);",
                        "    for (int r = 0; r < KB; ++r)\n      for (int v = 0; v < V; ++v)"
                        " x[r][v] = __int_as_float((int)g + 7 * r + v);")], False),
    "no selection": ([("  if (kTrim) {  // kept:",
                       "  return __uint_as_float(w[0] + w[R::kWords - 1]);\n"
                       "  if (kTrim) {  // kept:")], False),
    "radix only": ([("constexpr unsigned kExtractMax = 16;",
                     "constexpr unsigned kExtractMax = 0;")], True),
    "6 blocks/SM": ([("return KB * (V + 1) <= 48 ? 4 : 2;", "return KB * (V + 1) <= 48 ? 6 : 2;")],
                    True),
}
# the register path on other plans: label -> (library: None for the package's
# or a PATCHES name, blocks an SM (None: the plan's), pointer bits OR-ed in to
# narrow the load width)
GRIDS = {"2 blocks/SM": (None, 2, 0), "8 blocks/SM": (None, 8, 0), "width 4": (None, None, 4),
         "width 8": (None, None, 8), "width 4, 8 blocks/SM": (None, 8, 4),
         "6 blocks/SM": ("6 blocks/SM", 6, 0)}


def ptxas_lines(log: str):
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "rank" in line:
            name = line.split("'")[1].split("_cu_")[-1].lstrip("0123456789")[:70]
            regs = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            yield f"  {name}: " + "; ".join(regs)


def build_before(build, path):
    out = ROOT / "build" / "rank_sweep"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libbefore.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"rank_sweep: {path} failed to build:\n{proc.stdout}{proc.stderr}")
    print(f"before ({path}):")
    for line in ptxas_lines(proc.stdout + proc.stderr):
        print(line)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in BEFORE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_patched(build):
    """One library per PATCHES entry, built in parallel; name -> (bound
    library, ptxas lines)."""
    out = ROOT / "build" / "rank_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "rank_kernels.cu").read_text()
    procs = {}
    for i, (name, (edits, _)) in enumerate(PATCHES.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"rank_sweep: variant {name!r} no longer matches the source")
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
            raise RuntimeError(f"rank_sweep: variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        for entry in ("repro_rank_max_k", "repro_coord_median", "repro_trimmed_mean"):
            getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        print(f"variant {name!r}:")
        for line in ptxas_lines(log):
            print(line)
        libs[name] = lib
    return libs


def on_grid(torch, ops, lib, per_sm, ptr_bits, op, U, mask, trim):
    """A call through ``ops._rank_cuda`` with ``lib`` and the plan of
    ``ops.rank_geometry`` at ``per_sm`` register-path blocks an SM (None: the
    plan's) and loads no wider than ``ptr_bits`` OR-ed into the pointers allow."""
    def call():
        saved = ops._rank_ctas_per_sm, ops.rank_geometry
        if per_sm is not None:
            ops._rank_ctas_per_sm = lambda bucket, v: per_sm
        ops.rank_geometry = lambda K, D, ptr, sms: saved[1](K, D, ptr | ptr_bits, sms)
        try:
            return ops._rank_cuda(op, lib, torch.cuda.current_stream().cuda_stream, U, mask,
                                  trim=trim)
        finally:
            ops._rank_ctas_per_sm, ops.rank_geometry = saved

    return call


def before_calls(torch, lib):
    """The earlier entries, called as their wrapper called them."""
    def launch(U, mask, trim=None):
        K, D = U.shape
        out = torch.empty((D,), dtype=torch.float32, device=U.device)
        m32 = None if mask is None else mask.to(torch.int32).contiguous()
        mptr = None if m32 is None else m32.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        if trim is None:
            rc = lib.repro_coord_median(U.data_ptr(), mptr, out.data_ptr(), K, D, stream)
        else:
            rc = lib.repro_trimmed_mean(U.data_ptr(), mptr, out.data_ptr(), K, D, trim, stream)
        if rc:
            raise RuntimeError(f"rank_sweep: before: cudaError {rc}")
        return out

    return launch


def trace_call(torch, fn, flush, spin_cycles):
    """The device operations of one call of ``fn``: [(name, start us,
    duration us)] in start order, after a warm call, an L2 flush and a device
    spin (dropped from the list), as ``chip_smoke.time_ms`` times it."""
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
    rows = [{"name": name[:80], "start_us": start - t0, "us": dur}
            for name, start, dur in ops_list]
    busy = sum(d for _, _, d in ops_list)
    print(f"  trace {label}: {len(ops_list)} device op(s), busy {busy:.2f} us")
    for r in rows:
        print(f"    {r['us']:9.2f} us  {r['name']}")
    return {"label": label, "ops": rows, "busy_us": busy}


def bits(torch, t):
    return t.contiguous().view(torch.int32)


def main() -> None:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--before", help="another rank_kernels.cu (the earlier interface)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rank_sweep: no CUDA device")
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
    for line in ptxas_lines(log):
        print(line)
    before = before_calls(torch, build_before(build, args.before)) if args.before else None
    patched = build_patched(build)
    lib = build.load_library()

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
    for K, D, dead, trim in SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + K)
        U = torch.randn((K, D), generator=gen, device=dev)
        live = torch.ones((K,), dtype=torch.bool, device=dev)
        live[torch.randperm(K, generator=gen, device=dev)[:dead]] = False
        Uq = torch.round(4.0 * U) / 4.0
        calls = {
            "coord_median": (lambda: ops.coord_median(U),
                             (lambda: before(U, None)) if before else None,
                             [("coord_median_ref", ref.coord_median_ref(U), 0.0)]),
            "coord_median_masked": (lambda: ops.coord_median(Uq, live),
                                    (lambda: before(Uq, live)) if before else None,
                                    [("coord_median_ref", ref.coord_median_ref(Uq, live), 0.0)]),
            "trimmed_mean": (lambda: ops.trimmed_mean(U, live, trim=trim),
                             (lambda: before(U, live, trim)) if before else None,
                             [("trimmed_mean_rowsum_ref",
                               ref.trimmed_mean_rowsum_ref(U, live, trim=trim), 0.0),
                              ("trimmed_mean_ref", ref.trimmed_mean_ref(U, live, trim=trim),
                               chip_smoke.RTOL)]),
        }
        inputs = {"coord_median": (U, None, None), "coord_median_masked": (Uq, live, None),
                  "trimmed_mean": (U, live, trim)}
        for name, (pkg, bef, twins) in calls.items():
            op = "trimmed_mean" if name == "trimmed_mean" else "coord_median"
            variants, unchecked = {}, set()
            for label, (edits, check) in PATCHES.items():
                variants[label] = on_grid(torch, ops, patched[label], None, 0, op, *inputs[name])
                if not check:
                    unchecked.add(label)
            if K <= ops.RANK_REG_MAX_K:
                for label, (vlib, per_sm, ptr_bits) in GRIDS.items():
                    variants[label] = on_grid(torch, ops, patched[vlib] if vlib else lib, per_sm,
                                              ptr_bits, op, *inputs[name])
            got = pkg()
            checks = {}
            for tname, want, rtol in twins:
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                same = bool(torch.equal(bits(torch, got), bits(torch, want)))
                checks[tname] = {"max_abs_err": err, "tol": rtol * scale, "bit_identical": same}
                if (rtol == 0 and not same) or err > rtol * scale:
                    raise AssertionError(f"{name} K={K}: {tname} max |diff| {err} "
                                         f"(tol {rtol * scale}, bit-identical {same})")
            if not torch.equal(bits(torch, got), bits(torch, pkg())):
                raise AssertionError(f"{name} K={K}: two launches are not bit-identical")
            same_before = None
            fns = {"package": pkg}
            if bef is not None:
                same_before = bool(torch.equal(bits(torch, got), bits(torch, bef())))
                if not same_before:
                    raise AssertionError(f"{name} K={K}: package and before differ")
                fns = {"before": bef, "package": pkg}
            for label, fn in variants.items():
                if label not in unchecked and not torch.equal(bits(torch, got), bits(torch, fn())):
                    raise AssertionError(f"{name} K={K}: variant {label!r} differs from the "
                                         "package")
            fns = {**fns, **variants, "package ": pkg}
            if bef is not None:
                fns["before "] = bef
            times = chip_smoke.time_ms(torch, fns, flush)
            print(f"{name} K={K} D={D} m={K - dead}" + (f" trim={trim}" if "trim" in name else "")
                  + ": " + "; ".join(f"{k.strip()} {v:.4f} ms" for k, v in times.items())
                  + "; " + ", ".join(f"{t}: {'bits' if c['bit_identical'] else 'within'}"
                                     for t, c in checks.items())
                  + (f"; bit-identical to before: {same_before}" if bef else ""))
            traces = [print_trace(f"{name} K={K} {label}",
                                  trace_call(torch, fn, flush, chip_smoke.SPIN_CYCLES))
                      for label, fn in (("package", pkg), ("before", bef)) if fn is not None]
            report["rows"].append({"kernel": name, "K": K, "D": D, "live": K - dead,
                                   "trim": trim if "trim" in name else None, "ms": times,
                                   "checks": checks, "bit_identical_to_before": same_before,
                                   "traces": traces})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rank_sweep.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
