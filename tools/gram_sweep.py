#!/usr/bin/env python3
"""A one-off diagnostic of the Gram kernel on one NVIDIA GPU; nothing in
the package or in ``chip_smoke.py`` depends on it, and it may be deleted
once its readings are recorded.

    python3 tools/gram_sweep.py

Builds the kernels of ``src/repro_torch/kernels/csrc`` and, at (K, D) =
(10, 535,818), (200, 535,818) and (6, 460,800):

1. checks ``ops.gram`` against ``U @ U.T`` in f32 and ``ref.gram_3xtf32_ref``
   (largest error per part, diagonal and off-diagonal apart);
2. times cuBLAS's ``U @ U.T`` (TF32 off) and ``repro_gram`` at the split
   counts that ``ops.gram_geometry`` gives for cards of other SM counts
   (other CTA targets), and with 4-byte copies;
3. times four faulty variants of ``gram_tf32x3_kernel``, each built from a
   patched copy of the source under ``build/gram_sweep/`` (a throwaway
   build beside the package's): no copies into shared memory ("no loads"),
   no products ("loads only"), only the hi hi' products ("1xTF32
   products"), and the lo hi' product dropped ("one lo-term dropped").  Each
   variant's error against ``ref.gram_3xtf32_ref`` is printed beside its
   time: the first two show what bounds the kernel, the last two what a
   fault in the tensor-core arithmetic reads against that twin
   (``chip_smoke.TC_RTOL`` sits between them and the kernel's own reading).

Times are medians of 15 launches, each after an L2 flush.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((10, 535_818), (200, 535_818), (6, 460_800))
TARGETS = {10: (528, 1056, 2112), 200: (1056, 2112, 3168), 6: (528, 1056, 2112)}  # CTAs
N_TIMED = 15
# variant -> the source edits that take its part out (each must match once)
_LOAD = ("if (s < nstage) loader.load(s * stage_floats",
         "if (GRAM_SWEEP && s < nstage) loader.load(s * stage_floats")
_LOAD2 = ("      if (s < nstage)\n        loader.load((s % S)",
          "      if (GRAM_SWEEP && s < nstage)\n        loader.load((s % S)")
_SMALL = [(f"for (int n = 0; n < NT; ++n) mma1688(part[m][n], {a}",
           f"for (int n = 0; n < NT; ++n) if (GRAM_SWEEP) mma1688(part[m][n], {a}")
          for a in ("al[j][m], bh", "ah[j][m], bl")]
_BIG = [("for (int n = 0; n < NT; ++n) mma1688(part[m][n], ah[j][m], bh",
         "for (int n = 0; n < NT; ++n) if (GRAM_SWEEP) mma1688(part[m][n], ah[j][m], bh")]
VARIANTS = {"no loads": [_LOAD, _LOAD2], "loads only": _SMALL + _BIG, "1xTF32 products": _SMALL,
            "one lo-term dropped": _SMALL[:1]}


def median_ms(torch, fn, flush):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        flush.sum()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[N_TIMED // 2]


def build_variants(build):
    """One library per variant, each exporting repro_gram (bound alone)."""
    out = ROOT / "build" / "gram_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "afa_kernels.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"gram_sweep: variant {name!r} no longer matches the source")
            text = text.replace(old, new)
        path = out / f"variant{i}.cu"
        path.write_text("#define GRAM_SWEEP 0\n" + text)
        procs[name] = (out / f"libvariant{i}.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / f"libvariant{i}.so"),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"gram_sweep: variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        lib.repro_gram.argtypes = list(build.SIGNATURES["repro_gram"])
        lib.repro_gram.restype = ctypes.c_int
        libs[name] = lib
    return libs


def parts(torch, g, r):
    off = ~torch.eye(g.shape[0], dtype=torch.bool, device=g.device)
    return {label: (float((a - b).abs().max()), float(b.abs().max()))
            for label, a, b in (("diagonal", g.diagonal(), r.diagonal()),
                                ("off-diagonal", g[off], r[off]))}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("gram_sweep: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _, log = build.build_library()
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "gram" in line:
            name = line.split("'")[1].split("_cu_")[-1].lstrip("0123456789")[:48]
            regs = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            print(f"  {name}: " + "; ".join(regs))
    lib = build.load_library()
    variants = build_variants(build)
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for K, D in SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(K)
        U = torch.randn((K, D), generator=gen, device=dev)
        g = ops.gram(U)
        r3 = ref.gram_3xtf32_ref(U)
        for twin, r in (("U @ U.T", U @ U.T), ("3xtf32 twin", r3)):
            for label, (e, scale) in parts(torch, g, r).items():
                print(f"K={K} D={D} vs {twin:11s} {label:12s}: max_abs_err={e:.3e} "
                      f"({e / scale:.2e} of {scale:.4e})")
        print(f"K={K} D={D} cuBLAS U @ U.T: {median_ms(torch, lambda: U @ U.T, flush):.4f} ms")
        base = ops.gram_geometry(K, D, U.data_ptr(), sms)
        runs = [(f"target={t}", ops.gram_geometry(K, D, U.data_ptr(),
                                                  t // ops.GRAM_CTAS_PER_SM), lib)
                for t in TARGETS[K]]
        runs.append(("4-byte copies", base._replace(width=4), lib))
        runs += [(name, base, vlib) for name, vlib in variants.items()]
        for label, geo, which in runs:
            pg = torch.empty((geo.nsplit * geo.entries,), device=dev)
            out = torch.empty((K, K), device=dev)

            def call(geo=geo, which=which, pg=pg, out=out):
                rc = which.repro_gram(U.data_ptr(), pg.data_ptr(), out.data_ptr(), K, D,
                                      geo.tile_rows, geo.nsplit, geo.chunk, geo.width, stream)
                if rc:
                    raise RuntimeError(f"repro_gram: cudaError {rc}")

            ms = median_ms(torch, call, flush)
            mark = " (the package's)" if (geo == base and which is lib) else ""
            errs = ", ".join(f"{label2} {e / scale:.2e} of scale"
                             for label2, (e, scale) in parts(torch, out, r3).items())
            print(f"K={K} D={D} {label:19s} ctas={geo.npairs * geo.nsplit:5d} "
                  f"nsplit={geo.nsplit:5d} chunk={geo.chunk:6d} width={geo.width:2d}: "
                  f"{ms:.4f} ms{mark}; vs 3xtf32 twin: {errs}")


if __name__ == "__main__":
    main()
