#!/usr/bin/env python3
"""A one-off diagnostic of the f32 flash-attention kernel on one NVIDIA GPU;
nothing in the package or in ``chip_smoke.py`` depends on it, and it may be
deleted once its readings are recorded.

    python3 tools/attn_sweep.py [--before PATH/attn_kernels.cu]

Builds the kernels of ``src/repro_torch/kernels/csrc`` and prints the
registers and spills of ``flash_attn_tf32x3_kernel`` at each padded D, then:

1. runs ``chip_smoke.py``'s attention phase (both kernels against their
   twins at every checked shape, and their times at the smollm-135m shape);
2. at that shape (B = 4, L = 2048, Hq = 9, Hkv = 3, D = 64, causal, f32),
   times the f32 route of ``repro_flash_attn`` built from patched copies of
   ``attn_kernels.cu`` under ``build/attn_sweep/`` (a throwaway build
   beside the package's), each beside its error against
   ``ref.flash_attention_3xtf32_ref`` over max |v|: the lo-term products
   taken out ("1xTF32") or the lo hi' one ("one lo-term dropped"), which
   show what a fault in the arithmetic reads against the twin; no TF32
   splits (hi = x, lo = 0); three CTAs an SM in place of two; q read from
   shared memory for every key tile in place of registers.  With ``--before``, the f32
   route of another copy of the source (an earlier kernel) is timed in the
   same turns.

Times are ``chip_smoke.time_ms``'s: medians of 20 turns, each after an L2
flush.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 2048, 2048, 9, 3, 64)
_S = "#pragma unroll\n        for (int n = 0; n < NT; ++n) mma1688(part[n], {});\n"
_PV = "#pragma unroll\n      for (int d = 0; d < DT; ++d) mma1688(pv[d], {});\n"
_S_LO = [_S.format("al[0], kh[n][0], kh[n][1]"), _S.format("al[1], kh[n][2], kh[n][3]")]
_S_LO2 = [_S.format("ah[0], kl[n][0], kl[n][1]"), _S.format("ah[1], kl[n][2], kl[n][3]")]
_PV_LO = [_PV.format("pl, vh[d][0], vh[d][1]")]
_PV_LO2 = [_PV.format("ph, vl[d][0], vl[d][1]")]
# variant -> source edits (old, new); each old text must match once
VARIANTS = {
    "1xTF32": [(x, "") for x in _S_LO + _S_LO2 + _PV_LO + _PV_LO2],
    "one lo-term dropped": [(x, "") for x in _S_LO + _PV_LO],
    "no splits": [("  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));",
                   "  hi = __float_as_uint(x);\n  lo = 0u;")],
    "3 CTAs an SM": [("constexpr int kTfMinBlocks = kDPad <= 64 ? 2 : 1;",
                      "constexpr int kTfMinBlocks = kDPad <= 64 ? 3 : 1;")],
    "q from shared": [("constexpr bool kTfQInRegs = kDPad <= 64;",
                       "constexpr bool kTfQInRegs = kDPad <= 32;")],
}


def ptxas_lines(log: str, key: str):
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and key in line:
            name = line.split("'")[1].split("_cu_")[-1].lstrip("0123456789")[:48]
            regs = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            yield f"  {name}: " + "; ".join(regs)


def build_variants(build, before):
    """One library per variant (and the --before source), each exporting
    repro_flash_attn (bound alone); their ptxas lines are printed."""
    out = ROOT / "build" / "attn_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "attn_kernels.cu").read_text()
    texts = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"attn_sweep: variant {name!r} no longer matches the source")
            text = text.replace(old, new)
        texts[name] = text
    if before is not None:
        texts["before"] = Path(before).read_text()
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        path = out / f"variant{i}.cu"
        path.write_text(text)
        procs[name] = (out / f"libvariant{i}.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / f"libvariant{i}.so"),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"attn_sweep: variant {name!r} failed to build:\n{log}")
        print(f"variant {name}:")
        for line in ptxas_lines(log, "flash_attn_kernel" if name == "before" else "tf32x3"):
            print(line)
        lib = ctypes.CDLL(str(lib_path))
        lib.repro_flash_attn.argtypes = list(build.SIGNATURES["repro_flash_attn"])
        lib.repro_flash_attn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--before", help="another attn_kernels.cu whose f32 route to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attn_sweep: no CUDA device")
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
    for line in ptxas_lines(log, "tf32x3"):
        print(line)
    variants = build_variants(build, args.before)
    _, peaks = chip_smoke.card_peaks(torch.cuda.get_device_name(0))
    try:
        chip_smoke.flash_attn_phase(torch, ops, ref, peaks)
    except AssertionError as exc:   # report it, and still time the variants
        print(f"attention phase FAILED: {exc}")

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    B, Lq, Lk, Hq, Hkv, D = SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q = torch.randn((B, Lq, Hq, D), generator=gen, device=dev)
    k = torch.randn((B, Lk, Hkv, D), generator=gen, device=dev)
    v = torch.randn((B, Lk, Hkv, D), generator=gen, device=dev)
    twin = ref.flash_attention_3xtf32_ref(q, k, v, causal=True)
    vmax = float(v.abs().max())
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"package": lambda: ops.flash_attention(q, k, v, causal=True)}
    outs = {}
    for name, lib in variants.items():
        out = torch.empty_like(q)
        outs[name] = out

        def call(lib=lib, out=out, name=name):
            rc = lib.repro_flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0,
                                      B, Lq, Lk, Hq, Hkv, D, 1.0 / D ** 0.5,
                                      ops.attn_flags(q, k, v, out, causal=True), stream)
            if rc:
                raise RuntimeError(f"attn_sweep: {name}: cudaError {rc}")

        fns[name] = call
    times = chip_smoke.time_ms(torch, fns, flush)
    outs["package"] = fns["package"]()
    torch.cuda.synchronize()
    for name, ms in times.items():
        err = float((outs[name] - twin).abs().max()) / vmax
        print(f"f32 {SHAPE} causal {name:20s}: {ms:.4f} ms; max |out - 3xtf32 twin| / max |v| "
              f"= {err:.3e}")


if __name__ == "__main__":
    main()
