"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles each source in ``csrc/`` for ``sm_90a`` to an object, all
sources at once in parallel processes, and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, from the sources in this checkout only, into
``<repo>/build/repro_torch_kernels/<source hash>/`` (listed in
``.gitignore``), so a changed source builds anew and an unchanged one loads
the library already built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("afa_kernels.cu", "rank_kernels.cu", "attn_kernels.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the library (the SOURCES in csrc/): name -> argtypes
SIGNATURES = {
    "repro_screen_max_k": (),
    "repro_weighted_sum": (_P, _P, _P, _I, _L, _P),
    "repro_cosine_sim": (_P, _P, _P, _P, _P, _I, _L, _I, _L, _I, _P),
    "repro_gram": (_P, _P, _P, _I, _L, _I, _I, _L, _I, _P),
    "repro_afa_screen": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _L, _I, _I, _L, _I, _F, _F, _I, _I, _P),
    "repro_rank_max_k": (),
    "repro_coord_median": (_P, _P, _P, _I, _L, _I, _I, _I, _P),
    "repro_trimmed_mean": (_P, _P, _P, _I, _L, _I, _I, _I, _I, _P),
    "repro_flash_attn_max_d": (),
    "repro_flash_attn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the repro_torch CUDA kernels are built from "
        "src/repro_torch/kernels/csrc at first use and need the CUDA toolkit"
    )


def build_library() -> tuple[Path, str]:
    """Compile the kernels unless this source hash is built already.

    Returns ``(library path, compiler log)``; the log is empty when the
    library was already there."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libafa_kernels.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out_dir / (Path(name).stem + f".{os.getpid()}.o") for name in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(name, p.returncode, log) for name, p, log in zip(SOURCES, procs, logs)
              if p.returncode != 0]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(("link", link.returncode, link.stdout + link.stderr))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"[{name}] exit {rc}\n{log}" for name, rc, log in failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, "".join(logs)


def bind(path) -> ctypes.CDLL:
    """Load a library built from ``csrc`` and declare every C signature."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    path, _ = build_library()
    return bind(path)
