"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, into ``_build/`` next to this file, and is keyed by a
hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  ``nvcc`` is taken from ``$CUDA_HOME/bin``
(default ``/usr/local/cuda``) or the ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_DIR = Path(__file__).parent
SRC_DIR = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction, IEEE division and square root: the push
    # columns then match the plain PyTorch version bit for bit
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas=-v", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            "kernels are built on a machine with the CUDA toolkit"
        )
    return found


def build() -> tuple[Path, float]:
    """Compile the sources if no library for their hash exists yet: one
    ``nvcc -c`` a source, all started together, then one link.  Returns
    the library path and the seconds the build took (0 when the library
    was already there).  The compiler's resource report (``-Xptxas
    -v``) is kept beside it as ``<name>.log``."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libopal_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in sources]
    jobs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)]
    logs = [j.communicate()[0] for j in jobs]
    failed = [s.name for s, j in zip(sources, jobs) if j.returncode != 0]
    if not failed:
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(res.stdout)
        if res.returncode != 0:
            failed.append("the link")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(logs)
    lib.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    tmp.replace(lib)
    return lib, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every C
    function's argument and result types declared."""
    path, _ = build()
    L = ctypes.CDLL(str(path))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = L.opal_fused_push_deposit
    fn.restype = i32
    fn.argtypes = (
        [vp] * 27 + [ctypes.c_longlong] + [i32] * 9 + [f32] * 10 + [vp]
    )
    fn = L.opal_fused_push_deposit_packed
    fn.restype = i32
    fn.argtypes = (
        [vp] * 8 + [ctypes.c_longlong] + [i32] * 7 + [f32] * 10 + [vp]
    )
    i64, f64 = ctypes.c_longlong, ctypes.c_double
    fn = L.opal_misfit_fallback
    fn.restype = i32
    fn.argtypes = (
        [vp, i64, i64] + [vp] * 17 + [i64] * 2 + [i32] * 7 + [f32] * 10 + [vp]
    )
    fn = L.opal_misfit_compact
    fn.restype = i32
    fn.argtypes = [vp, i64, i64, i64, vp, i64, vp, i64, vp, vp, vp]
    fn = L.opal_absorb_walk
    fn.restype = i32
    fn.argtypes = [vp] * 20 + [i64] * 4 + [i32] * 11 + [f64] * 3 + [vp]
    fn = L.opal_cell_envelope
    fn.restype = i32
    fn.argtypes = [vp] * 4 + [i64] * 2 + [vp]
    fn = L.opal_cell_envelope_plan
    fn.restype = i32
    fn.argtypes = [i64, vp]
    fn = L.opal_pwmci_invert
    fn.restype = i32
    fn.argtypes = [vp] * 2 + [i32] + [vp] * 6 + [i64] + [i32] * 4 + [vp]
    return L
