"""Build and load the port's CUDA kernels (plain C interface + ctypes).

The sources in ``xpysom_dask_tpu_torch/csrc/`` are compiled at first use
by ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all started
together — and linked into one shared library under ``build/kernels/`` at
the repository root, with the compilers' output (ptxas's ``-v`` report)
beside it as ``.log``. The file name carries a hash of the sources,
headers and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time; the CPU paths never call
:func:`load_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_dir", "SOURCES", "last_build_seconds", "last_build_log"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
SOURCES = (
    "gemm_sm90.cu", "stats.cu", "highest.cu", "elementwise.cu", "manhattan.cu", "fused_stats.cu",
)
HEADERS = ("tile_argmin.cuh", "sm90.cuh", "gemm_sm90.cuh", "stats.cuh")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: ptxas reports each kernel's registers and spills (kept in
# last_build_log)
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points and their argument types (every pointer and the stream
# as c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "xps_layout_bf16": (_P, _I, _I, _L, _L, _I, _I, _P, _P),
    "xps_pack_layout": (_P, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "xps_gemm_argmin": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "xps_gemm_split3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "xps_gemm_top2": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "xps_gemm_feed": (_P, _P, _I, _I, _I, _I, _P),
    "xps_gemm_argmin_kb": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "xps_scatter_stats": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "xps_bmu_highest": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "xps_split_tf32": (_P, _I, _I, _P, _P, _P),
    "xps_layout_f32": (_P, _I, _I, _L, _I, _P, _P),
    "xps_bmu_manhattan": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "xps_bmu_lp_odd": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "xps_bmu_lp_frac": (_P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P),
    "xps_manhattan_distance": (_P, _P, _I, _I, _I, _I, _P, _P),
    "xps_bmu_stats_fused": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib = None
last_build_seconds = None  # wall time of this process's build, if it built
last_build_log = None  # the compilers' output of the loaded library's build


def build_dir() -> Path:
    """``build/kernels`` beside the package (listed in ``.gitignore``)."""
    return _PKG.parent / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds) -> list:
    """Run the commands side by side; raise with the first failure's
    output, else return each command's output. Every process is waited
    for (or killed) before returning."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    try:
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{text}")
    return outs


def _build(out: Path) -> None:
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    objs = [Path(f"{stem}.{Path(s).stem}.o") for s in SOURCES]
    tmp = Path(f"{stem}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
                    for s, o in zip(SOURCES, objs)])
        _run([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, last_build_log
    with _lock:
        if _lib is None:
            path = build_dir() / f"libxpysom_kernels_{_digest()}.so"
            if not path.exists():
                _build(path)
            log = path.with_suffix(".log")
            last_build_log = log.read_text() if log.exists() else None
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
