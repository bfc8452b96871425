"""Build and load the port's CUDA kernels (plain C interface + ctypes).

The sources in ``xpysom_dask_tpu_torch/csrc/`` are compiled at first use
by ``nvcc`` for ``sm_90a`` into one shared library under
``build/kernels/`` at the repository root. The file name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs at import time; the CPU paths
never call :func:`load_library`.
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

__all__ = ["load_library", "build_dir", "SOURCES", "last_build_seconds"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
SOURCES = ("bmu.cu", "stats.cu")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (every pointer and the stream
# as c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "xps_bmu_argmin": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "xps_bmu_top2": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "xps_scatter_stats": (_P, _P, _P, _P, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib = None
last_build_seconds = None  # wall time of this process's build, if it built


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
    for name in SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_dir() / f"libxpysom_kernels_{_digest()}.so"
            if not path.exists():
                _build(path)
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
