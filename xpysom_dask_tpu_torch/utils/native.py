"""Build + ctypes bindings for the native C++ chunk loader.

Counterpart of ``xpysom_dask_tpu/utils/native.py``. The shared library is
compiled on demand from ``xpysom_dask_tpu_torch/csrc/chunkloader.cpp``
with the host toolchain (g++) into ``build/native/`` at the repository
root (beside the CUDA kernels' ``build/kernels/``, never into ``csrc/``);
its file name carries a hash of the source, so an edited source is rebuilt
and a stale library is never loaded. Environments without a toolchain
fall back to ``np.memmap`` slicing in ``parallel.pipeline.FileSource``.
Bindings use ctypes — no pybind11 dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["load_chunkloader", "native_available", "library_path"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "chunkloader.cpp"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """``build/native/libxsomchunk_<hash>.so`` at the repository root
    (``build/`` is listed in ``.gitignore``)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _PKG.parent / "build" / "native" / f"libxsomchunk_{h}.so"


def _build(so_path: Path) -> bool:
    """Compile to a process-unique temp name, then atomically rename into
    place: compiling with ``-o so_path`` would TRUNCATE the live library
    while other processes have it mapped — overwriting their text pages —
    or while a third process is mid-CDLL of the half-written file.
    ``os.replace`` swaps the directory entry; live mappings keep the old
    inode."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f".{so_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load_chunkloader():
    """Return the ctypes-bound chunk loader library, or None if the native
    toolchain is unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so_path = library_path()
        if not so_path.exists() and not _build(so_path):
            return None
        try:
            lib = ctypes.CDLL(str(so_path))
        except OSError:
            return None
        lib.xs_open.restype = ctypes.c_void_p
        lib.xs_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.xs_acquire.restype = ctypes.POINTER(ctypes.c_float)
        lib.xs_acquire.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.xs_release.argtypes = [ctypes.c_void_p]
        lib.xs_reset.argtypes = [ctypes.c_void_p]
        lib.xs_close.argtypes = [ctypes.c_void_p]
        lib.xs_error.restype = ctypes.c_char_p
        lib.xs_error.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_chunkloader() is not None
