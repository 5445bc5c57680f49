"""ctypes binding of the native streaming parsers (native/fastparse.cpp),
the counterpart of the reference's C++ file_parser layer — the port's copy
of cogaps_tpu/io/native.py, with its own build.

The source is compiled with the host C++ compiler (``c++ -O3 -fPIC
-shared``; no -march flag, so the library runs on any CPU of the host's
architecture) into
cogaps_tpu_torch/_build/ at first use, keyed by a hash of the source, the
flags and the compiler's version, as ops/cuda_build.py builds the kernels.
Nothing under native/ is written or loaded: only its source is read.
When the library cannot be built or loaded, available() is false and
io/parsers.read_matrix falls back to the pure-Python parsers, saying so
once on stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "fastparse.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None
_failure: Optional[str] = None


def _cxx() -> str:
    found = shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (c++) on PATH")
    return found


@functools.cache
def library_path() -> Path:
    """The library built from this source, with these flags, by this
    compiler. Raises when the source or the compiler is missing."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + version.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastparse_{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed on {SOURCE.name} ({proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def _bind(lib):
    lib.fp_read_delim.restype = ctypes.c_void_p
    lib.fp_read_delim.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int]
    lib.fp_read_mtx.restype = ctypes.c_void_p
    lib.fp_read_mtx.argtypes = [ctypes.c_char_p]
    for fn in ("fp_nrows", "fp_ncols", "fp_nnz"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fp_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.fp_data.argtypes = [ctypes.c_void_p]
    lib.fp_rowidx.restype = ctypes.POINTER(ctypes.c_int32)
    lib.fp_rowidx.argtypes = [ctypes.c_void_p]
    lib.fp_colidx.restype = ctypes.POINTER(ctypes.c_int32)
    lib.fp_colidx.argtypes = [ctypes.c_void_p]
    lib.fp_rownames.restype = ctypes.c_char_p
    lib.fp_rownames.argtypes = [ctypes.c_void_p]
    lib.fp_colnames.restype = ctypes.c_char_p
    lib.fp_colnames.argtypes = [ctypes.c_void_p]
    lib.fp_error.restype = ctypes.c_char_p
    lib.fp_error.argtypes = [ctypes.c_void_p]
    lib.fp_free.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    global _lib, _failure
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _compile(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        except Exception as e:  # noqa: BLE001 — reported by failure()
            _failure = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    """True when the native parser is built and loaded (building it on the
    first call); read_matrix(use_native=True) then runs it."""
    return _load() is not None


def failure() -> Optional[str]:
    """Why the native parser could not be built or loaded, else None."""
    _load()
    return _failure


def _names(blob: bytes) -> Optional[List[str]]:
    if not blob:
        return None
    return blob.decode("utf-8", errors="replace").split("\n")


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable ({_failure})")
    return lib


def read_delim(path: str, sep: str, gct: bool = False
               ) -> Tuple[np.ndarray, Optional[List[str]], Optional[List[str]]]:
    lib = _library()
    h = lib.fp_read_delim(path.encode(), sep.encode(), 1 if gct else 0)
    try:
        err = lib.fp_error(h)
        if err:
            raise ValueError(err.decode())
        n, m = lib.fp_nrows(h), lib.fp_ncols(h)
        mat = np.ctypeslib.as_array(lib.fp_data(h), shape=(n, m)).copy()
        return (mat.astype(np.float32, copy=False),
                _names(lib.fp_rownames(h)), _names(lib.fp_colnames(h)))
    finally:
        lib.fp_free(h)


def read_mtx_coo(path: str
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    lib = _library()
    h = lib.fp_read_mtx(path.encode())
    try:
        err = lib.fp_error(h)
        if err:
            raise ValueError(err.decode())
        nnz = lib.fp_nnz(h)
        rows = np.ctypeslib.as_array(lib.fp_rowidx(h), shape=(nnz,)).copy()
        cols = np.ctypeslib.as_array(lib.fp_colidx(h), shape=(nnz,)).copy()
        vals = np.ctypeslib.as_array(lib.fp_data(h), shape=(nnz,)).copy()
        return rows, cols, vals, int(lib.fp_nrows(h)), int(lib.fp_ncols(h))
    finally:
        lib.fp_free(h)
