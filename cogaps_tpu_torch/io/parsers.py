"""File parsers: csv / tsv / gct / mtx (+ writers) — the port's copy of
cogaps_tpu/io/parsers.py.

Parity with the reference's streaming parsers dispatched on extension
(reference: src/file_parser/FileParser.cpp:9-19,73-85;
CharacterDelimitedParser.cpp; MtxParser.cpp), including row/column name
extraction and the csv writer (FileParser.h:60-88). The native C++
streaming parser (io/native.py, built from native/fastparse.cpp)
accelerates large files; this module is the always-available fallback and
the dispatch layer.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import numpy as np

Names = Optional[List[str]]


def file_type(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".csv", ".tsv", ".mtx", ".gct"):
        return ext[1:]
    raise ValueError(f"unsupported file extension: {path}")


def read_matrix(path: str, use_native: bool = True
                ) -> Tuple[np.ndarray, Names, Names]:
    """Returns (matrix, row_names, col_names). Prefers the native C++
    streaming parser (io/native.py) when it builds; falls back to the
    pure-Python implementations below when it cannot be built (said once)
    or fails on this file (said for the file)."""
    kind = file_type(path)
    if use_native:
        from . import native
        if not native.available():
            _fall_back(native.failure())
        else:
            try:
                if kind in ("csv", "tsv"):
                    sep = "," if kind == "csv" else "\t"
                    return native.read_delim(path, sep)
                if kind == "gct":
                    return native.read_delim(path, "\t", gct=True)
                rows, cols, vals, n, m = native.read_mtx_coo(path)
                mat = np.zeros((n, m), np.float32)
                mat[rows, cols] = vals
                return mat, None, None
            except Exception as e:  # noqa: BLE001 — the Python parser decides
                print(f"cogaps_tpu_torch: the native parser failed on "
                      f"{path} ({type(e).__name__}: {e}); reading it with "
                      f"the Python parser", file=sys.stderr, flush=True)
    if kind == "csv":
        return _read_delimited(path, ",")
    if kind == "tsv":
        return _read_delimited(path, "\t")
    if kind == "gct":
        return _read_gct(path)
    return _read_mtx(path)


_fell_back = False


def _fall_back(reason) -> None:
    """Say once, on stderr, that the Python parsers run instead of the
    native one."""
    global _fell_back
    if not _fell_back:
        _fell_back = True
        print(f"cogaps_tpu_torch: the native parser is unavailable "
              f"({reason}); reading files with the Python parsers",
              file=sys.stderr, flush=True)


def file_info(path: str) -> dict:
    """Dimension/name probe (reference: src/Cogaps.cpp:244-253
    getFileInfo_cpp)."""
    mat, rows, cols = read_matrix(path)
    return {
        "nRows": mat.shape[0], "nCols": mat.shape[1],
        "rowNames": rows, "colNames": cols,
    }


def _dequote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    return s


def _read_delimited(path: str, sep: str) -> Tuple[np.ndarray, Names, Names]:
    with open(path) as f:
        header = f.readline().rstrip("\n\r").split(sep)
        rows, data = [], []
        for line in f:
            line = line.rstrip("\n\r")
            if not line:
                continue
            parts = line.split(sep)
            rows.append(_dequote(parts[0]))
            data.append(parts[1:])
    mat = np.asarray(data, dtype=np.float32)
    col_names = [_dequote(c) for c in header[-mat.shape[1]:]]
    return mat, rows or None, col_names or None


def _read_gct(path: str) -> Tuple[np.ndarray, Names, Names]:
    """GCT 1.2: version line, 'nrows\tncols' line, header with
    Name/Description, then rows (reference: CharacterDelimitedParser
    gct branch)."""
    with open(path) as f:
        f.readline()  # #1.2
        dims = f.readline().split()
        n_rows, n_cols = int(dims[0]), int(dims[1])
        header = f.readline().rstrip("\n\r").split("\t")
        col_names = [_dequote(c) for c in header[2:2 + n_cols]]
        rows, data = [], []
        for line in f:
            line = line.rstrip("\n\r")
            if not line:
                continue
            parts = line.split("\t")
            rows.append(_dequote(parts[0]))
            data.append(parts[2:2 + n_cols])
    mat = np.asarray(data, dtype=np.float32)
    if mat.shape != (n_rows, n_cols):
        raise ValueError("gct dimension mismatch")
    return mat, rows, col_names


def _read_mtx(path: str) -> Tuple[np.ndarray, Names, Names]:
    """MatrixMarket coordinate format (reference: MtxParser.cpp)."""
    with open(path) as f:
        line = f.readline()
        if not line.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(x) for x in line.split()[:3])
        mat = np.zeros((n_rows, n_cols), np.float32)
        for _ in range(nnz):
            parts = f.readline().split()
            i, j = int(parts[0]) - 1, int(parts[1]) - 1
            mat[i, j] = float(parts[2]) if len(parts) > 2 else 1.0
    return mat, None, None


def read_mtx_coo(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Sparse COO read for the sparse-optimization path."""
    with open(path) as f:
        line = f.readline()
        if not line.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(x) for x in line.split()[:3])
        rows = np.empty(nnz, np.int32)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float32)
        for n in range(nnz):
            parts = f.readline().split()
            rows[n] = int(parts[0]) - 1
            cols[n] = int(parts[1]) - 1
            vals[n] = float(parts[2]) if len(parts) > 2 else 1.0
    return rows, cols, vals, n_rows, n_cols


def write_csv(path: str, mat: np.ndarray, row_names=None, col_names=None) -> None:
    """CSV writer (reference: FileParser.h:60-88 writeToCsv)."""
    n_rows, n_cols = mat.shape
    row_names = row_names or [f"Gene_{i+1}" for i in range(n_rows)]
    col_names = col_names or [f"Sample_{j+1}" for j in range(n_cols)]
    with open(path, "w") as f:
        f.write("," + ",".join(f"\"{c}\"" for c in col_names) + "\n")
        for i in range(n_rows):
            f.write(f"\"{row_names[i]}\","
                    + ",".join(f"{v:.10g}" for v in mat[i]) + "\n")
