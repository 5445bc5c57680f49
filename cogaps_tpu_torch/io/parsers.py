"""File parsers: csv / tsv / gct / mtx — a copy of the pure-Python
readers of cogaps_tpu/io/parsers.py (the native C++ parser and the
writers are not carried over; h5/h5ad input waits for a later slice).

Parity with the reference's streaming parsers dispatched on extension
(reference: src/file_parser/FileParser.cpp:9-19,73-85;
CharacterDelimitedParser.cpp; MtxParser.cpp), including row/column name
extraction.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

Names = Optional[List[str]]


def file_type(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".csv", ".tsv", ".mtx", ".gct"):
        return ext[1:]
    raise ValueError(f"unsupported file extension: {path}")


def read_matrix(path: str) -> Tuple[np.ndarray, Names, Names]:
    """Returns (matrix, row_names, col_names)."""
    kind = file_type(path)
    if kind == "csv":
        return _read_delimited(path, ",")
    if kind == "tsv":
        return _read_delimited(path, "\t")
    if kind == "gct":
        return _read_gct(path)
    return _read_mtx(path)


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
