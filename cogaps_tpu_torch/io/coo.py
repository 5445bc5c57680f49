"""COO input — a copy of the CooMatrix NamedTuple of cogaps_tpu/io/h5.py,
the package's one COO class: io/h5.py's readers return it, and api.py and
sparse_engine.py test for it. A CooMatrix flows into the sparse engines
without densifying."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class CooMatrix(NamedTuple):
    """COO sparse matrix (features x samples) that the sparse engine
    consumes without densifying."""

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float32
    shape: Tuple[int, int]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        out[self.rows, self.cols] = self.vals
        return out
