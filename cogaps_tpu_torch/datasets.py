"""Bundled and well-known datasets — the analog of the reference's data
helpers (reference: R/data.R, R/HelperFunctions.R:11-42).

* ``load_gist()`` / ``load_modsim()`` — the datasets the reference ships
  in ``data/`` (GIST.RData, modsimdata.rda), vendored here as npz via
  the pure-Python RData reader (io/rdata.py).
* ``get_retina_subset()`` — the scRNA retina convenience loader
  (reference: R/HelperFunctions.R:11-42). The reference downloads four
  hdf5 chunks from a hosting URL at call time; this build runs without
  network egress, so the files must already be on disk — pass the
  directory holding them.

The port's copy of cogaps_tpu/datasets.py (numpy; h5py inside the h5
readers).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

#: the reference's retina chunk file names (R/HelperFunctions.R:16-20)
RETINA_FILES = (
    "retina_subset_1.h5",
    "retina_subset_2.h5",
    "retina_subset_3.h5",
    "retina_subset_4.h5",
)


def load_gist(with_uncertainty: bool = False):
    """GIST: 1363 genes x 9 samples (reference: data/GIST.RData;
    asserted in tests/testthat/test_top_level.R:33-36). Returns
    (D, gene_names, sample_names[, uncertainty])."""
    from .io import parsers
    D, genes, samples = parsers.read_matrix(
        os.path.join(_DATA, "GIST.csv"))
    if with_uncertainty:
        z = np.load(os.path.join(_DATA, "gist.npz"))
        return D, genes, samples, np.asarray(z["uncertainty"])
    return D, genes, samples


def load_modsim():
    """modsimdata: the 25 x 20 simulated toy (reference: R/data.R:12,
    data/modsimdata.rda). Returns (D, golden) where golden holds the
    reference's converged 50k-iteration result matrices."""
    z = np.load(os.path.join(_DATA, "modsim.npz"))
    g = {k: np.asarray(z[k]) for k in z}
    return g.pop("D"), g


def get_retina_subset(n_subsets: int = 1,
                      data_dir: Optional[str] = None
                      ) -> Tuple[np.ndarray, list, list]:
    """Load 1-4 subsets of the single-cell retina dataset, concatenated
    along cells (reference: R/HelperFunctions.R:11-42, which fetches the
    chunks from its hosting URL; this environment has no network, so the
    h5 files must already exist under `data_dir`). Returns
    (matrix genes x cells, gene_names, cell_names)."""
    if not 1 <= int(n_subsets) <= 4:
        raise ValueError("n_subsets must be in 1..4")
    data_dir = data_dir or _DATA
    from .io.h5 import read_any_h5
    mats, genes, cells = [], None, []
    for fname in RETINA_FILES[: int(n_subsets)]:
        path = os.path.join(data_dir, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found. This build cannot download data; "
                f"fetch the retina chunk files named {RETINA_FILES} "
                f"into {data_dir!r} first (the reference hosts them for "
                f"getRetinaSubset, R/HelperFunctions.R:11-42).")
        mat, g, c = read_any_h5(path)
        if hasattr(mat, "to_dense"):
            mat = mat.to_dense()
        mats.append(np.asarray(mat, np.float32))
        genes = genes or g
        cells.extend(c or [f"cell_{len(cells) + i}"
                           for i in range(mat.shape[1])])
    return np.concatenate(mats, axis=1), genes, cells
