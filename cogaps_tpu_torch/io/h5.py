"""HDF5 ingestion: plain datasets, 10x Genomics CellRanger .h5, and
AnnData .h5ad.

Capability parity with the reference's single-cell input story: the R
layer reads HDF5 slices (reference: R/HelperFunctions.R:11-42
getRetinaSubset) and the nextflow pipeline converts 10x/AnnData
containers to dgCMatrix before running (reference:
nextflow/main.nf:62-177, COGAPS_TENX2DGC / COGAPS_ADATA2DGC). Here the
conversions are native: each reader returns either a dense matrix or a
CooMatrix that flows into the sparse engine without densifying
(models/sparse.py).

A copy of cogaps_tpu/io/h5.py. The CooMatrix class is io/coo.py's, re-exported
here, so what these readers return is what api.py and sparse_engine.py
test for. h5py is imported inside each reader: `import cogaps_tpu_torch`
never loads it.

Matrices are returned in CoGAPS orientation (features x samples =
genes x cells); .h5ad X is stored observations x variables
(cells x genes) and is transposed on read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .coo import CooMatrix

__all__ = ["CooMatrix", "read_h5", "read_10x_h5", "read_h5ad", "read_any_h5"]


def _decode(names) -> list:
    return [n.decode() if isinstance(n, bytes) else str(n) for n in names]


def _csx_to_coo(data, indices, indptr, shape, csr: bool) -> CooMatrix:
    nnz = len(data)
    major = np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                      np.diff(indptr).astype(np.int64))
    minor = np.asarray(indices, np.int32)
    if csr:
        rows, cols = major, minor
    else:
        rows, cols = minor, major
    return CooMatrix(rows=rows[:nnz], cols=cols[:nnz],
                     vals=np.asarray(data, np.float32),
                     shape=(int(shape[0]), int(shape[1])))


def read_h5(path: str, dataset: Optional[str] = None):
    """Read a dense matrix (+ optional dimnames) from a plain HDF5 file.
    `dataset` defaults to the first 2-D dataset found."""
    import h5py

    with h5py.File(path, "r") as f:
        if dataset is None:
            cands = [k for k in f.keys()
                     if isinstance(f[k], h5py.Dataset)
                     and f[k].ndim == 2]
            if not cands:
                raise ValueError(f"{path}: no 2-D dataset found")
            dataset = cands[0]
        mat = np.asarray(f[dataset], np.float32)
        row_names = col_names = None
        for key, target in (("row_names", "rows"), ("col_names", "cols")):
            if key in f:
                names = _decode(f[key][...])
                if target == "rows":
                    row_names = names
                else:
                    col_names = names
    return mat, row_names, col_names


def read_10x_h5(path: str) -> Tuple[CooMatrix, list, list]:
    """10x Genomics CellRanger HDF5 (CSC genes x cells): group holding
    data/indices/indptr/shape plus gene and barcode names. Returns
    (CooMatrix genes x cells, gene_names, barcodes)."""
    import h5py

    with h5py.File(path, "r") as f:
        group = None
        for key in ("matrix",) + tuple(f.keys()):
            if key in f and isinstance(f[key], h5py.Group) \
                    and "indptr" in f[key]:
                group = f[key]
                break
        if group is None:
            raise ValueError(f"{path}: no CellRanger matrix group found")
        shape = group["shape"][...]
        coo = _csx_to_coo(group["data"][...], group["indices"][...],
                          group["indptr"][...], shape, csr=False)
        if "features" in group:  # CellRanger v3
            genes = _decode(group["features"]["name"][...])
        elif "gene_names" in group:  # v2
            genes = _decode(group["gene_names"][...])
        else:
            genes = [f"Gene_{i+1}" for i in range(coo.shape[0])]
        barcodes = (_decode(group["barcodes"][...]) if "barcodes" in group
                    else [f"Cell_{i+1}" for i in range(coo.shape[1])])
    return coo, genes, barcodes


def read_h5ad(path: str):
    """AnnData .h5ad: X (dense array or csr/csc group) stored cells x
    genes; transposed to genes x cells on return. Returns
    (matrix-or-CooMatrix, gene_names, cell_names)."""
    import h5py

    with h5py.File(path, "r") as f:
        X = f["X"]

        def axis_names(key):
            if key not in f:
                return None
            g = f[key]
            idx = g.attrs.get("_index", "index")
            idx = idx.decode() if isinstance(idx, bytes) else idx
            if isinstance(g, h5py.Group) and idx in g:
                return _decode(g[idx][...])
            return None

        cells = axis_names("obs")
        genes = axis_names("var")

        if isinstance(X, h5py.Dataset):  # dense, cells x genes
            mat = np.asarray(X, np.float32).T
            return mat, genes, cells

        enc = X.attrs.get("encoding-type", "")
        enc = enc.decode() if isinstance(enc, bytes) else enc
        shape = X.attrs["shape"]  # (cells, genes)
        csr = "csr" in enc or ("h5sparse_format" in X.attrs
                               and b"csr" in bytes(X.attrs["h5sparse_format"]))
        coo_cg = _csx_to_coo(X["data"][...], X["indices"][...],
                             X["indptr"][...], shape, csr=csr)
        # transpose: cells x genes -> genes x cells
        coo = CooMatrix(rows=coo_cg.cols, cols=coo_cg.rows,
                        vals=coo_cg.vals,
                        shape=(coo_cg.shape[1], coo_cg.shape[0]))
        return coo, genes, cells


def read_any_h5(path: str, dataset: Optional[str] = None):
    """Extension/content dispatch: .h5ad -> AnnData; CellRanger-style
    groups -> 10x; otherwise plain dense dataset."""
    if path.endswith(".h5ad"):
        return read_h5ad(path)
    import h5py

    with h5py.File(path, "r") as f:
        is_10x = any(isinstance(f[k], type(f)) or
                     (hasattr(f[k], "keys") and "indptr" in f[k])
                     for k in f.keys())
    if is_10x and dataset is None:
        return read_10x_h5(path)
    return read_h5(path, dataset)
