"""The port's HDF5 readers (cogaps_tpu_torch/io/h5.py) and datasets.py
against the JAX package's, on the CPU.

The files are written as tests/test_h5.py:14-58 writes them (a plain
dense .h5, a 10x CellRanger v3 .h5, an AnnData .h5ad with a csr X), plus
a CellRanger v2 file, a dense-X .h5ad and a csc .h5ad. Each reader of the
port returns exactly what cogaps_tpu's does; its COO matrices are the
one CooMatrix class of io/coo.py; CoGAPS on an .h5ad equals the port's
run on the same CooMatrix bit for bit."""

import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
scipy_sparse = pytest.importorskip("scipy.sparse")

import cogaps_tpu_torch  # noqa: E402
from cogaps_tpu import datasets as jdatasets  # noqa: E402
from cogaps_tpu.io import h5 as jh5  # noqa: E402
from cogaps_tpu_torch import datasets  # noqa: E402
from cogaps_tpu_torch.io import coo, h5  # noqa: E402


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(5)
    A = (rng.gamma(2, 1, (30, 3)) * (rng.random((30, 3)) < 0.5)
         ).astype(np.float32)
    P = (rng.gamma(2, 1, (20, 3)) * (rng.random((20, 3)) < 0.5)
         ).astype(np.float32)
    D = (A @ P.T).astype(np.float32)
    genes = np.array([f"g{i}".encode() for i in range(30)])
    cells = np.array([f"c{i}".encode() for i in range(20)])
    files = {}

    files["plain"] = str(root / "plain.h5")
    with h5py.File(files["plain"], "w") as f:
        f["counts"] = D
        f["other"] = D[:5, :4] + 1.0
        f["row_names"], f["col_names"] = genes, cells

    m = scipy_sparse.csc_matrix(D)
    for version in ("v3", "v2"):
        files[version] = str(root / f"tenx_{version}.h5")
        with h5py.File(files[version], "w") as f:
            g = f.create_group("matrix")
            g["data"], g["indices"], g["indptr"] = m.data, m.indices, m.indptr
            g["shape"] = np.array(D.shape)
            if version == "v3":
                g.create_group("features")["name"] = genes
            else:
                g["gene_names"] = genes
            g["barcodes"] = cells

    for enc, mat in (("csr_matrix", scipy_sparse.csr_matrix(D.T)),
                     ("csc_matrix", scipy_sparse.csc_matrix(D.T)),
                     (None, D.T)):
        name = enc or "dense"
        files[name] = str(root / f"ann_{name}.h5ad")
        with h5py.File(files[name], "w") as f:
            if enc is None:
                f["X"] = mat
            else:
                X = f.create_group("X")
                X.attrs["encoding-type"] = enc
                X.attrs["shape"] = np.array(D.T.shape)
                X["data"], X["indices"], X["indptr"] = (mat.data, mat.indices,
                                                        mat.indptr)
            obs = f.create_group("obs")
            obs.attrs["_index"] = "cell"
            obs["cell"] = cells
            var = f.create_group("var")
            var.attrs["_index"] = "gene"
            var["gene"] = genes
    return D, files


def _same(mine, theirs):
    (m, g, c), (jm, jg, jc) = mine, theirs
    assert g == jg and c == jc
    if isinstance(jm, jh5.CooMatrix):
        assert type(m) is coo.CooMatrix
        for f in ("rows", "cols", "vals"):
            a, b = getattr(m, f), getattr(jm, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert m.shape == jm.shape
    else:
        assert isinstance(m, np.ndarray) and m.dtype == jm.dtype
        np.testing.assert_array_equal(m, jm)


def test_one_coo_class():
    assert h5.CooMatrix is coo.CooMatrix
    from cogaps_tpu_torch import api, sparse_engine
    assert api.CooMatrix is coo.CooMatrix
    assert sparse_engine.CooMatrix is coo.CooMatrix


@pytest.mark.parametrize("name", ["plain", "v3", "v2", "csr_matrix",
                                  "csc_matrix", "dense"])
def test_read_any_h5_matches_jax(h5_files, name):
    D, files = h5_files
    mine = h5.read_any_h5(files[name])
    _same(mine, jh5.read_any_h5(files[name]))
    m = mine[0]
    np.testing.assert_array_equal(m.to_dense() if hasattr(m, "to_dense")
                                  else m, D)
    assert mine[1] == [f"g{i}" for i in range(30)]
    assert mine[2] == [f"c{i}" for i in range(20)]


def test_each_reader_matches_jax(h5_files):
    _, files = h5_files
    _same(h5.read_h5(files["plain"], "other"),
          jh5.read_h5(files["plain"], "other"))
    _same(h5.read_any_h5(files["plain"], "other"),
          jh5.read_any_h5(files["plain"], "other"))
    _same(h5.read_10x_h5(files["v3"]), jh5.read_10x_h5(files["v3"]))
    _same(h5.read_h5ad(files["csc_matrix"]),
          jh5.read_h5ad(files["csc_matrix"]))
    assert h5.read_h5(files["plain"], "other")[0].shape == (5, 4)


def test_h5ad_run_equals_the_coo_run(h5_files):
    """CoGAPS on the .h5ad file reads it through io/h5.read_any_h5 and
    runs the sparse model: bit-equal to the run on the CooMatrix it
    reads, with the file's names."""
    _, files = h5_files
    kw = dict(n_patterns=3, n_iterations=30, seed=2, messages=False,
              sparse_optimization=True, device="cpu")
    res = cogaps_tpu_torch.CoGAPS(files["csr_matrix"], **kw)
    mat, genes, cells = h5.read_any_h5(files["csr_matrix"])
    ref = cogaps_tpu_torch.CoGAPS(mat, gene_names=genes, sample_names=cells,
                                  **kw)
    for name in ("Amean", "Asd", "Pmean", "Psd"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
    assert res.mean_chi_sq == ref.mean_chi_sq > 0
    assert res.gene_names[0] == "g0" and res.sample_names[0] == "c0"
    assert res.Amean.shape == (30, 3)


def test_transposed_h5ad_swaps_names(h5_files):
    _, files = h5_files
    res = cogaps_tpu_torch.CoGAPS(files["csr_matrix"], n_patterns=3,
                                  n_iterations=5, seed=1, messages=False,
                                  transpose_data=True, device="cpu")
    assert res.Amean.shape == (20, 3) and res.Pmean.shape == (30, 3)
    assert res.gene_names[0] == "c0" and res.sample_names[0] == "g0"


def test_datasets_match_jax(tmp_path):
    mine, theirs = datasets.load_gist(), jdatasets.load_gist()
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[1:] == theirs[1:]
    unc, junc = (datasets.load_gist(with_uncertainty=True)[3],
                 jdatasets.load_gist(with_uncertainty=True)[3])
    np.testing.assert_array_equal(unc, junc)
    D, golden = datasets.load_modsim()
    jD, jgolden = jdatasets.load_modsim()
    np.testing.assert_array_equal(D, jD)
    assert sorted(golden) == sorted(jgolden)
    for k in golden:
        np.testing.assert_array_equal(golden[k], jgolden[k])
    assert datasets.RETINA_FILES == jdatasets.RETINA_FILES


def test_retina_subset_raises_as_jax_does(tmp_path):
    for mod in (datasets, jdatasets):
        with pytest.raises(FileNotFoundError, match="retina_subset_1.h5"):
            mod.get_retina_subset(1, data_dir=str(tmp_path))
        with pytest.raises(ValueError, match="1..4"):
            mod.get_retina_subset(5)
    assert not os.path.exists(os.path.join(datasets._DATA,
                                           "retina_subset_1.h5"))
