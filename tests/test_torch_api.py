"""The port's entry point and copied modules (cogaps_tpu_torch) against
the JAX package, on the CPU.

* CoGAPS on modsim lands inside tests/test_golden.py:48-73's bands for
  the reference's converged modsim result (same iterations, same seed,
  same bands; the port's Philox draws differ from JAX's threefry ones, so
  the run is compared in distribution);
* the same seed gives identical results, another seed does not;
* the modules copied from the JAX package agree with their originals;
* the package imports no jax, flax or cogaps_tpu module (an AST scan of
  its sources and a clean interpreter)."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cogaps_tpu_torch
from cogaps_tpu import params as jparams
from cogaps_tpu import result as jresult
from cogaps_tpu.io import parsers as jparsers
from cogaps_tpu.models import dense as jdense
from cogaps_tpu_torch import params, result
from cogaps_tpu_torch.io import parsers
from cogaps_tpu_torch.models import dense

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
PKG = os.path.join(ROOT, "cogaps_tpu_torch")


@pytest.fixture(scope="module")
def modsim_golden():
    z = np.load(os.path.join(DATA, "modsim.npz"))
    return {k: np.asarray(z[k]) for k in z}


def test_modsim_golden_equilibrium(modsim_golden):
    """tests/test_golden.py::test_modsim_golden_equilibrium's run and
    bands: the chi^2 plateau within [0.6, 1.35] of the golden one,
    meanChiSq below 1.8x golden, atom counts in the golden regime."""
    g = modsim_golden
    res = cogaps_tpu_torch.CoGAPS(g["D"], n_patterns=3, n_iterations=1500,
                                  seed=7, messages=False, output_frequency=150,
                                  device="cpu")
    golden_mcs = float(g["golden_meanChiSq"].reshape(-1)[0])
    golden_eq = float(np.mean(g["golden_chisqHistory"][2:]))
    hist = res.diagnostics["chisqHistory"]
    ours_eq = float(np.mean(hist[len(hist) // 2:]))
    assert 0.6 * golden_eq < ours_eq < 1.35 * golden_eq, (ours_eq, golden_eq)
    assert res.mean_chi_sq < 1.8 * golden_mcs, (res.mean_chi_sq, golden_mcs)
    n_a = res.diagnostics["atomHistoryA"][-1]
    n_p = res.diagnostics["atomHistoryP"][-1]
    assert 10 <= n_a <= 10 * np.mean(g["golden_atomsA"])
    assert 5 <= n_p <= 10 * np.mean(g["golden_atomsP"])
    assert res.diagnostics["device"] == "cpu"


def test_seed_consistency(modsim_golden):
    D = modsim_golden["D"]

    def run(seed):
        return cogaps_tpu_torch.CoGAPS(D, n_patterns=3, n_iterations=30,
                                       seed=seed, messages=False,
                                       output_frequency=10, device="cpu")

    a, b, c = run(11), run(11), run(12)
    for name in ("Amean", "Asd", "Pmean", "Psd"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.diagnostics["chisqHistory"],
                                  b.diagnostics["chisqHistory"])
    assert a.diagnostics["totalUpdates"] == b.diagnostics["totalUpdates"]
    assert not np.array_equal(a.Amean, c.Amean)
    assert a.Amean.shape == (25, 3) and a.Pmean.shape == (20, 3)
    assert a.gene_names[0] == "Gene_1" and len(a.pattern_names) == 3


@pytest.fixture(scope="module")
def h5_inputs(tmp_path_factory, modsim_golden):
    """modsim's D as a 10x CellRanger .h5 (COO on read), a plain dense
    .hdf5 and an AnnData .h5ad (COO), written as tests/test_h5.py:14-58
    writes them."""
    h5py = pytest.importorskip("h5py")
    sps = pytest.importorskip("scipy.sparse")
    D = modsim_golden["D"]
    root = tmp_path_factory.mktemp("h5_inputs")
    genes = np.array([f"g{i}".encode() for i in range(D.shape[0])])
    cells = np.array([f"c{i}".encode() for i in range(D.shape[1])])
    with h5py.File(root / "x.h5", "w") as f:
        m = sps.csc_matrix(D)
        g = f.create_group("matrix")
        g["data"], g["indices"], g["indptr"] = m.data, m.indices, m.indptr
        g["shape"] = np.array(D.shape)
        g.create_group("features")["name"] = genes
        g["barcodes"] = cells
    with h5py.File(root / "x.hdf5", "w") as f:
        f["counts"], f["row_names"], f["col_names"] = D, genes, cells
    with h5py.File(root / "x.h5ad", "w") as f:
        m = sps.csr_matrix(D.T)
        X = f.create_group("X")
        X.attrs["encoding-type"] = "csr_matrix"
        X.attrs["shape"] = np.array(D.T.shape)
        X["data"], X["indices"], X["indptr"] = m.data, m.indices, m.indptr
        for key, idx, names in (("obs", "cell", cells), ("var", "gene", genes)):
            grp = f.create_group(key)
            grp.attrs["_index"] = idx
            grp[idx] = names
    return root


@pytest.mark.parametrize("path", ["x.h5", "x.hdf5", "x.h5ad"])
@pytest.mark.parametrize("entry", ["CoGAPS", "scCoGAPS"])
def test_out_of_slice_options_raise(entry, path, h5_inputs):
    """h5/hdf5/h5ad input, from both entry points, does what the JAX
    package does: a run on what io/h5.read_any_h5 reads (bit-equal to the
    port's run on the matrix and names cogaps_tpu's reader returns), or,
    where JAX raises (a distributed run given the COO matrix a 10x or
    AnnData file reads as), a ValueError."""
    import cogaps_tpu
    from cogaps_tpu.io.h5 import read_any_h5 as jread_any_h5
    from cogaps_tpu_torch.io.coo import CooMatrix
    file = str(h5_inputs / path)
    kw = dict(n_patterns=3, n_iterations=5, seed=2, messages=False)
    if entry == "scCoGAPS":
        kw["n_sets"] = 2
    mat, genes, cells = jread_any_h5(file)
    is_coo = not isinstance(mat, np.ndarray)
    if entry == "scCoGAPS" and is_coo:
        with pytest.raises(ValueError):
            cogaps_tpu.scCoGAPS(file, **kw)
        with pytest.raises(ValueError, match="dense matrix"):
            cogaps_tpu_torch.scCoGAPS(file, device="cpu", **kw)
        return
    res = getattr(cogaps_tpu_torch, entry)(file, device="cpu", **kw)
    if is_coo:
        mat = CooMatrix(*mat)
    ref = getattr(cogaps_tpu_torch, entry)(mat, device="cpu", gene_names=genes,
                                           sample_names=cells, **kw)
    assert res.gene_names == genes == [f"g{i}" for i in range(25)]
    assert res.sample_names == cells == [f"c{i}" for i in range(20)]
    for name in ("Amean", "Asd", "Pmean", "Psd"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
    assert res.mean_chi_sq == ref.mean_chi_sq and np.isfinite(res.mean_chi_sq)


@pytest.mark.parametrize("entry,mode", [("GWCoGAPS", "genome-wide"),
                                        ("scCoGAPS", "single-cell")])
def test_distributed_entry_points_stitch(modsim_golden, entry, mode):
    """GWCoGAPS and scCoGAPS (exported as cogaps_tpu/__init__.py exports
    them) return one stitched result in the input order: the free factor
    learned, the fixed one zero (scCoGAPS on the sparse model by
    default)."""
    assert entry in cogaps_tpu_torch.__all__
    D = modsim_golden["D"]
    genes = [f"g{i:03d}" for i in range(D.shape[0])]
    cells = [f"c{i:03d}" for i in range(D.shape[1])]
    params = cogaps_tpu_torch.CogapsParams(n_patterns=3, n_iterations=15,
                                           seed=3, n_sets=2)
    res = getattr(cogaps_tpu_torch, entry)(D, params, messages=False,
                                           gene_names=genes,
                                           sample_names=cells, device="cpu")
    assert res.gene_names == genes and res.sample_names == cells
    names = genes if mode == "genome-wide" else cells
    assert sorted(x for s in res.diagnostics["subsets"] for x in s) == names
    free, fixed = ((res.Amean, res.Pmean) if mode == "genome-wide"
                   else (res.Pmean, res.Amean))
    assert np.abs(free).sum() > 0 and np.abs(fixed).sum() == 0
    k_out = res.diagnostics["consensusPatterns"].shape[1]
    assert res.Amean.shape == (D.shape[0], k_out)


def test_checkpointed_run_writes_a_file(modsim_golden, tmp_path):
    out = str(tmp_path / "run.npz")
    res = cogaps_tpu_torch.CoGAPS(modsim_golden["D"], n_patterns=3,
                                  n_iterations=10, seed=1, messages=False,
                                  checkpoint_interval=4,
                                  checkpoint_out_file=out, device="cpu")
    z = np.load(out)
    assert int(z["magic"]) == 0xB123AA4D and int(z["seed"]) == 1
    assert (int(z["phase"]), int(z["iteration"])) == (1, 8)
    assert np.isfinite(res.mean_chi_sq)


def test_input_validation(modsim_golden):
    D = modsim_golden["D"]
    with pytest.raises(ValueError, match="negative"):
        cogaps_tpu_torch.CoGAPS(-D, n_patterns=3, device="cpu")
    with pytest.raises(ValueError, match="nPatterns"):
        cogaps_tpu_torch.CoGAPS(D, n_patterns=20, device="cpu")
    with pytest.raises(ValueError, match="unrecognized"):
        cogaps_tpu_torch.CoGAPS(D, n_patterns=3, device="cpu", bogus=1)
    # a missing h5ad file raises what it raises in the JAX package
    import cogaps_tpu
    missing = os.path.join(DATA, "missing.h5ad")
    with pytest.raises(Exception) as theirs:
        cogaps_tpu.CoGAPS(missing, n_patterns=3)
    with pytest.raises(theirs.type):
        cogaps_tpu_torch.CoGAPS(missing, n_patterns=3, device="cpu")
    from cogaps_tpu_torch.io.coo import CooMatrix
    r, c = np.nonzero(D)
    coo = CooMatrix(r.astype(np.int32), c.astype(np.int32), D[r, c], D.shape)
    with pytest.raises(ValueError, match="dense matrix"):
        cogaps_tpu_torch.GWCoGAPS(coo, n_patterns=3, device="cpu")


@pytest.mark.parametrize("shape,k,overrides", [
    ((25, 20), 3, {}),
    ((1363, 9), 7, {}),
    ((5000, 2000), 10, {}),
    ((120000, 2000), 7, {}),
    ((300, 80), 5, dict(batch_size_a=64, atom_capacity_p=4096,
                        which_matrix_fixed="P",
                        fixed_patterns=np.ones((80, 5)), n_snapshots=4)),
])
def test_engine_config_matches_jax(shape, k, overrides):
    mine = params.CogapsParams(n_patterns=k, n_iterations=100, **overrides)
    theirs = jparams.CogapsParams(n_patterns=k, n_iterations=100, **overrides)
    assert ([f.name for f in dataclasses.fields(mine)]
            == [f.name for f in dataclasses.fields(theirs)])
    assert (dataclasses.asdict(mine.engine_config(*shape))
            == dataclasses.asdict(theirs.engine_config(*shape)))
    assert ([f.name for f in dataclasses.fields(params.EngineConfig)]
            == [f.name for f in dataclasses.fields(jparams.EngineConfig)])


@pytest.mark.parametrize("ext", ["csv", "tsv", "mtx", "gct"])
def test_read_matrix_matches_jax(ext):
    path = os.path.join(DATA, f"GIST.{ext}")
    mine = parsers.read_matrix(path)
    theirs = jparsers.read_matrix(path)
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[1] == theirs[1] and mine[2] == theirs[2]


def test_statistics_helpers_match_jax():
    rs = np.random.default_rng(4)
    sums = [rs.gamma(2, 1, (30, 4)) for _ in range(4)]
    for n in (0, 1, 17):
        for x, y in zip(result.finalize_statistics(*sums, n),
                        jresult.finalize_statistics(*sums, n)):
            np.testing.assert_array_equal(x, y)
    A, P = rs.gamma(2, 1, (30, 4)), rs.gamma(2, 1, (12, 4))
    D = (A @ P.T + rs.normal(0, 0.1, (30, 12))).clip(0).astype(np.float32)
    S = dense.default_uncertainty(D)
    np.testing.assert_array_equal(S, jdense.default_uncertainty(D))
    assert result.mean_chi_sq(A, P, D, S) == jresult.mean_chi_sq(A, P, D, S)
    for alpha in (0.01, 0.5):
        assert (dense.compute_lambda(D, alpha, 4)
                == jdense.compute_lambda(D, alpha, 4))
    assert ([f.name for f in dataclasses.fields(result.CogapsResult)]
            == [f.name for f in dataclasses.fields(jresult.CogapsResult)])


def _functions(module):
    """name -> AST dump of each top-level function of a module's source."""
    tree = ast.parse(open(module.__file__).read())
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, ast.FunctionDef)}


def test_clustering_copy_matches_jax():
    """parallel/clustering.py is cogaps_tpu/parallel/clustering.py's code,
    function for function (only the module docstring differs)."""
    from cogaps_tpu.parallel import clustering as jclustering
    from cogaps_tpu_torch.parallel import clustering
    mine, theirs = _functions(clustering), _functions(jclustering)
    assert set(mine) == set(theirs) == {
        "complete_linkage", "cutree_k", "corcut", "corr_to_mean_pattern",
        "pattern_match"}
    for name in mine:
        assert mine[name] == theirs[name], name


@pytest.mark.parametrize("holes", [False, True], ids=["compact", "holes"])
def test_load_table_matches_jax(holes):
    """utils/atoms_compat.load_table compacts a table as the JAX
    package's does (a stable compaction of live slots)."""
    from cogaps_tpu.utils import atoms_compat as jatoms_compat
    from cogaps_tpu_torch.utils import atoms_compat
    rs = np.random.default_rng(2)
    elem = np.full(16, -1, np.int32)
    live = (rs.random(16) < 0.5) if holes else (np.arange(16) < 7)
    elem[live] = rs.integers(0, 100, int(live.sum()))
    mass = np.where(live, rs.gamma(2, 1, 16), 0).astype(np.float32)
    mine = atoms_compat.load_table(mass, elem, int(live.sum()))
    theirs = jatoms_compat.load_table(mass, elem, int(live.sum()))
    for f in ("mass", "elem", "n"):
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (mine.elem[:int(live.sum())] >= 0).all()


FORBIDDEN = ("jax", "jaxlib", "flax", "cogaps_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_sources_import_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, n) for n in (
                                        "chip_smoke.py", "kernel_times.py")]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_clean_import_loads_no_jax():
    """Importing the package and every module of it loads no jax, no
    cogaps_tpu, and none of the optional h5py, scipy or matplotlib (the
    card's machine has no h5py)."""
    code = ("import sys; import cogaps_tpu_torch; "
            "from cogaps_tpu_torch import api, engine, convert, bench_harness; "
            "from cogaps_tpu_torch import analysis, plots, datasets, __main__; "
            "from cogaps_tpu_torch.io import h5, rdata, native; "
            "from cogaps_tpu_torch.parallel import (multichain, distributed, "
            "clustering, atlas_engine); "
            "from cogaps_tpu_torch.utils import checkpoint, atoms_compat; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r))"
            % (FORBIDDEN + ("h5py", "scipy", "matplotlib"),))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    # TF32 is off for float32 matrix products (the Y tables cancel)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# ----------------------------------------------------------------------
# debug_checks: utils/debug.check_state after every phase
# ----------------------------------------------------------------------
def _ran_state(D, sparse_model):
    """A dense or sparse engine's state after a short equilibration."""
    from cogaps_tpu_torch.engine import EQUILIBRATION, GapsEngine, PhiloxRandom
    from cogaps_tpu_torch.sparse_engine import SparseGapsEngine
    cfg = params.CogapsParams(n_patterns=3, n_iterations=20).engine_config(
        *D.shape)
    eng = (SparseGapsEngine(D, cfg, "cpu") if sparse_model
           else GapsEngine(D, None, cfg, "cpu"))
    st, _ = eng.run_phase(eng.init_state(), eng.init_stats(),
                          PhiloxRandom([3], "cpu"), EQUILIBRATION)
    assert int(st.atoms_a.n[0]) > 2 and int(st.atoms_p.n[0]) > 2
    # clones the test may corrupt (the engine's own are inference tensors)
    return type(st)(*(type(x)(*(y.clone() for y in dataclasses.astuple(x)))
                      if dataclasses.is_dataclass(x) else x.clone()
                      for x in (st.atoms_a, st.atoms_p, st.M_a, st.M_p)))


@pytest.mark.parametrize("sparse_model", [False, True],
                         ids=["dense", "sparse"])
def test_debug_checks_pass_on_a_clean_run(modsim_golden, sparse_model):
    from cogaps_tpu_torch.utils.debug import check_state
    res = cogaps_tpu_torch.CoGAPS(modsim_golden["D"], n_patterns=3,
                                  n_iterations=40, seed=2, messages=False,
                                  debug_checks=True,
                                  sparse_optimization=sparse_model,
                                  device="cpu")
    assert np.isfinite(res.mean_chi_sq)
    check_state(_ran_state(modsim_golden["D"], sparse_model), 3)


def _corrupt(st, how):
    a = st.atoms_a
    n = int(a.n[0])
    if how == "negative M":
        st.M_a[0, 0, 0] = -1.0
    elif how == "not compact":  # a live atom moved past a hole
        a.elem[0, n] = a.elem[0, 0]
        a.mass[0, n] = a.mass[0, 0]
        a.elem[0, 0], a.mass[0, 0] = -1, 0.0
    elif how == "live count":
        a.n[0] = n + 1
    elif how == "mass":
        a.mass[0, 1] = 0.0
    elif how == "drift":
        e = int(a.elem[0, 0])
        st.M_a[0].view(-1)[e] += 0.5


@pytest.mark.parametrize("how,message", [
    ("negative M", "A: negative factor entries"),
    ("not compact", "A: atom table not compact"),
    ("live count", "A: live count"),
    ("mass", "A: non-positive live masses"),
    ("drift", "A: atom-mass drift 0.5"),
])
def test_check_state_raises_as_jax_does(modsim_golden, how, message):
    """A corrupted state raises AssertionError with the JAX package's
    message (cogaps_tpu/utils/debug.check_state on chain 0)."""
    from types import SimpleNamespace
    from cogaps_tpu.utils import debug as jdebug
    from cogaps_tpu_torch.utils.debug import check_state
    st = _ran_state(modsim_golden["D"], False)
    _corrupt(st, how)
    with pytest.raises(AssertionError, match=message) as port:
        check_state(st, 3)

    def one(atoms):
        return SimpleNamespace(elem=atoms.elem[0].numpy(),
                               mass=atoms.mass[0].numpy(),
                               n=atoms.n[0].numpy())

    jstate = SimpleNamespace(atoms_a=one(st.atoms_a), atoms_p=one(st.atoms_p),
                             M_a=st.M_a[0].numpy(), M_p=st.M_p[0].numpy())
    with pytest.raises(AssertionError) as jax_err:
        jdebug.check_state(jstate, 3)
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("debug_checks", [True, False])
def test_debug_checks_run_once_per_phase(modsim_golden, monkeypatch,
                                         debug_checks):
    from cogaps_tpu_torch import api
    calls = []
    monkeypatch.setattr(api, "check_state",
                        lambda state, k: calls.append((state.M_a.shape, k)))
    cogaps_tpu_torch.CoGAPS(modsim_golden["D"], n_patterns=3, n_iterations=6,
                            messages=False, debug_checks=debug_checks,
                            device="cpu")
    D = modsim_golden["D"]
    assert calls == ([((1, D.shape[0], 3), 3)] * 2 if debug_checks else [])
