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


@pytest.mark.parametrize("kwargs,match", [
    (dict(distributed="genome-wide"), "distributed"),
    (dict(sparse_optimization=True), "sparseOptimization"),
    (dict(checkpoint_interval=10), "checkpointing"),
])
def test_out_of_slice_options_raise(modsim_golden, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        cogaps_tpu_torch.CoGAPS(modsim_golden["D"], n_patterns=3,
                                n_iterations=5, messages=False, device="cpu",
                                **kwargs)


def test_input_validation(modsim_golden):
    D = modsim_golden["D"]
    with pytest.raises(ValueError, match="negative"):
        cogaps_tpu_torch.CoGAPS(-D, n_patterns=3, device="cpu")
    with pytest.raises(ValueError, match="nPatterns"):
        cogaps_tpu_torch.CoGAPS(D, n_patterns=20, device="cpu")
    with pytest.raises(ValueError, match="unrecognized"):
        cogaps_tpu_torch.CoGAPS(D, n_patterns=3, device="cpu", bogus=1)
    with pytest.raises(NotImplementedError, match="h5"):
        cogaps_tpu_torch.CoGAPS("x.h5ad", device="cpu")


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


FORBIDDEN = ("jax", "jaxlib", "flax", "cogaps_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_sources_import_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
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
    code = ("import sys; import cogaps_tpu_torch; "
            "from cogaps_tpu_torch import api, engine, convert, bench_harness; "
            "from cogaps_tpu_torch.parallel import multichain; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    # TF32 is off for float32 matrix products (the Y tables cancel)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
