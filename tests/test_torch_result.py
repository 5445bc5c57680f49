"""CogapsResult's files and getters (cogaps_tpu_torch/result.py) against
the JAX package's (cogaps_tpu/result.py), on the CPU.

* the npz (save/load) and CSV (to_csv/from_csv) files are
  interchangeable both ways: the port loads what cogaps_tpu writes and
  cogaps_tpu loads what the port writes, to the same arrays (npz: bit for
  bit; CSV: the %.10g text holds a float32 exactly), names, meanChiSq and
  diagnostics; for equal results the two packages write the same bytes;
* a distributed result's stages, subsets and pattern lists survive both
  files as numbers and strings, nothing through _jsonable's repr branch;
* get_param on a loaded result rebuilds the CogapsParams (cogaps_tpu's
  raises AttributeError there: the fault is not carried over)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import cogaps_tpu_torch
from cogaps_tpu import params as jparams
from cogaps_tpu import result as jresult
from cogaps_tpu_torch import params, result

FILES = ("_Amean.csv", "_Asd.csv", "_Pmean.csv", "_Psd.csv", "_meta.json")


@pytest.fixture(scope="module")
def modsim():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return np.load(os.path.join(root, "data", "modsim.npz"))["D"]


@pytest.fixture(scope="module")
def runs(modsim):
    """A single sparse run (with PUMP and snapshots) and a genome-wide
    distributed run of the port, on modsim."""
    single = cogaps_tpu_torch.CoGAPS(
        modsim, n_patterns=3, n_iterations=20, seed=4, messages=False,
        sparse_optimization=True, take_pump_samples=True, n_snapshots=2,
        output_frequency=10, device="cpu")
    dist = cogaps_tpu_torch.GWCoGAPS(
        modsim, params.CogapsParams(n_patterns=3, n_iterations=10, seed=4,
                                    n_sets=2), messages=False, device="cpu")
    return {"single": single, "distributed": dist}


def _pair(seed=0):
    """A cogaps_tpu and a cogaps_tpu_torch CogapsResult of the same seeded
    arrays, names and diagnostics (each package's own CogapsParams)."""
    rs = np.random.default_rng(seed)
    arrays = {n: rs.gamma(2.0, 1.0, s).astype(np.float32)
              for n, s in (("Amean", (30, 4)), ("Asd", (30, 4)),
                           ("Pmean", (12, 4)), ("Psd", (12, 4)))}
    common = dict(mean_chi_sq=float(rs.random() * 1e3),
                  gene_names=[f"g{i}" for i in range(30)],
                  sample_names=[f"s{j}" for j in range(12)],
                  pattern_names=[f"Pattern_{k + 1}" for k in range(4)])

    hist = rs.random(6).astype(np.float32)

    def diag(p):
        return {"chisqHistory": hist, "totalUpdates": np.int64(12345),
                "seed": 7, "acceptanceRates": {"A": {"birth": 0.5}},
                "nested": [np.float32(0.25), (1, 2)], "params": p}

    kw = dict(n_patterns=4, n_iterations=100, seed=7, n_sets=3)
    theirs = jresult.CogapsResult(**arrays, **common,
                                  diagnostics=diag(jparams.CogapsParams(**kw)))
    mine = result.CogapsResult(**arrays, **common,
                               diagnostics=diag(params.CogapsParams(**kw)))
    return mine, theirs


def _same_result(a, b):
    for n in ("Amean", "Asd", "Pmean", "Psd"):
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert a.mean_chi_sq == b.mean_chi_sq
    assert (a.gene_names, a.sample_names, a.pattern_names) == (
        b.gene_names, b.sample_names, b.pattern_names)
    assert a.diagnostics == b.diagnostics


def test_equal_results_write_equal_files(tmp_path):
    mine, theirs = _pair()
    mine.to_csv(str(tmp_path / "mine"))
    theirs.to_csv(str(tmp_path / "theirs"))
    for suffix in FILES:
        assert ((tmp_path / f"mine{suffix}").read_bytes()
                == (tmp_path / f"theirs{suffix}").read_bytes()), suffix
    mine.save(str(tmp_path / "mine.npz"))
    theirs.save(str(tmp_path / "theirs.npz"))
    a, b = (np.load(tmp_path / f"{w}.npz", allow_pickle=True)
            for w in ("mine", "theirs"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("fmt", ["npz", "csv"])
def test_files_load_across_packages(tmp_path, fmt):
    mine, theirs = _pair(1)
    if fmt == "npz":
        mine.save(str(tmp_path / "mine.npz"))
        theirs.save(str(tmp_path / "theirs.npz"))
        load_m, load_j = result.CogapsResult.load, jresult.CogapsResult.load
        files = (str(tmp_path / "mine.npz"), str(tmp_path / "theirs.npz"))
    else:
        mine.to_csv(str(tmp_path / "mine"))
        theirs.to_csv(str(tmp_path / "theirs"))
        load_m = result.CogapsResult.from_csv
        load_j = jresult.CogapsResult.from_csv
        files = (str(tmp_path / "mine"), str(tmp_path / "theirs"))
    port_of_jax, jax_of_port = load_m(files[1]), load_j(files[0])
    assert isinstance(port_of_jax, result.CogapsResult)
    _same_result(port_of_jax, jax_of_port)
    _same_result(port_of_jax, load_m(files[0]))
    # the arrays are the written ones, bit for bit
    for n in ("Amean", "Psd"):
        np.testing.assert_array_equal(getattr(port_of_jax, n),
                                      getattr(mine, n))
    d = port_of_jax.diagnostics
    assert d["totalUpdates"] == 12345 and d["nested"] == [0.25, [1, 2]]
    assert d["params"]["n_patterns"] == 4 and d["params"]["n_sets"] == 3


@pytest.mark.parametrize("kind", ["single", "distributed"])
def test_port_runs_round_trip(tmp_path, runs, kind):
    res = runs[kind]
    res.save(str(tmp_path / "r.npz"))
    res.to_csv(str(tmp_path / "r"))
    want = json.loads(json.dumps(result._jsonable(res.diagnostics)))
    for back in (result.CogapsResult.load(str(tmp_path / "r.npz")),
                 jresult.CogapsResult.load(str(tmp_path / "r.npz"))):
        for n in ("Amean", "Asd", "Pmean", "Psd"):
            np.testing.assert_array_equal(getattr(back, n), getattr(res, n))
        assert back.mean_chi_sq == res.mean_chi_sq
        assert back.gene_names == res.gene_names
        assert back.diagnostics == want
    for back in (result.CogapsResult.from_csv(str(tmp_path / "r")),
                 jresult.CogapsResult.from_csv(str(tmp_path / "r"))):
        for n in ("Amean", "Asd", "Pmean", "Psd"):
            np.testing.assert_array_equal(getattr(back, n), getattr(res, n))
        assert back.mean_chi_sq == res.mean_chi_sq
        assert back.diagnostics == want
    if kind == "distributed":
        stages = want["stages"]
        assert len(stages) == 2 and all(
            isinstance(s["seconds"], float) and isinstance(s["updates"], int)
            and set(s["launches"]) == {"sweep", "span", "atlas"}
            for s in stages)
        back = result.CogapsResult.load(str(tmp_path / "r.npz"))
        jback = jresult.CogapsResult.load(str(tmp_path / "r.npz"))
        assert back.get_subsets() == jback.get_subsets() == [
            list(s) for s in res.get_subsets()]
        for getter in ("get_unmatched_patterns", "get_clustered_patterns",
                       "get_correlation_to_mean_pattern"):
            got = getattr(back, getter)()
            assert got == getattr(jback, getter)() and got is not None
            np.testing.assert_array_equal(
                np.asarray(got[0], np.float64),
                np.asarray(getattr(res, getter)()[0], np.float64))


def _reprs(obj, path=()):
    """Paths of the leaves _jsonable would write as their repr."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in _reprs(v, path + (k,))]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj) for p in _reprs(v, path + (i,))]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _reprs(dataclasses.asdict(obj), path)
    if obj is None or isinstance(obj, (bool, int, float, str, np.ndarray,
                                       np.integer, np.floating,
                                       torch.Tensor)):
        return []
    return [path]


@pytest.mark.parametrize("kind", ["single", "distributed"])
def test_no_diagnostic_falls_to_repr(runs, kind):
    assert _reprs(runs[kind].diagnostics) == []


def test_jsonable_takes_tensors_and_params():
    p = params.CogapsParams(n_patterns=5, fixed_patterns=np.ones((2, 5)))
    out = result._jsonable({
        "t": torch.arange(4, dtype=torch.float32).reshape(2, 2),
        "i": torch.tensor(3), "n": np.float32(1.5), "k": np.int32(2),
        "tup": (np.arange(2), None, True), "params": p, "obj": object})
    assert out["t"] == [[0.0, 1.0], [2.0, 3.0]] and out["i"] == 3
    assert out["n"] == 1.5 and out["k"] == 2 and out["tup"] == [[0, 1], None,
                                                                True]
    assert out["params"]["n_patterns"] == 5
    assert out["params"]["fixed_patterns"] == [[1.0] * 5] * 2
    assert out["obj"] == repr(object)
    json.dumps(out)
    theirs = jresult._jsonable({"params": jparams.CogapsParams(
        n_patterns=5, fixed_patterns=np.ones((2, 5)))})
    assert theirs["params"] == out["params"]


def test_loaded_result_answers_get_param(tmp_path, runs):
    """cogaps_tpu's load().get_param calls get_param on the loaded dict
    and raises AttributeError (cogaps_tpu/result.py:101-105, 165); the
    port rebuilds the CogapsParams."""
    res = runs["single"]
    assert res.get_param("n_patterns") == 3
    res.save(str(tmp_path / "r.npz"))
    res.to_csv(str(tmp_path / "r"))
    for back in (result.CogapsResult.load(str(tmp_path / "r.npz")),
                 result.CogapsResult.from_csv(str(tmp_path / "r"))):
        assert back.get_param("n_patterns") == 3
        assert back.get_param("nIterations") == 20
        assert back.get_param("sparseOptimization") is True
        assert back.get_param("seed") == 4
        assert isinstance(back.get_original_parameters(), dict)
    with pytest.raises(AttributeError, match="get_param"):
        jresult.CogapsResult.load(str(tmp_path / "r.npz")).get_param(
            "n_patterns")
    with pytest.raises(ValueError, match="parameters"):
        runs["distributed"].get_param("n_patterns")


def test_getters(runs):
    res = runs["single"]
    assert res.get_mean_chi_sq() == res.mean_chi_sq
    assert res.get_version() == cogaps_tpu_torch.__version__
    assert res.get_original_parameters() is res.diagnostics["params"]
    assert res.get_subsets() is None and res.get_unmatched_patterns() is None
    dist = runs["distributed"]
    assert len(dist.get_subsets()) == 2
    assert len(dist.get_unmatched_patterns()) == 2
    assert dist.get_clustered_patterns() is dist.diagnostics[
        "clusteredPatterns"]
    assert len(dist.get_correlation_to_mean_pattern()) == len(
        dist.get_clustered_patterns())
