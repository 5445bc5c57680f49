"""The command line (cogaps_tpu_torch/__main__.py) against cogaps_tpu's,
on the CPU.

* the parser has cogaps_tpu's arguments and defaults, and one more,
  --device (default "cuda");
* ``main([... "--device", "cpu"])`` on GIST equals CoGAPS() with the same
  parameters bit for bit, writes cogaps_tpu's files (<prefix>.npz and,
  with --csv, the four matrices and _meta.json) and prints the one-line
  JSON summary; --sparse on an mtx file and --distributed genome-wide
  on a dense csv equal their CoGAPS() and GWCoGAPS() runs;
* without --device the run is asked of the card: it never runs on the
  CPU unasked;
* ``python -m cogaps_tpu_torch --help`` runs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cogaps_tpu_torch
from cogaps_tpu import __main__ as jmain
from cogaps_tpu_torch import __main__ as cli
from cogaps_tpu_torch.io import parsers
from cogaps_tpu_torch.result import CogapsResult

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIST = os.path.join(ROOT, "data", "GIST.csv")


def _summary(out):
    return json.loads(out.strip().splitlines()[-1])


def _same(res, ref):
    for name in ("Amean", "Asd", "Pmean", "Psd"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
    assert res.mean_chi_sq == ref.mean_chi_sq
    assert res.gene_names == ref.gene_names
    assert res.sample_names == ref.sample_names


def test_parser_mirrors_jax():
    mine = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jmain.build_parser()._actions}
    assert set(mine) - set(theirs) == {"device"}
    assert mine["device"].default == "cuda"
    for dest, a in theirs.items():
        b = mine[dest]
        assert (b.option_strings, b.default, b.type, b.choices, b.nargs) == (
            a.option_strings, a.default, a.type, a.choices, a.nargs), dest


def test_cli_equals_cogaps_on_gist(tmp_path, capsys):
    prefix = str(tmp_path / "gist")
    assert cli.main([GIST, "-o", prefix, "--n-patterns", "5",
                     "--n-iterations", "20", "--seed", "7",
                     "--output-frequency", "10", "--csv", "--quiet",
                     "--device", "cpu"]) == 0
    summary = _summary(capsys.readouterr().out)
    ref = cogaps_tpu_torch.CoGAPS(GIST, n_patterns=5, n_iterations=20,
                                  seed=7, output_frequency=10,
                                  messages=False, device="cpu")
    res = CogapsResult.load(prefix + ".npz")
    _same(res, ref)
    assert res.diagnostics["device"] == "cpu"
    assert res.get_param("n_patterns") == 5
    assert summary == {
        "output": prefix + ".npz", "nPatterns": 5,
        "meanChiSq": ref.mean_chi_sq,
        "totalUpdates": ref.diagnostics["totalUpdates"],
        "totalRunningTime": res.diagnostics["totalRunningTime"]}
    back = CogapsResult.from_csv(prefix)
    _same(back, ref)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"gist{s}" for s in (".npz", "_Amean.csv", "_Asd.csv", "_Pmean.csv",
                             "_Psd.csv", "_meta.json"))


def test_cli_sparse_mtx_equals_cogaps(tmp_path, capsys):
    """--sparse on a MatrixMarket file (the card check's route, small)."""
    D, _, _ = parsers.read_matrix(GIST)
    D = D[:200]
    D[D < np.quantile(D, 0.6)] = 0.0
    path = str(tmp_path / "d.mtx")
    r, c = np.nonzero(D)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{D.shape[0]} {D.shape[1]} {len(r)}\n")
        f.writelines(f"{i + 1} {j + 1} {D[i, j]:.9g}\n"
                     for i, j in zip(r, c))
    prefix = str(tmp_path / "out")
    cli.main([path, "--sparse", "--n-patterns", "3", "--n-iterations", "20",
              "--output-frequency", "10", "-o", prefix, "--seed", "13",
              "--quiet", "--device", "cpu"])
    summary = _summary(capsys.readouterr().out)
    ref = cogaps_tpu_torch.CoGAPS(D, n_patterns=3, n_iterations=20, seed=13,
                                  output_frequency=10, messages=False,
                                  sparse_optimization=True, device="cpu")
    res = CogapsResult.load(prefix + ".npz")
    _same(res, ref)
    assert summary["totalUpdates"] == ref.diagnostics["totalUpdates"] > 0
    assert np.isfinite(summary["meanChiSq"])


def test_cli_distributed_csv_equals_gwcogaps(tmp_path, capsys):
    z = np.load(os.path.join(ROOT, "data", "modsim.npz"))
    path = str(tmp_path / "modsim.csv")
    parsers.write_csv(path, z["D"])
    prefix = str(tmp_path / "gw")
    cli.main([path, "--distributed", "genome-wide", "--n-sets", "2",
              "--n-patterns", "3", "--n-iterations", "10", "--seed", "5",
              "-o", prefix, "--csv", "--quiet", "--device", "cpu"])
    capsys.readouterr()
    ref = cogaps_tpu_torch.GWCoGAPS(
        path, cogaps_tpu_torch.CogapsParams(n_patterns=3, n_iterations=10,
                                            seed=5, n_sets=2),
        messages=False, device="cpu")
    res = CogapsResult.load(prefix + ".npz")
    _same(res, ref)
    assert len(res.get_subsets()) == 2 and len(res.diagnostics["stages"]) == 2
    _same(CogapsResult.from_csv(prefix), ref)


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the CLI passes device="cuda" to CoGAPS(): the
    run fails without a GPU rather than moving to the CPU."""
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(cogaps_tpu_torch, "CoGAPS", spy)
    with pytest.raises(RuntimeError, match="stop"):
        cli.main([GIST, "-o", str(tmp_path / "x"), "--n-iterations", "5"])
    assert seen["device"] == "cuda"
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main([GIST, "-o", str(tmp_path / "x"), "--n-iterations", "5",
                      "--quiet"])
        assert not os.path.exists(tmp_path / "x.npz")


def test_module_help_runs():
    out = subprocess.run([sys.executable, "-m", "cogaps_tpu_torch", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--sparse" in out.stdout
