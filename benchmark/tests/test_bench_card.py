"""On a CUDA card: each cell's run through run.py, plain and traced, is
correct and reports its metrics, and the control at the cell's own size
fails its limits. Skips without a card; run on the card with
`python -m pytest --noconftest benchmark/tests/test_bench_card.py -q`
or as part of `python -m pytest benchmark/tests -q`."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark.tests.cells import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name, trace):
    card()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483653", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]}
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name):
    card()
    import torch

    from benchmark import harness, reference
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    r = harness.run_cell(bench, name, 2147483659, 3.0, False,
                         torch.device("cuda"), time.perf_counter(),
                         control=True)
    assert r["correct"], r["checks"]
    limits = harness.load_cell(name)["limits"]
    # the control stands in for the gaps of arithmetic alone (chi^2's
    # where the window has history entries)
    arith = {"atoms_gap_a", "atoms_gap_p", "tables_gap"}
    assert arith <= set(r["control"]) <= arith | {"chisq_gap"}
    assert not reference.verdict(
        r["control"], {n: limits[n] for n in r["control"]})[0]
