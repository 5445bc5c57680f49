"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names: cogaps_tpu_torch is the port, cogaps_tpu is not),
and a run without a card exits with an error and no result."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.cells import ROOT

SMALL_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness, run
from benchmark.tests.cells import WINDOW_S, small_cell
bench = json.load(open({bench!r}))
for name in ("gwcogaps-bulk-20k.fused",):
    r = harness.run_cell(bench, name, 12345, WINDOW_S, False, "cpu",
                         time.perf_counter(), cell=small_cell(name))
    assert r["correct"], r["checks"]
print(json.dumps({{"forbidden": run.forbidden_modules(),
                  "port": "cogaps_tpu_torch" in sys.modules}}))
"""


def test_small_run_loads_no_jax():
    code = SMALL_RUN.format(root=str(ROOT),
                            bench=str(ROOT / "BENCHMARK.json"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cogaps_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cogaps_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["cogaps_tpu", "jax"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gwcogaps-bulk-20k.fused", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
