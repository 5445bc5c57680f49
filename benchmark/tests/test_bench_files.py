"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric reader loads, nothing is left unnamed, and the
names, units and texts keep to the benchmark's rules."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark.tests.cells import ROOT

BENCH_DIR = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200, (key, text)
                    assert "\n" not in text and "\t" not in text
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert "bound" not in m
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_file_is_named_and_loads(bench):
    from benchmark import harness
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    on_disk = {p.stem for p in (BENCH_DIR / "workloads").glob("*.json")}
    assert on_disk == set(cells)
    # files of a configuration that has no cell yet may wait on disk
    assert ({p.stem for p in (BENCH_DIR / "configs").glob("*.json")}
            >= set(configs))
    traffics = {p.stem for p in (BENCH_DIR / "traffic").glob("*.json")}
    assert traffics >= {w["traffic"] for w in cells.values()}
    for name, w in cells.items():
        cell = harness.load_cell(name)
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["why"] == w["why"]
        assert cell["burn_in"] > 0
        # chi^2's limit where the window has history entries to compare
        history = cell["traffic_spec"]["output_frequency"] > 0
        assert set(cell["limits"]) == ({"fit_share", "stats_gap",
                                        "atoms_gap_a", "atoms_gap_p",
                                        "tables_gap"}
                                       | ({"chisq_gap"} if history
                                          else set()))
        conf = configs[w["config"]]
        assert (ROOT / conf["file"]).is_file()
        assert json.loads((ROOT / conf["file"]).read_text())["reduced"] \
            == conf["reduced"] == cell["reduced"]
    readers = {p.stem for p in (BENCH_DIR / "metrics").glob("*.py")} - {
        "__init__"}
    metrics = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert readers >= metrics
    for m in metrics:
        assert callable(importlib.import_module(
            f"benchmark.metrics.{m}").read)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_cell_reports(bench, kind):
    from benchmark import harness
    for w in bench["workloads"]:
        got = {m["name"] for m in harness.cell_metrics(bench, w["name"],
                                                       kind)}
        if kind == "end_to_end":
            assert {"setup_s", "updates_per_s", "iter_ms"} <= got
        else:
            assert got
    for m in bench["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in bench["workloads"]}
