"""The program's spans as the benchmark reads them: the readers of
launch_wait_ms_per_iter and span_host_ms on hand-made profiles, the
labels of spans.idle_by_span, and small CPU runs of the cell: run.py's
path never turns the tracer on and finds the spans in the profile of the
traced chunks alone; spans_report.py records set-up with the tracer and
leaves it off in the window."""

from __future__ import annotations

import importlib
import time

import pytest

from benchmark import harness, spans, spans_report
from benchmark.tests.cells import WINDOW_S, small_cell

MS = 1_000_000  # ns
SPAN = ("void (anonymous namespace)::span_kernel(SpanArgs, cogaps::SweepArgs,"
        " cogaps::SweepArgs)")
CELL = "gwcogaps-bulk-20k.fused"
SEED = 2**33 + 17


def read(name, ctx):
    return importlib.import_module(f"benchmark.metrics.{name}").read(ctx)


def ctx_of(device, host, iterations=100):
    return {"trace": {"device": device, "host": host, "wall_s": 0.1,
                      "iterations": iterations}}


# two chunks of a 100-iteration stretch. Chunk 1: run_phase at 0 ms, a
# Philox op 2-3 ms, K3 from 5 ms: 4 ms idle before it. Chunk 2: run_phase
# at 30 ms while the copy of 29-31 ms runs, K3 from 33 ms: 2 ms idle.
DEVICE = [("philox", 2 * MS, MS), (SPAN, 5 * MS, 20 * MS),
          ("Memcpy DtoH", 29 * MS, 2 * MS), (SPAN, 33 * MS, 20 * MS),
          (SPAN, 53 * MS, 20 * MS)]
HOST = [("run_phase", 0, 6 * MS), ("run_span", 0, 6 * MS),
        ("span.prepare", 0, 3 * MS), ("span.shape", 1 * MS, MS),
        ("span.normals", 3 * MS, 1 * MS), ("span.launch", 4 * MS, 2 * MS),
        ("aten::add", 3 * MS, MS // 2),
        ("run_phase", 30 * MS, 5 * MS), ("run_span", 30 * MS, 2 * MS),
        ("run_span", 32 * MS, 3 * MS)]


def test_launch_wait_reader():
    # (4 + 2) ms idle over 100 iterations
    assert read("launch_wait_ms_per_iter",
                ctx_of(DEVICE, HOST)) == pytest.approx(0.06)
    # a run_phase with no K3 after it adds nothing
    late = HOST + [("run_phase", 80 * MS, MS)]
    assert read("launch_wait_ms_per_iter",
                ctx_of(DEVICE, late)) == pytest.approx(0.06)


def test_span_host_reader():
    # run_span spans of 6, 2 and 3 ms
    assert read("span_host_ms", ctx_of(DEVICE, HOST)) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["launch_wait_ms_per_iter",
                                  "span_host_ms"])
@pytest.mark.parametrize("case", ["no trace", "no device events",
                                  "no program spans"])
def test_nothing_to_read(name, case):
    """None where the run traced nothing, and in a profile of a program
    without the spans (the host events of PyTorch's operations alone)."""
    ctx = {"no trace": {"trace": None},
           "no device events": ctx_of([], HOST),
           "no program spans": ctx_of(DEVICE, [("aten::add", 0, MS)])}[case]
    assert read(name, ctx) is None


def test_launch_wait_needs_a_span_kernel():
    no_k3 = [e for e in DEVICE if e[0] != SPAN]
    assert read("launch_wait_ms_per_iter", ctx_of(no_k3, HOST)) is None


def test_idle_by_span_labels():
    """Each gap by the innermost program span over its middle; PyTorch's
    events are no label; a gap outside every span is OUTSIDE."""
    dev = [("k", 0, MS), ("k", 2 * MS, MS), ("k", 5 * MS, MS),
           ("k", 8 * MS, MS), ("k", 12 * MS, MS)]
    host = [("run_phase", 0, 7 * MS), ("span.prepare", MS, 1 * MS),
            ("aten::mul", MS, MS), ("run_span", 3 * MS, 3 * MS),
            ("span.launch", 3 * MS, MS // 2), ("run_phase", 9 * MS, 4 * MS)]
    # gaps: 1-2 ms (prepare, inside run_phase), 3-5 ms (middle 4 ms:
    # run_span, the launch ended at 3.5), 6-8 ms (middle 7: run_phase's
    # end), 9-12 ms (the second run_phase)
    got = spans.idle_by_span(ctx_of(dev, host)["trace"])
    assert got == [["run_phase", 3e-3 + 2e-3], ["run_span", 2e-3],
                   ["span.prepare", 1e-3]]
    outside = spans.idle_by_span(ctx_of(dev, host[1:3])["trace"], top=None)
    assert outside == [[spans.OUTSIDE, 7e-3], ["span.prepare", 1e-3]]
    assert spans.idle_by_span(ctx_of(dev, host)["trace"], top=1) == [
        ["run_phase", 5e-3]]


@pytest.fixture
def watched(monkeypatch):
    """The small cell's traced events, and the tracer's start refused:
    run.py's path must not turn it on."""
    from cogaps_tpu_torch.utils import trace
    got = []
    real = harness.trace_events

    def trace_events(prof):
        got.append(real(prof))
        return got[-1]

    def refused():
        raise AssertionError("the harness turned the tracer on")

    monkeypatch.setattr(harness, "trace_events", trace_events)
    monkeypatch.setattr(trace, "start", refused)
    return got


@pytest.mark.parametrize("traced", [False, True])
def test_harness_run_reads_spans_of_the_profile_alone(bench, watched,
                                                      traced):
    cell = small_cell(CELL)
    r = harness.run_cell(bench, CELL, SEED, WINDOW_S, traced, "cpu",
                         time.perf_counter(), cell=cell)
    assert r["correct"], r["checks"]
    if not traced:
        assert watched == []
        assert "span_host_ms" not in r["metrics"]
        return
    ((dev, host),) = watched
    names = [n for n, _, _ in host]
    chunk = cell["traffic_spec"]["chunk_iters"]
    # one run_phase a traced chunk, one run_span a launch of 20
    assert names.count("run_phase") == cell["traffic_spec"]["trace_chunks"]
    assert names.count("run_span") == names.count("run_phase") * (
        -(-chunk // 50))
    phases = spans.host_spans({"host": host}, "run_phase")
    assert all(any(lo <= s and e <= hi for lo, hi in phases)
               for s, e in spans.host_spans({"host": host}, "run_span"))
    # a CPU profile has no device events, so the readers find nothing
    assert dev == []
    assert not {"span_host_ms", "launch_wait_ms_per_iter"} & set(
        r["metrics"])


def test_report_records_setup_and_not_the_window(bench):
    from cogaps_tpu_torch.utils import trace
    cell = small_cell(CELL)
    result, rep = spans_report.report_run(bench, CELL, SEED, WINDOW_S, "cpu",
                                          time.perf_counter(), cell=cell)
    assert result["correct"], result["checks"]
    assert not trace.on()
    setup = rep["program_spans"]["setup"]
    # burn-in and the warm sampling iterations: the set-up's run_phases
    assert setup["run_phase"][0] == 2
    assert setup["run_span"][0] == (-(-cell["burn_in"] // 50)
                                    + -(-harness.WARM_ITERS // 50))
    traced = rep["program_spans"]["traced"]
    assert traced["run_phase"][0] == cell["traffic_spec"]["trace_chunks"]
    # the CPU loads no kernel library
    assert rep["kernel_build_s"] is None and rep["kernel_loads"] == 0
