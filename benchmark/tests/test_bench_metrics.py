"""Each metric reader on a hand-made run and a hand-made profiler event
list: the numbers it should give, and nothing where there is nothing to
read."""

from __future__ import annotations

import importlib

import pytest

from benchmark import harness

MS = 1_000_000  # ns

SPAN = ("void (anonymous namespace)::span_kernel(SpanArgs, cogaps::SweepArgs,"
        " cogaps::SweepArgs)")
SWEEP = "void (anonymous namespace)::sweep_kernel<256>(SweepArgs, float*)"


def read(name, ctx):
    return importlib.import_module(f"benchmark.metrics.{name}").read(ctx)


def trace_ctx(device, wall_s=0.01, iterations=2):
    """A run whose traced stretch of `iterations` took `wall_s`, and whose
    untraced 8 iterations took 0.08 s."""
    return {"window_s": wall_s + 0.08, "iterations": iterations + 8,
            "trace": {"device": device, "host": [], "wall_s": wall_s,
                      "iterations": iterations},
            "shapes": {"chains": 4, "genes": 5000, "samples": 100, "k": 10,
                       "nnz": 1_000_000}}


# two iterations: a span launch for each, a sweep (no part of the span's
# time) and a copy; the device busy 8.5 of 10 ms
EVENTS = [(SPAN, 0 * MS, 3 * MS), ("Memcpy DtoD (Device -> Device)",
                                   3 * MS, MS // 2),
          (SWEEP, 4 * MS, 1 * MS), (SPAN, 6 * MS, 4 * MS)]


def test_end_to_end_readers():
    ctx = {"setup_s": 12.5, "window_s": 10.0, "iterations": 5000,
           "updates": 600_000_000}
    assert read("setup_s", ctx) == 12.5
    assert read("iter_ms", ctx) == pytest.approx(2.0)
    assert read("updates_per_s", ctx) == pytest.approx(60e6)
    assert read("iter_ms", dict(ctx, iterations=0)) is None


def test_trace_readers():
    ctx = trace_ctx(EVENTS)
    assert read("device_ops_per_iter", ctx) == 2.0
    # busy 8.5 ms of the stretch's 10 ms
    assert read("device_idle_share", ctx) == pytest.approx(1 - 8.5 / 10)
    assert read("span_ms_per_iter", ctx) == pytest.approx(3.5)
    assert read("span_ms_per_iter", trace_ctx(EVENTS[1:3])) is None


def test_median_chunk_leaves_out_traced_chunks():
    chunks = [(250, 0.5, False), (250, 0.25, False), (250, 2.0, True),
              (250, 0.3, False), (0, 0.0, False)]
    # 2.0, 1.0 and 1.2 ms an iteration untraced
    assert read("iter_ms_p50", {"chunks": chunks}) == pytest.approx(1.2)
    assert read("iter_ms_p50", {"chunks": [(250, 1.0, True)]}) is None


@pytest.mark.parametrize("name", ["device_ops_per_iter", "device_idle_share",
                                  "iter_ms_p50", "span_ms_per_iter"])
def test_nothing_to_read(name):
    assert read(name, {"trace": None}) is None
    assert read(name, trace_ctx([])) is None


def test_kernel_names_do_not_mix():
    from benchmark.metrics import SPAN as SP
    import re
    assert re.search(SP, SPAN)
    others = [SWEEP, "rebuild_kernel(RebuildArgs)", "mma_kernel<10>(MmaArgs)",
              "lanes_kernel<10>(Args)", "spanning_kernel(Args)"]
    assert not any(re.search(SP, n) for n in others)


def test_breakdown_labels_gaps_by_host():
    dev = [("k1", 0, 10), ("k2", 20, 10), ("k1", 50, 10)]
    host = [("outer", 0, 100), ("aten::copy_", 12, 6),
            ("cudaStreamSynchronize", 30, 25)]
    b = harness.breakdown({"device": dev, "host": host})
    assert b["device_ops"] == [["k1", 20e-9], ["k2", 10e-9]]
    assert b["idle_gaps"] == [["cudaStreamSynchronize", 20e-9],
                              ["aten::copy_", 10e-9]]
