"""The port's tracer (utils/trace.py) on the CPU: off, it records nothing
and reads no clock; on, its records nest and keep their counts, on the
clock of torch.profiler's events; the fused route's spans cover
run_phase and its run_span launches; and a run's bits do not depend on
whether the tracer is on."""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cogaps_tpu_torch import engine
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import multichain
from cogaps_tpu_torch.utils import trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off."""
    assert not trace.on()
    yield
    if trace.on():
        trace.stop()
        pytest.fail("a test left the tracer on")


class NoClock:
    """A stand-in for the time module whose clocks must not be read."""

    def time_ns(self):
        raise AssertionError("the tracer read a clock while off")


def test_off_is_one_shared_object_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(trace, "time", NoClock())
    first = trace.span("run_phase", phase=1)
    with first as sp:
        sp.add(blocks=1)
        with trace.span("span.launch") as inner:
            assert inner is first
    assert trace.span("other") is first
    assert not trace.on()


def test_on_records_parents_and_counts():
    with trace.recording() as spans:
        with trace.span("outer", phase=2) as outer:
            with trace.span("a", iterations=50):
                with trace.span("a.inner") as sp:
                    sp.add(blocks=1)
            with trace.span("b"):
                pass
            outer.add(route=1)
        with trace.span("next"):
            pass
    assert [(s.name, s.parent) for s in spans] == [
        ("outer", None), ("a", 0), ("a.inner", 1), ("b", 0), ("next", None)]
    assert [s.counts for s in spans] == [
        {"phase": 2, "route": 1}, {"iterations": 50}, {"blocks": 1}, {}, {}]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert spans[3].start_ns >= spans[1].end_ns
    assert not trace.on()


def test_recording_stops_on_an_exception():
    with pytest.raises(KeyError):
        with trace.recording() as spans:
            with trace.span("outer"):
                with trace.span("inner"):
                    raise KeyError("step")
    assert not trace.on()
    assert [(s.name, s.parent) for s in spans] == [("outer", None),
                                                    ("inner", 0)]
    assert all(s.end_ns >= s.start_ns for s in spans)
    with trace.recording() as again:
        with trace.span("fresh"):
            pass
    assert [(s.name, s.parent) for s in again] == [("fresh", None)]


@pytest.mark.parametrize("misuse", ["start twice", "stop while off"])
def test_misuse_raises(misuse):
    if misuse == "start twice":
        trace.start()
        try:
            with pytest.raises(RuntimeError, match="already on"):
                trace.start()
        finally:
            trace.stop()
    else:
        with pytest.raises(RuntimeError, match="off"):
            trace.stop()


def test_stop_ends_an_open_span():
    trace.start()
    with trace.span("open"):
        spans = trace.stop()
    assert [s.name for s in spans] == ["open"]
    assert spans[0].end_ns >= spans[0].start_ns


def kineto_host_events(prof) -> list:
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_clock_is_the_profilers():
    """A span around a torch.add brackets the add's kineto event to
    within 100 microseconds at each end."""
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.add(x, x)  # the profiler's first events cost more
        with trace.recording() as spans:
            with trace.span("add"):
                torch.add(x, x)
    adds = [e for e in kineto_host_events(prof) if e[0] == "aten::add"]
    _, start, dur = max(adds, key=lambda e: e[1])
    (sp,) = spans
    assert 0 <= start - sp.start_ns <= 100_000
    assert 0 <= sp.end_ns - (start + dur) <= 100_000
    # the clock is Unix time: within a minute of the host's
    assert abs(sp.start_ns - time.time_ns()) < 60e9


@pytest.mark.parametrize("tracer_on", [False, True])
def test_spans_are_profile_events_while_profiling(tracer_on):
    """While torch.profiler records, a span is a host event of the
    profile under its name, whether or not the tracer is on; the tracer's
    own records are there only when it is on."""
    x = torch.ones(16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if tracer_on:
            trace.start()
        with trace.span("run_phase", phase=2):
            with trace.span("run_span"):
                torch.mul(x, 2)
        spans = trace.stop() if tracer_on else []
    names = [e[0] for e in kineto_host_events(prof)]
    assert names.count("run_phase") == names.count("run_span") == 1
    assert [s.name for s in spans] == (["run_phase", "run_span"]
                                       if tracer_on else [])
    # and once the profile ends, spans are the shared no-op again
    assert trace.span("run_phase") is trace.span("run_span")


def fused_engine(n_iterations=120, chains=2, seed=5):
    rs = np.random.default_rng(seed)
    Ds = [rs.gamma(2.0, 2.0, (30, 12)).astype(np.float32)
          for _ in range(chains)]
    params = CogapsParams(n_patterns=3, n_iterations=n_iterations,
                          output_frequency=0, seed=seed)
    cfg = params.engine_config(30, 12)
    eng = multichain.MultichainEngine(
        multichain.stack_device_data(Ds, None, cfg, "cpu"), cfg, "cpu")
    assert eng._fused_ok()
    return eng, engine.PhiloxRandom([seed] * chains, "cpu")


def test_fused_route_spans():
    """One run_phase span over the phase, and under it one run_span a
    launch of at most span_cuda.CHUNK iterations, summing to the
    phase's."""
    eng, rand = fused_engine()
    st, ss = eng.init_state(), eng.init_stats()
    with trace.recording() as spans:
        eng.run_phase(st, ss, rand, engine.EQUILIBRATION, 10, 120)
    top = [s for s in spans if s.parent is None]
    assert [(s.name, s.counts) for s in top] == [
        ("run_phase", {"phase": engine.EQUILIBRATION, "iterations": 110,
                       "route": 1})]
    kids = spans[1:]
    assert [s.name for s in kids] == ["run_span"] * 3
    assert all(s.parent == 0 for s in kids)
    assert [s.counts for s in kids] == [
        {"iterations": n, "chains": 2} for n in (50, 50, 10)]


def leaves(x) -> list:
    """The tensors of a state or statistics dataclass, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in dataclasses.fields(x)
            for t in leaves(getattr(x, f.name))]


def test_bits_do_not_depend_on_the_tracer():
    """The same iterations from the same state and seed give equal state
    and statistics with the tracer on and off."""
    out = []
    for tracer_on in (False, True, False):
        eng, rand = fused_engine(n_iterations=80)
        st, ss = eng.init_state(), eng.init_stats()
        if tracer_on:
            trace.start()
        try:
            for phase in (engine.EQUILIBRATION, engine.SAMPLING):
                st, ss = eng.run_phase(st, ss, rand, phase)
        finally:
            spans = trace.stop() if tracer_on else None
        assert (spans is not None) == tracer_on
        out.append((st, ss))
    flat = [leaves(st) + leaves(ss) for st, ss in out]
    assert int(out[0][1].upd.sum()) > 0
    for other in flat[1:]:
        assert len(other) == len(flat[0])
        for a, b in zip(flat[0], other):
            assert torch.equal(a, b)
