"""One traced run of a benchmark cell, as `run.py --trace 1` makes it,
with the program's own spans (cogaps_tpu_torch/utils/trace.py) beside
it:

    python3 benchmark/spans_report.py --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout, on a card. The tracer records from the
run's start to its window (set-up: imports past this script's, data,
engine, the kernel libraries' loads, burn-in) and is off in the window;
the traced stretch's spans are read from the profile, whose host events
they are while it records. Standard error gets run.py's lines and
`program spans: {"setup"|"traced": {name: [count, total ms]}}`; standard
output run.py's result line, then one JSON object: kernel_build_s (the
set-up's build.load spans, seconds, None where it loaded none), their
count and how many compiled, the spans' counts and totals, idle_by_span
(the traced stretch's idle gaps by the innermost program span over each,
seconds) and self_idle_share (the share of the idle time inside program
spans that falls to run_phase's or run_span's own time, outside their
child spans).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402  (the caches' paths)


def totals(named) -> dict:
    """{name: [count, total ms]} of (name, duration_ns) pairs."""
    out = {}
    for name, dur in named:
        c = out.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += dur * 1e-6
    return out


def report_run(bench: dict, name: str, seed: int, seconds: float, device,
               t_start: float, cell: dict = None) -> tuple:
    """(run.py's result, the span report) of one traced run of `name`:
    the tracer on from here to the window, the profile's host events
    read for the traced stretch."""
    from cogaps_tpu_torch.utils import trace

    from benchmark import harness, spans
    got = {}
    real_window, real_events = harness.run_window, harness.trace_events

    def run_window(s, secs, traced):
        got["setup"] = trace.stop()
        return real_window(s, secs, traced)

    def trace_events(prof):
        got["trace"] = real_events(prof)
        return got["trace"]

    harness.run_window, harness.trace_events = run_window, trace_events
    trace.start()
    try:
        result = harness.run_cell(bench, name, seed, seconds, True, device,
                                  t_start, cell=cell)
    finally:
        harness.run_window, harness.trace_events = real_window, real_events
        if trace.on():
            trace.stop()
    dev, host = got["trace"]
    tr = {"device": dev, "host": host}
    setup = got["setup"]
    loads = [s for s in setup if s.name == "build.load"]
    by_span = spans.idle_by_span(tr, top=None)
    inside = sum(t for n, t in by_span if n != spans.OUTSIDE)
    own = sum(t for n, t in by_span if n in ("run_phase", "run_span"))
    rep = {"kernel_build_s": (sum(s.end_ns - s.start_ns for s in loads)
                              * 1e-9 if loads else None),
           "kernel_loads": len(loads),
           "kernel_builds": sum(s.counts.get("compiled", 0) for s in loads),
           "program_spans": {
               "setup": totals((s.name, s.end_ns - s.start_ns)
                               for s in setup),
               "traced": totals((n, d) for n, _, d in host
                                if n in spans.PROGRAM_SPANS)},
           "idle_by_span": by_span[:10],
           "self_idle_share": own / inside if inside else None}
    return result, rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        sys.exit(f"no cell {args.workload!r} in BENCHMARK.json")
    run.require_cards(int(cells[args.workload]["chips"]))

    import torch

    from benchmark import harness
    result, rep = report_run(bench, args.workload, run.norm_seed(args.seed),
                             args.seconds, torch.device("cuda"), T_START)
    print("program spans: " + json.dumps(rep["program_spans"]),
          file=sys.stderr)
    harness.report(result)
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
