"""Where an iteration of the dense engine spends its time on a CUDA card.

Run from the root of a checkout: ``python -m cogaps_tpu_torch.profile_iter
[--gate]``; --gate runs both routes at GATE_CONFIGS instead, the shapes
that set the fused route's gate (parallel/multichain.py).

For each configuration and route -- per-call (an iteration is ~80
separate device operations, ChainEngine.run_phase), per-call with the
fused span's table rule (float64 sums rounded once,
models/dense.exact_tables), or fused (spans of whole iterations in one
launch of the fused-span kernel, MultichainEngine.run_spans, also where
the engine's gate would refuse it: those rows are the gate's
measurement) -- it runs the
equilibration phase from empty atom tables, so the tables have grown to
their working size, copies the state, and then runs the same window of
sampling iterations twice from that copy:

1. unprofiled, on the host clock from a synchronize to a synchronize:
   wall ms per iteration;
2. under torch.profiler with CUDA activity: the device's busy time (the
   union of the intervals of its kernels, copies and sets), split by
   class (sweep kernel, span kernel, tables kernel, matmuls, copies,
   other kernels).

Both runs start from the same state with the same random streams, so the
device does the same work in each (the update counts are printed side by
side). busy share = device busy time of the window / unprofiled wall time
of the same window; the profiled run's own wall time and share are printed
too. One JSON line per configuration.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bench_harness import synthetic_dense
from .engine import (EQUILIBRATION, SAMPLING, ChainEngine, PhiloxRandom,
                     run_iteration)
from .io import parsers
from .models import dense
from .params import CogapsParams
from .parallel.multichain import MultichainEngine, stack_device_data

GIST_CSV = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "GIST.csv")

_MATMUL = re.compile(r"gemm|gemv|xmma|cutlass|splitk|cublas", re.IGNORECASE)


def kernel_class(name: str) -> str:
    if re.search(r"\bsweep_kernel(<\d+>)?\(", name):  # any width class
        return "sweep_kernel"
    if re.search(r"\bspan_kernel\(", name):
        return "span_kernel"
    if re.search(r"\b((rows|quads|mma)_kernel<\d+>|mma_tiles_kernel<\d+, "
                 r"\d+>|simt_tiles_kernel)\(", name):  # tables.cu
        return "tables_kernel"
    if _MATMUL.search(name):
        return "matmuls"
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    return "elementwise_reduce"


def busy_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


ROUTES = ("per-call", "per-call, float64 tables", "fused")


def profile_config(name: str, Ds, k: int, n_iterations: int, window: int,
                   device, route: str) -> dict:
    params = CogapsParams(n_patterns=k, n_iterations=n_iterations, seed=7,
                          output_frequency=0)
    cfg = params.engine_config(*Ds[0].shape)
    eng = MultichainEngine(stack_device_data(Ds, None, cfg, device), cfg,
                           device)
    if route == "fused":
        run_phase = eng.run_spans
    else:
        if route == "per-call, float64 tables":
            eng.iterate = functools.partial(run_iteration,
                                            tables=dense.exact_tables)
        run_phase = functools.partial(ChainEngine.run_phase, eng)
    rand = PhiloxRandom([7 + c for c in range(len(Ds))], device)
    state, stats = run_phase(eng.init_state(), eng.init_stats(), rand,
                             EQUILIBRATION)
    torch.cuda.synchronize()

    def run_window():
        st, ss = copy.deepcopy(state), copy.deepcopy(stats)
        upd0 = int(ss.upd.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ss = run_phase(st, ss, rand, SAMPLING, 0, window)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(ss.upd.sum()) - upd0

    run_window()  # warm-up of the sampling path
    wall_s, updates = run_window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_s, prof_updates = run_window()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    by_class, by_name = {}, {}
    for e in events:
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        by_class.setdefault(kernel_class(e.name()), []).append(iv)
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    busy = busy_ns(iv for ivs in by_class.values() for iv in ivs)
    per_iter = 1e-6 / window  # ns over the window -> ms per iteration
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "config": name,
        "route": route,
        "gate_takes_span": eng._fused_ok(),
        "window_iterations": window,
        "wall_ms_per_iter": wall_s * 1e3 / window,
        "device_busy_ms_per_iter": busy * per_iter,
        "busy_share": busy * 1e-9 / wall_s,
        "profiled_wall_ms_per_iter": prof_wall_s * 1e3 / window,
        "profiled_busy_share": busy * 1e-9 / prof_wall_s,
        "device_ops_per_iter": len(events) / window,
        "ms_per_iter_by_class": {c: busy_ns(ivs) * per_iter
                                 for c, ivs in sorted(by_class.items())},
        "top_device_ops_ms_per_iter": {n: t * per_iter for n, t in top},
        "updates": updates,
        "profiled_updates": prof_updates,
    }


# the fused route's gate (parallel/multichain.py), measured by both routes:
# (name, (genes, samples, seed) or None for GIST, k, chains, iterations,
# timed window)
GATE_CONFIGS = tuple(
    (f"{'GIST' if spec is None else f'{spec[0]}x{spec[1]}'} k={k}, "
     f"{nch} chains", spec, k, nch, n_it, window)
    for spec, n_it, window, ks in (
        (None, 400, 50, (10, 20)), ((2000, 32, 43), 100, 30, (10,)),
        ((5005, 100, 51), 40, 10, (10,)), ((6000, 100, 47), 40, 10, (10, 20)),
        ((10000, 100, 46), 40, 10, (10,)), ((20000, 100, 45), 40, 10, (10,)))
    for k in ks for nch in (16, 4)
    if k == 10 or nch == 16 or spec is not None)


def gate_rows(device, gist) -> list:
    """Both routes' rows (per-call, fused) of GATE_CONFIGS."""
    rows = []
    for name, spec, k, nch, n_it, window in GATE_CONFIGS:
        Ds = ([gist] * nch if spec is None
              else synthetic_dense(spec[0], spec[1], k, nch, spec[2]))
        for route in ("per-call", "fused"):
            rows.append(profile_config(name, Ds, k, n_it, window, device,
                                       route))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gate", action="store_true",
                    help="both routes at GATE_CONFIGS, the fused gate's "
                         "shapes, instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    device = torch.device("cuda")
    gist, _, _ = parsers.read_matrix(GIST_CSV)
    if args.gate:
        gate_rows(device, gist)
        return
    configs = [  # the fused span applies to few samples, not 2000
        ("GIST k=7, 1 chain", [gist], 7, 2000, 100, ROUTES),
        ("GIST k=7, 16 chains", [gist] * 16, 7, 2000, 100, ROUTES),
        ("5000x2000 k=10, 4 chains", synthetic_dense(5000, 2000, 10, 4, 42),
         10, 100, 30, ROUTES[:2]),
        # wider data with few samples: where the fused span stops paying
        ("2000x32 k=7, 16 chains", synthetic_dense(2000, 32, 7, 16, 43), 7,
         100, 30, ROUTES[::2]),
        ("4000x64 k=7, 16 chains", synthetic_dense(4000, 64, 7, 16, 44), 7,
         60, 20, ROUTES[::2]),
        ("6000x100 k=10, 16 chains", synthetic_dense(6000, 100, 10, 16, 47),
         10, 40, 10, ROUTES[::2]),
        ("10000x100 k=10, 16 chains", synthetic_dense(10000, 100, 10, 16, 46),
         10, 40, 10, ROUTES[::2]),
        ("20000x100 k=10, 16 chains", synthetic_dense(20000, 100, 10, 16, 45),
         10, 40, 10, ROUTES[::2]),
        # the gate at a few chains (GWCoGAPS's four subsets)
        ("6000x100 k=10, 4 chains", synthetic_dense(6000, 100, 10, 4, 48),
         10, 40, 10, ROUTES[::2]),
        ("10000x100 k=10, 4 chains", synthetic_dense(10000, 100, 10, 4, 49),
         10, 40, 10, ROUTES[::2]),
    ]
    for name, Ds, k, n_iterations, window, routes in configs:
        for route in routes:
            print(json.dumps(profile_config(name, Ds, k, n_iterations,
                                            window, device, route)),
                  flush=True)


if __name__ == "__main__":
    main()
