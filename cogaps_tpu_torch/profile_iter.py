"""Where an iteration of the dense engine spends its time on a CUDA card.

Run from the root of a checkout: ``python -m cogaps_tpu_torch.profile_iter``.

For each configuration it runs the equilibration phase from empty atom
tables, so the tables have grown to their working size, copies the state,
and then runs the same window of sampling iterations twice from that copy:

1. unprofiled, on the host clock from a synchronize to a synchronize:
   wall ms per iteration;
2. under torch.profiler with CUDA activity: the device's busy time (the
   union of the intervals of its kernels, copies and sets), split by
   class (sweep kernel, matmuls, copies, other kernels).

Both runs start from the same state with the same random streams, so the
device does the same work in each (the update counts are printed side by
side). busy share = device busy time of the window / unprofiled wall time
of the same window; the profiled run's own wall time and share are printed
too. One JSON line per configuration.
"""

from __future__ import annotations

import copy
import json
import os
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bench_harness import synthetic_dense
from .engine import EQUILIBRATION, SAMPLING, PhiloxRandom
from .io import parsers
from .params import CogapsParams
from .parallel.multichain import MultichainEngine, stack_device_data

GIST_CSV = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "GIST.csv")

_MATMUL = re.compile(r"gemm|gemv|xmma|cutlass|splitk|cublas", re.IGNORECASE)


def kernel_class(name: str) -> str:
    if re.search(r"\bsweep_kernel\(", name):
        return "sweep_kernel"
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


def profile_config(name: str, Ds, k: int, n_iterations: int, window: int,
                   device) -> dict:
    params = CogapsParams(n_patterns=k, n_iterations=n_iterations, seed=7,
                          output_frequency=0)
    cfg = params.engine_config(*Ds[0].shape)
    eng = MultichainEngine(stack_device_data(Ds, None, cfg, device), cfg,
                           device)
    rand = PhiloxRandom([7 + c for c in range(len(Ds))], device)
    state, stats = eng.run_phase(eng.init_state(), eng.init_stats(), rand,
                                 EQUILIBRATION)
    torch.cuda.synchronize()

    def run_window():
        st, ss = copy.deepcopy(state), copy.deepcopy(stats)
        upd0 = int(ss.upd.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ss = eng.run_phase(st, ss, rand, SAMPLING, 0, window)
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    device = torch.device("cuda")
    gist, _, _ = parsers.read_matrix(GIST_CSV)
    configs = [
        ("GIST k=7, 1 chain", [gist], 7, 2000, 100),
        ("GIST k=7, 16 chains", [gist] * 16, 7, 2000, 100),
        ("5000x2000 k=10, 4 chains", synthetic_dense(5000, 2000, 10, 4, 42),
         10, 100, 30),
    ]
    for name, Ds, k, n_iterations, window in configs:
        print(json.dumps(profile_config(name, Ds, k, n_iterations, window,
                                        device)), flush=True)


if __name__ == "__main__":
    main()
