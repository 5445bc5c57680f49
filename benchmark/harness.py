"""One run of one benchmark cell of cogaps_tpu_torch: set-up, burn-in, the
timed window, the traced stretch and the check of what the window produced.

A cell (workloads/<cell>.json) names a configuration (configs/<name>.json:
the data's generator and shape, k, nSets, nIterations and the distributed
mode) and a traffic mix (traffic/<name>.json: which stage runs, its
output frequency, the window's chunk of iterations and the traced
stretch). Every metric of BENCHMARK.json has a reader in
metrics/<metric>.py. The reference that decides `correct` is in
reference/ and imports nothing of the program.

Set-up builds the stage-1 engine of GWCoGAPS() / scCoGAPS() from the
cell's data with the program's own functions (as
parallel/distributed._run_subsets_multichain builds it), then
burns in: the last `burn_in` iterations of the equilibration phase, at
temperature 1, from the empty state. The window drives the engine's
run_phase over the sampling phase from iteration 0, `chunk_iters`
iterations a call, each call ending in a synchronisation, until
`seconds` have passed or the phase's iterations run out.
"""

from __future__ import annotations

import copy
import importlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
from cogaps_tpu_torch.models import dense
from cogaps_tpu_torch.ops import span_cuda, sweep_cuda, tables_cuda
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import distributed
from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                  stack_device_data)

from . import data as data_gen
from . import metrics as metrics_pkg
from . import reference

HERE = Path(__file__).resolve().parent
# sampling iterations run once on a copy of the state before the window
WARM_ITERS = 2
# the kernel wrappers whose launch counters a run prints
LAUNCH_COUNTERS = {"sweep": sweep_cuda.run_updates_multi,
                   "tables": tables_cuda.dense_tables,
                   "span": span_cuda.run_span}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> dict:
    """The cell `name` with its configuration and traffic mix, by file."""
    cell = load_json(root / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_spec"] = load_json(root / "configs" / f"{cell['config']}.json")
    cell["traffic_spec"] = load_json(root / "traffic" / f"{cell['traffic']}.json")
    return cell


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The metrics of BENCHMARK.json's `kind` list that `cell_name` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def read_metric(name: str, ctx: dict):
    """The value of metric `name` from its reader, metrics/<name>.py, or
    None where the reader finds nothing to read."""
    module = importlib.import_module(f"{__package__}.metrics.{name}")
    return module.read(ctx)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Setup:
    """The stage engine of a cell, built from its data as the program's
    distributed entry builds it, with its state after burn-in."""

    def __init__(self, cell: dict, D: np.ndarray, seed: int, device):
        conf, traffic = cell["config_spec"], cell["traffic_spec"]
        if traffic["stage"] != "free":
            raise ValueError(f"stage {traffic['stage']!r}: only the first, "
                             "free stage is built")
        self.device = torch.device(device)
        self.traffic = traffic
        self.genome_wide = conf["distributed"] == "genome-wide"
        if conf["sparse_optimization"]:
            raise ValueError("the sparse model's engine is not built here")
        params = CogapsParams(
            n_patterns=conf["n_patterns"], n_iterations=conf["n_iterations"],
            seed=seed, output_frequency=traffic["output_frequency"],
            distributed=conf["distributed"], n_sets=conf["n_sets"],
            print_messages=False)
        params.validate()
        n_total = D.shape[0] if self.genome_wide else D.shape[1]
        rng = np.random.default_rng(params.resolved_seed())
        self.sets = distributed.create_sets(n_total, params, rng)
        p = distributed._stage_params(params, self.genome_wide, None)
        subs = [D[s, :] if self.genome_wide else D[:, s] for s in self.sets]
        shapes = [d.shape for d in subs]
        cfg = p.engine_config(max(g for g, _ in shapes),
                              max(s for _, s in shapes))
        self.eng = MultichainEngine(
            stack_device_data(subs, None, cfg, self.device), cfg, self.device)
        self.nnz = sum(int(np.count_nonzero(d)) for d in subs)
        del subs
        self.config = self.eng.config
        self.rand = PhiloxRandom([p.resolved_seed()] * self.eng.n_chains,
                                 self.eng.device)
        self.state = self.eng.init_state(None)
        self.stats = self.eng.init_stats()

    def shapes(self) -> dict:
        e = self.eng
        return {"chains": e.n_chains, "genes": e.n_genes,
                "samples": e.n_samples, "k": self.config.n_patterns,
                "nnz": self.nnz}

    def burn_in(self, iterations: int) -> None:
        n = self.config.n_iterations
        self.state, self.stats = self.eng.run_phase(
            self.state, self.stats, self.rand, EQUILIBRATION,
            n - iterations, n)

    def warm_sampling(self, iterations: int) -> None:
        """The sampling phase's first iterations on copies of the state,
        so that its statistics' operations have run once before the
        window; the state itself is left as it is."""
        st, ss = copy.deepcopy(self.state), copy.deepcopy(self.stats)
        self.eng.run_phase(st, ss, self.rand, SAMPLING, 0, iterations)
        sync(self.device)


def profiled(device):
    """A torch.profiler context over the host's PyTorch operations and, on
    a card, its CUDA activity (the device's operations and the runtime
    calls that launched them)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def trace_events(prof) -> tuple:
    """(device, host) events of a finished profile, each a list of
    (name, start_ns, duration_ns)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.duration_ns())
        (dev if e.device_type() == DeviceType.CUDA else host).append(item)
    return dev, host


def run_window(s: Setup, seconds: float, trace: bool) -> dict:
    """Sampling iterations from 0 in chunks until `seconds` have passed;
    with `trace`, chunks [skip, skip + n) of the traffic's stretch run
    under the profiler. Returns the window's record."""
    traffic = s.traffic
    chunk = int(traffic["chunk_iters"])
    n_iter = s.config.n_iterations
    skip, n_traced = (int(traffic["trace_skip_chunks"]),
                      int(traffic["trace_chunks"]))
    eng, dev = s.eng, s.device
    start_M = (s.state.M_a.clone(), s.state.M_p.clone())
    upd0 = s.stats.upd.clone()
    snaps = []  # (iterations done, M_a, M_p) at each chunk's end
    record = {"trace": None}
    sync(dev)
    t0 = time.perf_counter()
    it, chunks, prof, marks, paused = 0, 0, None, [], 0.0
    chunk_list = []  # (iterations, seconds, traced) of each chunk
    while True:
        if trace and chunks == skip:
            t_pause = time.perf_counter()
            prof = profiled(dev)
            prof.__enter__()
            t_trace = time.perf_counter()
            paused += t_trace - t_pause
            it_trace = it
        b, it_before = min(it + chunk, n_iter), it
        in_trace = prof is not None
        s.state, s.stats = eng.run_phase(s.state, s.stats, s.rand, SAMPLING,
                                         it, b)
        it, chunks = b, chunks + 1
        sync(dev)
        # on the host, so that they add nothing to the device's peak
        snaps.append((it, s.state.M_a.cpu(), s.state.M_p.cpu()))
        if prof is not None and chunks == skip + n_traced:
            t_pause = time.perf_counter()
            wall = t_pause - t_trace
            prof.__exit__(None, None, None)
            device_ev, host_ev = trace_events(prof)
            record["trace"] = {"device": device_ev, "host": host_ev,
                               "wall_s": wall, "iterations": it - it_trace}
            prof = None
            paused += time.perf_counter() - t_pause
        # the window's time leaves out the profiler's start and its reading
        elapsed = time.perf_counter() - t0 - paused
        chunk_list.append((b - it_before, elapsed - (marks[-1] if marks
                                                     else 0.0), in_trace))
        marks.append(elapsed)
        if it >= n_iter or (elapsed >= seconds
                            and (not trace or chunks >= skip + n_traced)):
            break
    record.update(window_s=elapsed, iterations=it,
                  chunks=chunk_list,
                  updates=int((s.stats.upd - upd0).sum()),
                  start_M=start_M, snaps=snaps)
    return record


def program_outputs(s: Setup, record: dict) -> dict:
    """What the window produced and the program's tables on its final
    state, on the host, for the reference to judge."""
    def host(t):
        return t.detach().cpu().numpy()

    st, ss, e = s.state, s.stats, s.eng
    out = {"iterations": record["iterations"],
           "output_frequency": s.config.output_frequency,
           "M_a": host(st.M_a), "M_p": host(st.M_p),
           "start_M_a": host(record["start_M"][0]),
           "start_M_p": host(record["start_M"][1]),
           "atoms_a": [host(st.atoms_a.mass), host(st.atoms_a.elem),
                       host(st.atoms_a.n)],
           "atoms_p": [host(st.atoms_p.mass), host(st.atoms_p.elem),
                       host(st.atoms_p.n)],
           "chisq_hist": host(ss.chisq_hist), "n_hist": e.hist.n_hist,
           "n_stat": host(ss.n_stat),
           "a_sum": host(ss.a_sum), "a_sumsq": host(ss.a_sumsq),
           "p_sum": host(ss.p_sum), "p_sumsq": host(ss.p_sumsq),
           "snaps": [(i, host(a), host(p)) for i, a, p in record["snaps"]]}
    d = e.data
    for side, args in (("a", (d.D, d.invS2, st.M_a, st.M_p)),
                       ("p", (d.D_t, d.invS2_t, st.M_p, st.M_a))):
        cache, ph = dense.tables(*args)
        out[f"tables_{side}"] = [host(cache.Y), host(ph.SQ), host(ph.Z)]
    return out


def breakdown(trace: dict) -> dict:
    """The traced stretch's ten device operations that took most time,
    and its idle device time by what the host was doing then (the
    innermost host event over each gap's middle), each [name, seconds]."""
    dev, host = trace["device"], trace["host"]
    by_op = {}
    for name, _, dur in dev:
        by_op[name] = by_op.get(name, 0) + dur
    iv = sorted((s, s + d) for _, s, d in dev)
    spans, reach = [], (iv[0][1] if iv else None)
    for s, e in iv[1:]:
        if s > reach:
            spans.append((reach, s))
        reach = max(reach, e)
    host = sorted(host, key=lambda e: e[1])
    gaps, active, j = {}, [], 0
    for lo, hi in spans:  # in time order
        mid = (lo + hi) / 2
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] + h[2] >= mid]
        best = min(active, key=lambda h: h[2], default=None)
        label = best[0] if best else "(no host event)"
        gaps[label] = gaps.get(label, 0) + (hi - lo)

    def top(d):
        return [[n, t * 1e-9] for n, t in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, cell: dict = None, faults=None,
             control: bool = False) -> dict:
    """One run of cell `name`: set-up from the seed, the window, the
    metrics and the check. `cell` overrides the cell's files (the tests'
    small cells); `faults(setup)` may break the timed path before
    burn-in (benchmark/faults.py); `control` adds the control's numbers
    on the same state under "control" (calibrate.py)."""
    cell = cell or load_cell(name)
    device = torch.device(device)
    conf = cell["config_spec"]
    D = data_gen.generate(conf, seed, device)
    s = Setup(cell, D, seed, device)
    if faults is not None:
        faults(s)
    s.burn_in(int(cell["burn_in"]))
    s.warm_sampling(WARM_ITERS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    rec = run_window(s, seconds, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = {"setup_s": setup_s, "window_s": rec["window_s"],
           "iterations": rec["iterations"], "updates": rec["updates"],
           "chains": s.eng.n_chains, "trace": rec["trace"],
           "chunks": rec["chunks"],
           "shapes": s.shapes(), "cell": cell}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, name, kind):
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    launches = {n: w.launches for n, w in LAUNCH_COUNTERS.items()}
    chunk_ms = [1e3 * x for _, x, _ in rec["chunks"]]
    out = program_outputs(s, rec)
    del s, rec["snaps"], rec["start_M"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inp = reference.Inputs(D, seed, conf)
    values = reference.numbers(inp, out, "float64", device)
    correct, attempted, failed, checks = reference.verdict(
        values, cell.get("limits", {}))
    control_values = (reference.numbers(inp, out, "tf32", device)
                      if control else None)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        tr = ctx["trace"]
        result["device"]["busy_s"] = metrics_pkg.busy_ns(
            (st, st + d) for _, st, d in tr["device"]) * 1e-9
        result["device"]["window_s"] = tr["wall_s"]
        result["breakdown"] = breakdown(tr)
    if control_values is not None:
        result["control"] = control_values
    result["checks"] = checks
    result["_launches"] = launches
    result["_chunk_ms"] = [round(x, 1) for x in chunk_ms]
    return result


def report(result: dict) -> None:
    """The launch counters and the checks on standard error (the checks
    last), then the result's line on standard output."""
    import sys
    print("launches: " + json.dumps(result.pop("_launches")),
          file=sys.stderr)
    print("window chunks, ms, in order: "
          + json.dumps(result.pop("_chunk_ms")), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    checks = result.pop("checks")
    result["checks"] = checks  # the last key
    print(json.dumps(result), flush=True)
