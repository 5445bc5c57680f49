"""Per-call times of the sweep kernels on one CUDA card, for comparing two
checkouts of the package in one run.

    python3 kernel_times.py [--root DIR] [--placements] [--out FILE]

times the cogaps_tpu_torch package found in DIR (default: the checkout
holding this file), built from DIR's sources, on the cases of
chip_smoke.py's phase 3 (chip_smoke.sweep_cases, from this checkout):

- K1 (csrc/sweep.cu) at GIST A and P and a 5000-row sampler from random
  atoms, and at GIST A and P from the state after 50 per-call
  iterations at that run's budgets; K2 (the same kernel on the sparse
  model's tables) at 2000 x 10000 k=10, A and P; 4 chains, fast mode.
  Per case, ms a call by five readings: "events_ms", CUDA events
  around back-to-back calls (as chip_smoke's kernels line: the host's
  pace where it is slower than the device's); "stream_ms", the same
  calls run back to back by the device at its own pace
  (chip_smoke.stream_ms, median of five batches: every kernel of the
  call and the gaps between them) and "host_ms", the host's time to
  enqueue a call; "device_ms", sweep_kernel's own device time
  (torch.profiler), and "call_device_ms", every device operation of
  the call; and the sweeps a call;
- K3 (csrc/span.cu): span_kernel's device time a sampling iteration of a
  50-iteration span at GIST x16 (torch.profiler), from the state after
  50 per-call iterations;
- K4 (csrc/atlas.cu): ms a call at the atlas shape, A and P.

With --placements (this checkout's package only), it times K1/K2 instead
under other placements of the chains' state than smem_plan's
(ops/sweep_cuda.PLACED's arrays packed under other budgets or with some
left out), on the same cases and on the A samplers of 10000 x 100 and
20000 x 100 k=10 with 16 chains: sweep_kernel's device ms and the
stream's ms a call of each.

To compare a change with its parent on one card, unpack the parent
(`git archive`) into a git-ignored directory and run this script on
both in turns (parent, change, change, parent) in one command. Prints
one JSON object and writes it to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def sweep_times(cs, cases, device, reps=20):
    """{case name: readings} of K1/K2 in fast mode (see the module's
    docstring)."""
    import torch
    from cogaps_tpu_torch.ops import sweep_cuda
    out = {}
    for case in cases:
        key = sweep_cuda.PhiloxKey(
            key0=torch.arange(11, 11 + case["nch"], device=device), key1=5)
        args = (case["atoms"], case["M"], case["Y"], case["phase"],
                case.get("temp", 1.0), case["budgets"], case["consts"],
                case["mass"], key)

        def call():
            return sweep_cuda.run_updates_multi(*args)

        stream, host = cs.stream_ms(call, reps)
        out[case["name"]] = {
            "events_ms": cs.time_calls(call, reps), "stream_ms": stream,
            "host_ms": host,
            "device_ms": cs.device_ms(call, "sweep_kernel", reps),
            "call_device_ms": cs.device_ms(call, "", reps),
            "sweeps": call()[4].tolist()}
    return out


def placement_times(cs, cases, device, reps=10):
    """{case: {variant: (sweep_kernel's device ms, the stream's ms, sweeps,
    placement)}} of K1/K2 under placements other than smem_plan's."""
    import torch
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.ops import sweep_cuda as sc
    [D_10k] = synthetic_dense(10000, 100, 10, 1, 1)
    [D_20k] = synthetic_dense(20000, 100, 10, 1, 2)
    cases = cases + [
        cs.make_case("10000-row x16", D_10k, True, 10, 1024, 65536, 16,
                     4000, 6, device),
        cs.make_case("20000-row x16", D_20k, True, 10, 1024, 131072, 16,
                     4000, 7, device),
    ]
    claims = ("rmin", "amin")
    out = {}
    for case in cases:
        c = case["consts"]
        NR, K, C, B, nch = c.n_rows, c.k, c.capacity, c.batch, case["nch"]
        budget = sc.SMEM_BLOCK - sc.STATIC_SMEM
        variants = {
            "plan": sc.smem_plan(NR, K, C, B, nch),
            "none": sc.pack(NR, K, C, names=()),
            "claims": sc.pack(NR, K, C, names=claims, budget=budget),
            "claims+hole": sc.pack(NR, K, C, names=claims + ("hole",),
                                   budget=budget),
            "all but hole": sc.pack(NR, K, C, budget=budget, names=tuple(
                n for n in sc.PLACED if n != "hole")),
            "cap 128 KB": sc.pack(NR, K, C, budget=128 * 1024),
            "cap 64 KB": sc.pack(NR, K, C, budget=64 * 1024),
        }
        key = sc.PhiloxKey(
            key0=torch.arange(11, 11 + nch, device=device), key1=5)
        args = (case["atoms"], case["M"], case["Y"], case["phase"],
                case.get("temp", 1.0), case["budgets"], c, case["mass"],
                key, 32, None)
        row = {}
        for name, plan in variants.items():
            def call():
                return sc._run_kernel(*args, place=plan)
            sweeps = call()[4].tolist()
            row[name] = (cs.device_ms(call, "sweep_kernel", reps),
                         cs.stream_ms(call, reps)[0], sweeps,
                         plan.describe())
        out[case["name"]] = row
        print(json.dumps({case["name"]: row}), flush=True)
    return out


def span_time(cs, device, n_chains=16, seed=21, reps=5):
    """span_kernel's device ms a sampling iteration at GIST x n_chains."""
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import throughput_engine
    from cogaps_tpu_torch.engine import (EQUILIBRATION, SAMPLING, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.io import parsers
    from cogaps_tpu_torch.ops import span_cuda
    D, _, _ = parsers.read_matrix(cs.GIST_CSV)
    eng, _ = throughput_engine(D, cogaps_tpu_torch.CogapsParams(
        n_patterns=7, n_iterations=2000, seed=seed, output_frequency=0),
        n_chains, None, device)
    seeds = [seed + c for c in range(n_chains)]
    state, stats = ChainEngine.run_phase(
        eng, eng.init_state(), eng.init_stats(),
        PhiloxRandom(seeds, device), EQUILIBRATION, 0, 50)
    warm = PhiloxRandom(seeds, device)
    args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, SAMPLING,
            eng.data, 0, span_cuda.CHUNK, state, stats, warm)
    return cs.device_ms(lambda: span_cuda.run_span(*args), "span_kernel",
                        reps) / span_cuda.CHUNK


def atlas_times(cs, device, reps=5):
    """{case name: ms a call} of K4 at the atlas shape."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import synthetic_coo
    from cogaps_tpu_torch.ops import atlas_cuda, sweep_cuda
    from cogaps_tpu_torch.parallel.atlas_engine import AtlasEngine
    coo = synthetic_coo(30000, 50000, 0.02, 17)
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=50, n_iterations=100, seed=9, sparse_optimization=True,
        output_frequency=25)
    atlas = AtlasEngine(coo, params.engine_config(*coo.shape),
                        chisq_every=1, device=device)
    del coo
    a, p = atlas.side_a, atlas.side_p
    out = {}
    for name, side, m, seed in (("K4 atlas A", a, p.n_rows, 6),
                                ("K4 atlas P", p, a.n_rows, 7)):
        case = cs.atlas_case(name, side, m, 50, 512, 1 << 19, 4000, seed,
                             device)
        key = sweep_cuda.PhiloxKey(key0=torch.tensor([13], device=device),
                                   key1=3)
        args = (case["atoms"], case["M"], case["csr"], case["other"], 1.0,
                case["budgets"], case["consts"], case["mass"], key)
        atlas_cuda.run_updates_atlas_multi(*args)
        out[name] = cs.time_calls(
            lambda: atlas_cuda.run_updates_atlas_multi(*args), reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--out", default=None, help="JSON file to write")
    ap.add_argument("--placements", action="store_true",
                    help="time K1/K2 under other placements instead")
    args = ap.parse_args()
    import chip_smoke as cs  # this checkout's, before DIR goes on the path
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 3
    import cogaps_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(cogaps_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {cogaps_tpu_torch.__file__}, not the "
                           f"package in {root}")
    from cogaps_tpu_torch.bench_harness import synthetic_sparse
    device = torch.device("cuda")
    t0 = time.perf_counter()
    builds = cs.build_all()
    record = {"root": root, "card": cs.nvidia_smi(),
              "build_s": time.perf_counter() - t0,
              "sweep_ptxas": cs.sweep_classes(builds["sweep"][1]),
              "span_ptxas": cs.ptxas_of(builds["span"][1], "span_kernel"),
              "atlas_ptxas": cs.ptxas_of(builds["atlas"][1], "atlas_kernel")}
    [D_sparse] = synthetic_sparse(2000, 10000, 10, 1, 11)
    k1, k2 = cs.sweep_cases(device, D_sparse)
    if args.placements:
        record["placements"] = placement_times(cs, k1 + k2, device)
    else:
        record["sweep"] = sweep_times(cs, k1 + k2, device)
        record["span_kernel_ms_per_iter"] = span_time(cs, device)
        record["atlas"] = atlas_times(cs, device)
    record["seconds"] = time.perf_counter() - t0
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
