"""Per-call times of the sweep kernels on one CUDA card, for comparing two
checkouts of the package in one run.

    python3 kernel_times.py [--root DIR] [--placements | --profile |
                             --golden N | --quads | --tables | --chisq |
                             --span | --sparse-tables]
                            [--out FILE]

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

With --profile it runs instead the per-call route's iterations of
profile_iter (DIR's cogaps_tpu_torch.profile_iter.profile_config, on
PROFILE_CONFIGS from this checkout): wall ms, device busy ms and its
share, device operations an iteration and the busy time by class, at
GIST x1 and x16, 4 x 5000 x 2000 k=10, and 16 and 4 chains of 6000,
10000 (and, at 16, 20000) x 100 k=10.

With --golden N it runs instead tests/test_torch_cuda.py's GIST golden
pattern recovery (CoGAPS on data/gist.npz, k=3, 1500 iterations, the
per-call route) at seeds 0 .. N-1, each with the per-call tables of the
tables kernel and with the plain cuBLAS tables (models/dense.tables_plain
on the card): each run's meanChiSq, its late chi^2 plateau, the
correlation of each recovered P pattern with the reference's
(best_perm_corr) and whether it meets every band of that test; then,
per tables, the pass rate, the quantiles of each pattern's correlation,
of the weakest one, of the plateau and of meanChiSq, and between the
two, Fisher's exact test of the pass rates and Mann-Whitney U tests of
the distributions (scipy.stats).

With --quads it times instead the tables kernel's plan at k=20 on
chip_smoke's 4 x 5000 x 2000 and 16 x 20000 x 100 cases, A and P:
ops/tables_cuda.tables_plan's choice (mma_kernel in column tiles) and
quads_kernel<PQ> (forced as --plan FORM=quads forces it), in turns
(tiles, quads, quads, tiles): the stream's ms a call, events' ms, the
plan and the worst error against the float64 tables.

With --tables it times instead the per-call tables kernel
(models/dense.tables, csrc/tables.cu) at chip_smoke's TABLES_CASES: per
case the stream's ms a call (chip_smoke.stream_ms) and the host's, events'
ms, the plain cuBLAS tables' stream ms (models/dense.tables_plain), the
float32 bound (tables_counts) and the tensor-core bound
(tables_tc_counts, TF32 at 495 TFLOP/s) and each over stream ms, the
worst error
against the float64 tables over the summed |terms| and whether every
entry is within 1e-5 of them, the launches a call and the plan's form;
with the parent's package as DIR, the parent kernel at the same inputs.
Optional overrides of the plan constants of DIR's package (name=value,
--plan), to time other chunks; FORM=quads forces the CUDA-core kernels
(rows_kernel up to k = 12, quads_kernel above) by raising MMA_MIN_M past
every m and setting SIMT_MAX_K to 0, so that the column tiles or
simt_tiles_kernel and quads_kernel can be timed in turns in one call;
--cases NAME... keeps the cases whose names hold one of them (`--cases
20000x40 "GIST A x1 k=13"`: simt_tiles_kernel's cases and rows_kernel's
yardstick).

With --chisq it times instead the dense chi^2 (models/dense.
chisq_from_state): per call at 16 x 20000 x 100 k=10, 4 x 5000 x 2000
k=10 and GIST x16, by DIR's package and by two written here (one
batched product and sum over the chains; every step a chain at a time),
with the number of chains whose chi^2 differs in bits from the same
chain's alone; and whole per-call runs (ChainEngine.run_phase, 250
equilibration iterations) at 16 x 20000 x 100 and GIST x16 with a chi^2
every 5 and every 250 iterations and with none.

With --span it splits K3 instead (span_split), at GIST x16, 4 x 5005 x
100 k=10 (phase 11's subsets) and 16 x 20000 x 100 k=10: span_kernel's
device ms an iteration with and without sweeps (every budget 0),
rebuild_kernel alone, the launch shapes and the bounds.

With --sparse-tables it times instead the sparse model's tables as DIR's
package builds them on the card: its sparse tables kernel
(ops/sparse_tables_cuda.sparse_tables) where it has one, else the cuBLAS
products of models/sparse.kernel_tables on dense weights built
beforehand (what "dense" mode held). First at chip_smoke's
sparse_tables_cases (phase 3's): the stream's ms a call, events' ms, the
host's ms and the bound (this checkout's sparse_tables_counts); then an
iteration of phase 15 (c) (SparseShardedEngine on synthetic_coo(30000,
50000, 0.02), k=50, 4 shards, mesh=None) in each mode, "dense", "ell"
and "xla", after 4 equilibration iterations: the engine's set-up
seconds and peak device memory, and two more iterations each split in
parts by chip_smoke.sparse_split (A tables, A launch, P table build,
sum, P launch) with the peak memory of those iterations.

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


# (name, (genes, samples, chains, seed) or None for GIST, k, chains,
# n_iterations, per-call warm-up iterations): K3 at GIST x16 (phase 5),
# at phase 11's subset shape and at the wide rebuild's shape
SPAN_CASES = (
    ("GIST x16", None, 7, 16, 2000, 50),
    ("4 x 5005x100 k=10", (5005, 100, 51), 10, 4, 200, 50),
    ("16 x 20000x100 k=10", (20000, 100, 45), 10, 16, 40, 20))


def span_split(cs, device, reps=3):
    """K3 split into its parts, a case of SPAN_CASES at a time, from the
    state after the warm-up's per-call equilibration iterations:
    span_kernel's device ms an iteration of a CHUNK-iteration sampling
    span, the same span with every budget 0 (rebuilds, statistics and
    counters: no sweep), their difference (the sweeps), rebuild_kernel
    alone on the same state (both samplers' tables once), the updates
    an iteration, the launch shapes (cluster size, threads, shared
    memory, SMs) and the bounds (chip_smoke.span_bound_ms,
    rebuild_bound_ms)."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.engine import (EQUILIBRATION, SAMPLING, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.io import parsers
    from cogaps_tpu_torch.ops import span_cuda
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    gist = parsers.read_matrix(cs.GIST_CSV)[0]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for name, spec, k, nch, n_iterations, n_warm in SPAN_CASES:
        Ds = ([gist] * nch if spec is None else
              synthetic_dense(spec[0], spec[1], k, nch, spec[2]))
        G, S = Ds[0].shape
        cfg = cogaps_tpu_torch.CogapsParams(
            n_patterns=k, n_iterations=n_iterations, seed=21,
            output_frequency=0).engine_config(G, S)
        eng = MultichainEngine(stack_device_data(Ds, None, cfg, device), cfg,
                               device)
        seeds = list(range(21, 21 + nch))

        class NoSweeps(PhiloxRandom):
            def budget_normals(self, phase, start, n):
                return torch.full((nch, n, 2), -1e30, device=device)

        state, stats = ChainEngine.run_phase(
            eng, eng.init_state(), eng.init_stats(),
            PhiloxRandom(seeds, device), EQUILIBRATION, 0, n_warm)
        args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, SAMPLING,
                eng.data, 0, span_cuda.CHUNK, state, stats)
        warm = PhiloxRandom(seeds, device)
        after = span_cuda.run_span(*args, warm)
        per_it = 1.0 / span_cuda.CHUNK
        span_ms = cs.device_ms(lambda: span_cuda.run_span(*args, warm),
                               "span_kernel", reps) * per_it
        bare = NoSweeps(seeds, device)
        bare_ms = cs.device_ms(lambda: span_cuda.run_span(*args, bare),
                               "span_kernel", reps) * per_it
        rebuild_ms = cs.device_ms(lambda: span_cuda.rebuild_tables(
            eng.data, state.M_a, state.M_p), "rebuild_kernel", reps)
        threads = span_cuda.block_threads(eng.consts_a.batch,
                                          eng.consts_p.batch, k)
        shapes = {}
        caps = (eng.consts_a.capacity, eng.consts_p.capacity)
        for kernel, t in ((0, threads),
                          (1, span_cuda.block_threads(1024, 1, k))):
            try:  # the sweeps' placements, where the package has them
                sh = span_cuda.launch_shape(kernel, device, nch, G, S, k, t,
                                            caps=caps if kernel == 0
                                            else None)
            except TypeError:
                sh = span_cuda.launch_shape(kernel, device, nch, G, S, k, t)
            shapes[("span_kernel", "rebuild_kernel")[kernel]] = {
                "cl": sh.cl, "ctas": sh.cl * nch, "threads": t,
                "smem": sh.smem, "plan_a": list(sh.plan_a),
                "plan_p": list(sh.plan_p)}
        bound, by = cs.span_bound_ms(G, S, k, nch, span_cuda.CHUNK,
                                     (state, stats), after, True)
        out[name] = {
            "span_ms_per_iter": span_ms, "no_sweeps_ms_per_iter": bare_ms,
            "sweeps_ms_per_iter": span_ms - bare_ms,
            "rebuild_kernel_ms": rebuild_ms,
            "updates_per_iter": float((after[1].upd - stats.upd).sum())
            * per_it,
            "atoms": [int(state.atoms_a.n.sum()), int(state.atoms_p.n.sum())],
            "batches": [eng.consts_a.batch, eng.consts_p.batch],
            "span_bound_ms_per_iter": bound * per_it, "span_bound_by": by,
            "rebuild_bound_ms": cs.rebuild_bound_ms(G, S, k, nch),
            "n_sm": n_sm, "shapes": shapes}
        print(json.dumps({name: out[name]}), flush=True)
        del eng, state, stats, after
    return out


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


# (name, (rows, samples, k, chains, seed) or None for GIST, k, iterations,
# timed window): profile_iter's per-call configurations
PROFILE_CONFIGS = (
    ("GIST k=7, 1 chain", (None, 1), 7, 2000, 100),
    ("GIST k=7, 16 chains", (None, 16), 7, 2000, 100),
    ("5000x2000 k=10, 4 chains", (5000, 2000, 10, 4, 42), 10, 100, 30),
    ("6000x100 k=10, 16 chains", (6000, 100, 10, 16, 47), 10, 40, 10),
    ("10000x100 k=10, 16 chains", (10000, 100, 10, 16, 46), 10, 40, 10),
    ("20000x100 k=10, 16 chains", (20000, 100, 10, 16, 45), 10, 40, 10),
    ("6000x100 k=10, 4 chains", (6000, 100, 10, 4, 48), 10, 40, 10),
    ("10000x100 k=10, 4 chains", (10000, 100, 10, 4, 49), 10, 40, 10))


def profile_times(device) -> list:
    """profile_iter's per-call rows of PROFILE_CONFIGS, by the package
    found on the path."""
    from cogaps_tpu_torch import profile_iter
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.io import parsers
    gist = parsers.read_matrix(os.path.join(HERE, "data", "GIST.csv"))[0]
    rows = []
    for name, data, k, n_it, window in PROFILE_CONFIGS:
        Ds = ([gist] * data[1] if data[0] is None
              else synthetic_dense(*data))
        rows.append(profile_iter.profile_config(name, Ds, k, n_it, window,
                                                device, "per-call"))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def golden_runs(device, n_seeds) -> list:
    """The GIST golden recovery at seeds 0 .. n_seeds-1, by the tables
    kernel and by the plain cuBLAS tables (see the module's docstring)."""
    import numpy as np
    import cogaps_tpu_torch
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops import tables_cuda
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_cuda import best_perm_corr
    z = np.load(os.path.join(HERE, "data", "gist.npz"))
    golden_p = np.asarray(z["golden_Pmean"])
    golden_eq = float(np.mean(np.asarray(z["golden_chisqHistory"])[2:]))
    golden_mcs = float(np.asarray(z["golden_meanChiSq"]).reshape(-1)[0])
    kernel = tables_cuda.dense_tables

    def plain(D, invS2, M, other):
        cache, phase = dense.tables_plain(D, invS2, M, other)
        return cache.Y, phase.SQ, phase.Z, phase.col_nz

    rows = []
    for seed in range(n_seeds):
        for name, fn in (("kernel", kernel), ("cuBLAS", plain)):
            tables_cuda.dense_tables = fn
            try:
                res = cogaps_tpu_torch.CoGAPS(
                    np.asarray(z["D"]), n_patterns=golden_p.shape[1],
                    n_iterations=1500, seed=seed, messages=False,
                    output_frequency=250, device=device)
            finally:
                tables_cuda.dense_tables = kernel
            hist = res.diagnostics["chisqHistory"]
            cors = best_perm_corr(res.Pmean, golden_p)
            plateau = float(np.mean(hist[3 * len(hist) // 4:])) / golden_eq
            mcs = res.mean_chi_sq / golden_mcs
            rows.append({"seed": seed, "tables": name,
                         "plateau_over_golden": plateau,
                         "mcs_over_golden": mcs,
                         "cors": [float(c) for c in cors],
                         "passes": bool(plateau < 1.15 and mcs < 1.4
                                        and np.median(cors) > 0.8
                                        and (cors > 0.5).all())})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def golden_summary(rows) -> dict:
    """Per tables: the pass rate and quantiles; between them, Fisher's
    exact test of the pass rates and Mann-Whitney U tests (two-sided)."""
    import numpy as np
    from scipy import stats
    qs = (0.05, 0.25, 0.5, 0.75)
    by = {}
    for name in ("kernel", "cuBLAS"):
        rs = [r for r in rows if r["tables"] == name]
        cors = np.array([r["cors"] for r in rs])
        by[name] = {
            "runs": len(rs), "passes": sum(r["passes"] for r in rs),
            "cors": cors, "weakest": cors.min(axis=1),
            "plateau": np.array([r["plateau_over_golden"] for r in rs]),
            "mcs": np.array([r["mcs_over_golden"] for r in rs])}
    out = {name: {"runs": b["runs"], "passes": b["passes"],
                  "pass_rate": b["passes"] / max(b["runs"], 1),
                  **{f"pattern{i}_quantiles": np.quantile(
                      b["cors"][:, i], qs).tolist()
                     for i in range(b["cors"].shape[1])},
                  **{f"{key}_quantiles": np.quantile(b[key], qs).tolist()
                     for key in ("weakest", "plateau", "mcs")}}
           for name, b in by.items()}
    k, c = by["kernel"], by["cuBLAS"]
    out["quantiles_at"] = list(qs)
    out["fisher_p_pass_rate"] = float(stats.fisher_exact(
        [[k["passes"], k["runs"] - k["passes"]],
         [c["passes"], c["runs"] - c["passes"]]])[1])
    out["mannwhitney_p"] = {
        key: float(stats.mannwhitneyu(k[key], c[key])[1])
        for key in ("weakest", "plateau", "mcs")}
    out["mannwhitney_p"].update({
        f"pattern{i}": float(stats.mannwhitneyu(k["cors"][:, i],
                                                c["cors"][:, i])[1])
        for i in range(k["cors"].shape[1])})
    return out


QUADS_CASES = ("5000x2000 A x4 k=20", "5000x2000 P x4 k=20",
               "20000x100 A x16 k=20", "20000x100 P x16 k=20")
# --plan FORM=...: the plan constants that force a form; "quads": neither
# mma_kernel, as no m reaches MMA_MIN_M, nor simt_tiles_kernel, as no k
# is at most SIMT_MAX_K (a package without it ignores that name)
PLAN_FORMS = {"quads": {"MMA_MIN_M": 1 << 62, "SIMT_MAX_K": 0}}


def set_plan(tables_cuda, overrides) -> dict:
    """Set the plan constants `overrides` names (NAME=VALUE, or FORM=
    one of PLAN_FORMS) in the package's tables_cuda; returns the values
    they had, for restore_plan."""
    values = {}
    for item in overrides:
        name, value = item.split("=")
        values.update(PLAN_FORMS[value] if name == "FORM"
                      else {name: int(value)})
    old = {name: getattr(tables_cuda, name) for name in values
           if hasattr(tables_cuda, name)}
    for name in old:
        setattr(tables_cuda, name, values[name])
    clear_plans(tables_cuda)
    return old


def restore_plan(tables_cuda, old) -> None:
    for name, value in old.items():
        setattr(tables_cuda, name, value)
    clear_plans(tables_cuda)


def clear_plans(tables_cuda) -> None:
    """Forget the plans made under other constants."""
    for name in ("tables_plan", "cuda_core_plan"):
        if hasattr(tables_cuda, name):
            getattr(tables_cuda, name).cache_clear()


def quads_times(cs, device) -> list:
    """The plan's column-tiled mma_kernel at k=20 against the forced
    quads_kernel plan (see the module's docstring)."""
    import torch
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    n_sm = cuda_build.sm_count(device.index or 0)
    out = []
    for i, (name, R, m, k, nch) in enumerate(cs.TABLES_CASES):
        if name not in QUADS_CASES:
            continue
        args = cs.tables_inputs(R, m, k, nch, 100 + i, device)
        ec, ep = dense.exact_tables(*args)
        terms = cs.tables_terms(*args)
        got = {}
        for form in ("tiles", "quads", "quads", "tiles"):
            old = set_plan(tables_cuda,
                           ["FORM=quads"] if form == "quads" else [])
            try:
                plan = tables_cuda.tables_plan(R, m, k, n_sm)
                Y, SQ, Z, _ = tables_cuda.dense_tables(*args)
                err, ok = cs.tables_errors((Y, SQ, Z), (ec.Y, ep.SQ, ep.Z),
                                           terms)
                got.setdefault(form, (Y, SQ, Z))
                dev, host = cs.stream_ms(
                    lambda: tables_cuda.dense_tables(*args))
                ev = cs.time_calls(lambda: tables_cuda.dense_tables(*args),
                                   20)
            finally:
                restore_plan(tables_cuda, old)
            out.append({"case": name, "form": form, "stream_ms": dev,
                        "host_ms": host, "events_ms": ev,
                        "worst_error": err, "within_1e-5": ok,
                        "plan": plan._asdict()})
            print(json.dumps(out[-1]), flush=True)
        out.append({"case": name, "max_abs_tiles_minus_quads": max(
            float((a - b).abs().max())
            for a, b in zip(got["tiles"], got["quads"]))})
        del args, ec, ep, terms, got
        torch.cuda.empty_cache()
    return out


def tables_times(cs, device, overrides=(), cases=()) -> list:
    """The root's tables kernel at chip_smoke's TABLES_CASES, or at those
    whose names hold one of `cases` (see the module's docstring)."""
    import torch
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    from cogaps_tpu_torch.probes import bound_ms
    set_plan(tables_cuda, overrides)
    n_sm = cuda_build.sm_count(device.index or 0)
    # an older package has no tensor-core count: its rows carry the
    # float32 bound alone
    tc_counts = getattr(tables_cuda, "tables_tc_counts", None)
    out = []
    for i, (name, R, m, k, nch) in enumerate(cs.TABLES_CASES):
        if cases and not any(c in name for c in cases):
            continue
        args = cs.tables_inputs(R, m, k, nch, 100 + i, device)
        before = tables_cuda.dense_tables.launches
        cache, phase = dense.tables(*args)
        launched = tables_cuda.dense_tables.launches - before
        ec, ep = dense.exact_tables(*args)
        err, ok = cs.tables_errors((cache.Y, phase.SQ, phase.Z),
                                   (ec.Y, ep.SQ, ep.Z),
                                   cs.tables_terms(*args))
        ok = ok and torch.equal(phase.col_nz, ep.col_nz)
        del cache, phase, ec, ep
        dev, host = cs.stream_ms(lambda: dense.tables(*args))
        ev = cs.time_calls(lambda: dense.tables(*args), 20)
        plain, _ = cs.stream_ms(lambda: dense.tables_plain(*args))
        bound, by = bound_ms(*tables_cuda.tables_counts(R, m, k, nch))
        tc, tc_by = (bound_ms(*tc_counts(R, m, k, nch), ops_per_s=495e12)
                     if tc_counts else (None, None))
        plan = tables_cuda.tables_plan(R, m, k, n_sm)
        out.append({"case": name, "stream_ms": dev, "host_ms": host,
                    "events_ms": ev, "plain_stream_ms": plain,
                    "bound_ms": bound, "bound_by": by,
                    "share": bound / dev, "tc_bound_ms": tc,
                    "tc_bound_by": tc_by,
                    "tc_share": tc / dev if tc else None,
                    "worst_error": err,
                    "within_1e-5": ok, "launches": launched,
                    "form": getattr(plan, "form",
                                    "rows" if plan.PQ == 0 else "quads"),
                    "plan": plan._asdict()})
        print(json.dumps(out[-1]), flush=True)
        del args
        torch.cuda.empty_cache()
    return out


def chisq_batched(D, invS2, M_a, M_p):
    """chi^2 by one product and one sum batched over the chains."""
    import torch
    R = (D - torch.matmul(M_a, M_p.transpose(-1, -2))) * invS2
    return torch.where(invS2 > 0, R * R / invS2,
                       torch.zeros_like(R)).sum(dim=(-2, -1))


def chisq_looped(D, invS2, M_a, M_p):
    """chi^2 with every step a chain at a time."""
    import torch
    return torch.stack([chisq_batched(D[c], invS2[c], M_a[c], M_p[c])
                        for c in range(M_a.shape[0])])


CHISQ_CALLS = (("20000x100 k=10, 16 chains", 20000, 100, 10, 16),
               ("5000x2000 k=10, 4 chains", 5000, 2000, 10, 4),
               ("GIST shape k=7, 16 chains", 1363, 9, 7, 16))
CHISQ_RUNS = (("20000x100 k=10, 16 chains", (20000, 100, 10, 16, 45), 10),
              ("GIST k=7, 16 chains", (None, 16), 7))


def chisq_times(cs, device, n_it=250) -> dict:
    """chi^2 a call by three versions, and whole runs with a chi^2
    history (see the module's docstring)."""
    import functools
    import torch
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.engine import (EQUILIBRATION, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.io import parsers
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.params import CogapsParams
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    calls = []
    for i, (name, R, m, k, nch) in enumerate(CHISQ_CALLS):
        D, inv, M_a, _ = cs.tables_inputs(R, m, k, nch, 300 + i, device)
        M_p = cs.tables_inputs(m, 1, k, nch, 400 + i, device)[2]
        for what, fn in (("package", dense.chisq_from_state),
                         ("batched", chisq_batched),
                         ("looped", chisq_looped)):
            every = fn(D, inv, M_a, M_p)
            differ = sum(not torch.equal(
                every[c], fn(D[c:c + 1], inv[c:c + 1], M_a[c:c + 1],
                             M_p[c:c + 1])[0]) for c in range(nch))
            # two calls a batch: a call may enqueue a few hundred
            # launches, and a full launch queue holds the host back
            dev, host = cs.stream_ms(lambda: fn(D, inv, M_a, M_p), reps=2)
            ev = cs.time_calls(lambda: fn(D, inv, M_a, M_p), 20)
            calls.append({"case": name, "chisq": what, "stream_ms": dev,
                          "host_ms": host, "events_ms": ev,
                          "chains_differing_from_alone": differ,
                          "chains": nch})
            print(json.dumps(calls[-1]), flush=True)
        del D, inv, M_a, M_p
    gist = parsers.read_matrix(os.path.join(HERE, "data", "GIST.csv"))[0]
    runs = []
    for name, data, k in CHISQ_RUNS:
        Ds = ([gist] * data[1] if data[0] is None
              else synthetic_dense(*data))
        for every in (0, 5, 250, 5, 0):
            params = CogapsParams(n_patterns=k, n_iterations=n_it, seed=7,
                                  output_frequency=every)
            cfg = params.engine_config(*Ds[0].shape)
            eng = MultichainEngine(stack_device_data(Ds, None, cfg, device),
                                   cfg, device)
            run_phase = functools.partial(ChainEngine.run_phase, eng)
            rand = PhiloxRandom([7 + c for c in range(len(Ds))], device)
            st, ss = eng.init_state(), eng.init_stats()
            st, ss = run_phase(st, ss, rand, EQUILIBRATION, 0, 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, ss = run_phase(st, ss, rand, EQUILIBRATION, 10, n_it)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({"config": name, "output_frequency": every,
                         "iterations": n_it - 10,
                         "wall_ms_per_iter": wall * 1e3 / (n_it - 10),
                         "chisq_evaluations": 0 if every == 0 else
                         n_it // every - 10 // every})
            print(json.dumps(runs[-1]), flush=True)
            del eng, st, ss
    return {"calls": calls, "runs": runs}


def root_sparse_tables(cs, csr, m):
    """fn(other, M) building one call's (SQ, Y0, G) as the root's package
    does on the card: its sparse tables kernel, or the cuBLAS products
    of kernel_tables on dense weights made here once (the parent's
    "dense" mode held them); and the name of that route."""
    from cogaps_tpu_torch.models import sparse
    try:
        from cogaps_tpu_torch.ops import sparse_tables_cuda
    except ImportError:
        Wd, D1 = cs.device_weights(csr, m)
        return (lambda other, M: sparse.kernel_tables(Wd, D1, other, M),
                "cuBLAS kernel_tables")
    return (lambda other, M: sparse_tables_cuda.sparse_tables(csr, other,
                                                              M),
            "sparse_tables kernel")


def sparse_tables_times(cs, device, n_warm=4) -> dict:
    """The root's sparse tables at phase 3's cases and phase 15 (c)'s
    iteration in parts in each mode (see the module's docstring)."""
    import dataclasses
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import synthetic_coo, synthetic_sparse
    from cogaps_tpu_torch.engine import EQUILIBRATION
    from cogaps_tpu_torch.parallel.sharded import ShardedRandom
    from cogaps_tpu_torch.parallel.sparse_sharded import SparseShardedEngine
    from cogaps_tpu_torch.probes import bound_ms
    try:  # the bound where the root's package counts it
        from cogaps_tpu_torch.ops.sparse_tables_cuda import (
            sparse_tables_counts as counts)
    except ImportError:
        counts = None
    [D_sparse] = synthetic_sparse(2000, 10000, 10, 1, 11)
    coo = synthetic_coo(30000, 50000, 0.02, 19)
    g = torch.Generator(device).manual_seed(41)
    cases = []
    for name, csr, m, k in cs.sparse_tables_cases(D_sparse, coo):
        csr = csr.to(device)
        nch, NR = csr.n_chains, csr.n_rows
        O = 2.0 * torch.rand((nch, m, k), generator=g, device=device)
        O[:, :, -1] = 0.0
        M = 2.0 * torch.rand((nch, NR, k), generator=g, device=device)
        fn, route = root_sparse_tables(cs, csr, m)
        big = NR * k * k > 1 << 26
        reps, tries = (3, 3) if big else (20, 5)
        dev, host = cs.stream_ms(lambda: fn(O, M), reps, tries)
        ev = cs.time_calls(lambda: fn(O, M), reps)
        nnz = int(csr.idx.numel())
        bound, by = (bound_ms(*counts(nnz, NR, m, k, nch)) if counts
                     else (None, None))
        cases.append({"case": name, "route": route, "stream_ms": dev,
                      "host_ms": host, "events_ms": ev, "bound_ms": bound,
                      "bound_by": by, "nnz": nnz})
        print(json.dumps(cases[-1]), flush=True)
        del fn, csr, O, M
        torch.cuda.empty_cache()
    modes = {}
    for mode in ("dense", "ell", "xla"):
        cfg = dataclasses.replace(cogaps_tpu_torch.CogapsParams(
            n_patterns=50, n_iterations=40, seed=19,
            output_frequency=20).engine_config(*coo.shape),
            sparse_table_mode=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = SparseShardedEngine(coo, cfg, n_shards=4, device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated() - held
        st, ss = eng.init_state(), eng.init_stats()
        st, ss = eng.run_phase(st, ss, ShardedRandom(19, device),
                               EQUILIBRATION, 0, n_warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        splits = [cs.sparse_split(eng, st, n_warm + i) for i in range(2)]
        modes[mode] = {"setup_s": setup, "setup_peak_gib":
                       setup_peak / 2**30, "iteration_peak_gib":
                       (torch.cuda.max_memory_allocated() - held) / 2**30,
                       "split_ms": splits,
                       "iteration_ms": [sum(x.values()) for x in splits]}
        print(json.dumps({mode: modes[mode]}), flush=True)
        del eng, st, ss
        torch.cuda.empty_cache()
    return {"cases": cases, "phase 15 (c)": modes}


def build_kernels():
    """The root's sweep, span and atlas kernels, built at once: {name:
    (seconds, ptxas report)}."""
    from concurrent.futures import ThreadPoolExecutor
    from cogaps_tpu_torch.ops import atlas_cuda, span_cuda, sweep_cuda

    def timed(fn):
        t0 = time.perf_counter()
        report = fn()[1]
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(3) as pool:
        futs = {"sweep": pool.submit(timed, sweep_cuda.build),
                "atlas": pool.submit(timed, atlas_cuda.build),
                "span": pool.submit(timed, span_cuda.build)}
        return {name: f.result() for name, f in futs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--out", default=None, help="JSON file to write")
    ap.add_argument("--placements", action="store_true",
                    help="time K1/K2 under other placements instead")
    ap.add_argument("--profile", action="store_true",
                    help="profile the per-call route's iterations instead")
    ap.add_argument("--golden", type=int, default=0, metavar="N",
                    help="GIST golden recovery at N seeds, kernel and "
                         "cuBLAS tables, instead")
    ap.add_argument("--quads", action="store_true",
                    help="time the column tiles against quads_kernel at "
                         "k=20 instead")
    ap.add_argument("--tables", action="store_true",
                    help="time the tables kernel at TABLES_CASES instead")
    ap.add_argument("--plan", nargs="*", default=(), metavar="NAME=VALUE",
                    help="with --tables: plan constants to override, or "
                         "FORM=quads")
    ap.add_argument("--cases", nargs="*", default=(), metavar="TEXT",
                    help="with --tables: only the cases whose names hold "
                         "one of these")
    ap.add_argument("--chisq", action="store_true",
                    help="time chi^2 calls and runs with a chi^2 history "
                         "instead")
    ap.add_argument("--span", action="store_true",
                    help="split K3 into rebuilds and sweeps at SPAN_CASES "
                         "instead")
    ap.add_argument("--sparse-tables", action="store_true",
                    help="time the sparse model's tables and phase 15 "
                         "(c)'s iteration in parts instead")
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
    if (args.profile or args.golden or args.quads or args.chisq
            or args.tables or args.span or args.sparse_tables):
        record = {"root": root, "card": cs.nvidia_smi()}
        if args.profile:
            record["profile"] = profile_times(device)
        elif args.golden:
            record["golden"] = golden_runs(device, args.golden)
            record["golden_summary"] = golden_summary(record["golden"])
        elif args.quads:
            record["quads"] = quads_times(cs, device)
        elif args.tables:
            record["tables"] = tables_times(cs, device, args.plan,
                                            args.cases)
        elif args.span:
            record["span"] = span_split(cs, device)
        elif args.sparse_tables:
            record["sparse_tables"] = sparse_tables_times(cs, device)
        else:
            record["chisq"] = chisq_times(cs, device)
        record["seconds"] = time.perf_counter() - t0
        return write(record, args.out)
    builds = build_kernels()
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
    return write(record, args.out)


def write(record, out) -> int:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
