#!/usr/bin/env python3
"""Smoke check of cogaps_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
kernels from cogaps_tpu_torch/csrc/ (sweep.cu, atlas.cu, span.cu,
tables.cu, probe_mosaic.cu and probe_dma.cu, one nvcc each, started
together),
holds each against its plain PyTorch version on the card, drives the
port's dense main path through ``CoGAPS()`` and the multi-chain
throughput harness on GIST (the fused span, and the per-call route on
the same data for comparison), runs a 5,000 x 2,000 k=10 dataset, drives
the sparse model through ``CoGAPS(sparse_optimization=True)``, the sparse
multi-chain engine and the atlas engine, runs the probe suite (the H100
counterparts of tools/probe_*.py), drives the distributed runs through
``GWCoGAPS()`` and ``scCoGAPS()`` and a checkpoint resume through
``CoGAPS()``, runs the command line (``python -m cogaps_tpu_torch``) on
a single-cell MatrixMarket file with the analysis toolkit on what it
writes, holds both kernel routes to the sequential oracle's equilibrium,
runs the gene-sharded dense and sparse engines at full width and, with
ranks that share the card, checks their bits across rank counts, and
fails on the first phase that fails. Without a CUDA device,
or without the package beside it, it exits non-zero and prints no
result.

Phases:
  1 device  — name and power limit (nvidia-smi);
  2 build   — nvcc builds of the six kernel sources, with ptxas's
              reports, and the native parser's (native/fastparse.cpp by
              the host's C++ compiler, io/native.py), all at once;
  3 kernels — kernel vs plain version on CUDA tensors, in exact mode (the
              same uniform slab) and in fast mode (in-kernel Philox);
              per-call times:
              K1, the dense sweep, at the main path's sampler shapes (GIST
              A and P and a 5000-row sampler from random atoms, and GIST A
              and P from the state after 50 per-call iterations at the
              budgets that run draws), NCH=4, and K2, the same kernel fed
              the sparse model's tables (2000 x 10000, k=10, A and P
              samplers), NCH=4: equal done, counts and elem table, mass
              and M within 1e-5, Y within 1e-3; for each case the
              shared-memory placement (ops/sweep_cuda.smem_plan), sweeps a
              call and microseconds a sweep, with ptxas's registers and
              spills of each width class of sweep_kernel;
              K4, the CSR sparse sweep, at the atlas shape (30000 x 50000,
              2% nonzeros, k=50, B=512, C=2^19, A and P samplers): equal
              done, sweeps, counts, n and elem; mass and M within atol
              5e-3, rtol 1e-4 (sums over a row's nonzeros in another
              order, tests/test_atlas_engine.py:218-227); ms a call and
              a sweep, the split of a sweep between its serial parts
              (a)+(c) and its grid-wide row sums (b) (block 0's
              %globaltimer), and F9's gather of one sweep's partner rows
              (probes/dma.gather_rows) as yardstick;
              K3, the fused span, on GIST with 16 chains (phase 5's
              width) from a state after 50 per-call equilibration
              iterations: 5-iteration spans in equilibration and in
              sampling against its plain version (ops/span.py): equal atom
              tables and counters, mass, M and the running sums within
              1e-5 (on a mismatch, one-iteration spans locate the first
              iteration that differs); its rebuild alone against numpy
              float64 tables rounded once, bit for bit, at
              tools/probe_rebuild.py's shape (384 x 9, k=7), at GIST
              (1 and 16 chains) and at 20000 x 100, k=10, 16 chains, with
              the cluster size and plans it ran and the float64
              torch.bmm of its contractions as yardstick; times per
              span, per chunk and per iteration, the kernel's time with
              every budget 0 (no sweeps), and ptxas's registers and
              spills of span_kernel and rebuild_kernel;
              the per-call tables kernel (csrc/tables.cu, through
              models/dense.tables) at GIST x1 and x16, 4 x 5000 x 2000
              k=10, 16 x 20000 x 100 k=10, one 2500 x 2000 block of
              20000 x 2000 k=10, phase 11's 4 x 5005 x 100 k=10 subsets
              and phase 14's modsim 25 x 20 k=3, each sampler A and P,
              from random
              inputs: every entry of Y, SQ and Z within 1e-5 of its
              summed |terms| of the float64 tables rounded once
              (dense.exact_tables) and no worse than twice the plain
              cuBLAS tables' own worst error, col_nz equal, one launch a
              call; ms a call by events, its device time, the plain
              cuBLAS tables' (its plain version and the library
              yardstick) both ways, the bound (tables_cuda.tables_counts)
              and the kernel's plan (its form: mma_kernel's tensor-core
              or short-row form, in column tiles above k = 12
              (mma_tiles_kernel), rows_kernel or quads_kernel) and
              ptxas's registers and spills; the same at k=20 (4 x 5000
              x 2000, 16 x 20000 x 100), k=50 (4 x 5000 x 2000), GIST
              x1 k=13, k=80 and k=100 (4 x 5000 x 2000), 100 x 100 k=90
              and 300 x 400 k=150 (Y's columns over two column tiles),
              with the tensor-core bound (tables_cuda.tables_tc_counts,
              TF32 at 495 TFLOP/s) beside the float32 one, and each
              case's kernel's registers, spills and shared bytes; and
              simt_tiles_kernel's ground (below 64 partners above k =
              12), 20000 x 40 A at k=20 and k=39 and GIST x1 k=13, each
              beside quads_kernel forced on the same inputs (its stream
              ms, and the bits equal), with rows_kernel at 20000 x 40 A
              k=10 as a yardstick;
  4 CoGAPS  — CoGAPS("data/GIST.csv", k=7, 2000 iterations, device=cuda,
              debug_checks=True): meanChiSq below 2x the golden GIST
              value, the kernel launched at least twice per iteration of
              each phase, the tables kernel exactly twice an iteration,
              and utils/debug.check_state passed after each phase; then
              CoGAPS() on a 100 x 100 matrix at k=90, 100 + 100
              iterations, and one chain of it in a MultichainEngine whose
              gate must refuse K3 (above k = 88 it cannot launch): each
              a finite meanChiSq, no K3 launch and the tables kernel in
              column tiles twice an iteration;
  5 throughput — run_throughput on GIST, 16 chains, 2000 iterations (the
              fused span: K3 launched, the per-call sweep kernel not),
              then the per-call route on the same data and seeds
              (ChainEngine.run_phase, the tables kernel twice an
              iteration): the same gate for each; updates/s of each;
  6 realistic — 4 chains of a synthetic 5000 x 2000 matrix (k=10), 100
              iterations per phase: a finite, falling chi^2 history;
              updates/s, peak device memory, tables launches (two an
              iteration); then the same data at k=20 and at k=100, 50
              iterations per phase, both samplers' tables in column
              tiles: the same checks; then CoGAPS() on a synthetic
              20000 x 40 matrix (bulk data of few samples) at k=20, 100 +
              100 iterations, one chain: a finite, falling chi^2 history,
              A's tables in simt_tiles_kernel once an iteration, P's in
              column tiles; seconds, updates/s, peak memory;
  7 sparse  — the iteration time of each sparse mode (dense, ell, xla)
              from one state of a 2000 x 10000 k=10 matrix with 87%
              structural zeros, then CoGAPS(sparse_optimization=True,
              k=10, 500 iterations, debug_checks=True): finite meanChiSq,
              chi^2 history falling 5x, two kernel launches per
              iteration, the sparse state checked after each phase;
  8 sparse multichain — SparseMultichainEngine, 4 such chains, 200 + 200
              iterations: finite, falling chi^2 in every chain; updates/s
              and peak memory;
  9 atlas   — AtlasEngine (the engine of run_atlas) on a 30000 x 50000
              COO matrix with 2% nonzeros, k=50, 100 + 100 iterations:
              finite, falling chi^2, M equal to the atom masses per
              element within 2e-4, two K4 launches per iteration;
              updates/s, peak memory, set-up time;
  10 probes — cogaps_tpu_torch.probes' suite (python -m
              cogaps_tpu_torch.probes): first the launch floor (an empty
              kernel of probe_mosaic.cu, timed as the cases are, and back
              to back) and the dependent-load floor (one lane's chain of
              16 and of 80 dependent 4-byte loads over the 512 MiB table,
              against which F9's 16 and 80 dependent passes are stated);
              then each of the eleven probe functions F1-F11 at
              the probes' shapes and the port's (F3 at all five of PERF.md
              §6's, exact; F7's sum at (8,128,256), within 1e-6), its
              kernel held to its plain version (exact, or within the
              function's stated tolerance) and timed beside its plain
              version, its library call, its bound and the floor;
  11 distributed — first K3 against its plain version on unequal gene
              subsets padded with invS2 = 0 (4990/5000/5005/5005 of a
              20000 x 100 matrix, 3 iterations: decision-exact, the
              padded rows changing nothing) and one 50-iteration K3 launch
              there timed against span_bound_ms; then GWCoGAPS on
              synthetic_dense(20000, 100, 10) (bulk RNA-seq: four
              5000-gene subsets, k=10, 500 + 500 iterations a stage,
              output_frequency 0) and scCoGAPS on synthetic_sparse(2000,
              40000, 10) (four 10,000-cell subsets, the sparse model,
              k=10, 300 + 300): the stitched free factor finite and
              nonzero, the fixed one zero, the input order restored,
              chi^2 of D against the stitched factor and the consensus at
              most 0.2x the zero model's (under the default uncertainty,
              and max(0.1 D, 0.1) for the sparse model); GWCoGAPS's free
              stage launches K3 once a 50-iteration chunk and its fixed
              stage K1 once an iteration, scCoGAPS's stages the sparse
              kernels once a sampler call; seconds, updates/s and
              launches of each stage (the result's
              diagnostics["stages"]; the tables kernel once an iteration of
              GWCoGAPS's fixed stage, never in scCoGAPS), the sparse mode,
              k_out and peak
              device memory; and between the two, GWCoGAPS on the same
              data at 200 + 200 a stage on 2 and then on 4 ranks that
              share the card (parallel/launch.py, gloo; the subset chains
              on the JAX rule's mesh, distributed.subset_mesh), each
              rank's Amean, Asd, Pmean, Psd, meanChiSq and consensus
              bit-equal to the same call in this process, the ranks'
              summed K3 and K1 launches n times its own, each run's
              seconds;
  12 checkpoints — CoGAPS on GIST (k=7, 1000 + 1000 iterations) with a
              checkpoint every 250 iterations into a temporary file,
              resumed from the file it leaves (sampling iteration 750)
              with seed=99, and run without checkpoints: Amean, Pmean,
              Asd and meanChiSq bit-equal in all three.
  13 cli    — the 2000 x 10000 k=10 sparse matrix of phases 3 and 7
              (one scCoGAPS worker's single-cell subset) written as a
              MatrixMarket file, read by the native parser (what
              read_matrix chooses) and by the Python parser: equal
              matrices and names, each one's seconds; then ``python -m
              cogaps_tpu_torch <file>.mtx --sparse --n-patterns 10
              --n-iterations 500 --output-frequency 50 -o <tmp>/out --csv
              --seed 13`` as a subprocess with no --device: a finite
              meanChiSq and updates in its summary line, diagnostics
              ["device"] CUDA, the chi^2 history falling 5x, from_csv of
              its CSV files equal to load of its npz (the %.10g text
              holds a float32); the same argv through __main__.main in
              this process under the launch counters: K2 launched at least
              twice an iteration, K4 never, the result bit-equal to the
              subprocess's; then pattern_markers, calc_z,
              calc_cogaps_stat (5 seeded gene sets of 50),
              get_pattern_gene_set (enrichment, 100 permutations) and
              manova (3 seeded groups of the 10,000 cells) on the loaded
              result: each finite and of its shape, with its seconds;
              and build_report().
  14 oracle — the numpy SequentialOracle (cogaps_tpu_torch/oracle.py) on
              modsim (25 x 20, k=3, tests/conftest.py's seed) with seeds
              0-3, 600 + 600 iterations, one host process a seed, and
              after it the port on the card with the same seeds and
              iterations: the per-call route (a one-chain GapsEngine a
              seed; K1, never K3) and the fused route (a 4-chain
              MultichainEngine, output_frequency 0; K3, never K1); each
              route's mean chi^2 within 25% of the oracle's and its mean
              atom counts within 30% (tests/test_oracle.py:68-75), the
              three runs' means printed; K1's two calls of one more
              iteration and a 5-iteration K3 span from the routes' final
              states, each against its plain version;
  15 sharded — first, bits across rank counts with ranks sharing the
              card over gloo (spawned, joined with a timeout): (b) the
              dense engine of (a), 20 + 20, on 2 and 4 ranks, and a
              checkpoint written by 2 ranks at sampling iteration 10;
              (d) synthetic_sparse(2000, 10000, 10), n_shards=4, 5 + 5,
              on 2 ranks; (e) 16 GIST chains (the fused span), 100 + 100,
              on 2 ranks, their checkpoint after equilibration; and with
              (b) the per-call route with a chain mesh: 8 chains of
              synthetic_dense(2000, 200, 10) (200 samples, above the fused
              route's 128; a chi^2 history every 5), 30 + 30, on 2 and 4
              ranks, the tables kernel twice an iteration. Then,
              with the card to itself: (a) ShardedGapsEngine on
              synthetic_dense(20000, 2000, 10), n_blocks=8, mesh=None,
              200 + 200: a finite, falling chi^2 history, the trimmed
              shape, P's atom masses on M_p within 0.01 x max(1, max
              M_p), K1 and the tables kernel launched exactly twice an
              iteration (the rank's blocks the chains of one call); (c)
              SparseShardedEngine on synthetic_coo(30000, 50000, 0.02),
              k=50, n_shards=4, mesh=None, 40 + 40: a finite, falling
              chi^2, P's drift as in (a), the mode the rule chose,
              exactly its launches (K2 twice an iteration, or K2 and K4
              once each in "xla" mode) and one more iteration timed in
              parts (A tables, A launch, P table build, their sum, P's K2
              launch); each with its seconds, seconds an iteration,
              updates/s, peak memory and launches, and with its update
              calls of one more iteration held against their plain
              versions; then (b), (d) and (e) on one rank and the two
              resumes on 1: every leaf of state and statistics
              bit-equal to the ranks' runs.

The last line is {"ok": true, "device": {...}}; the one before it is the
card's name and power limit; before that, one JSON line describing each
kernel of the path ("ms" by CUDA events around back-to-back calls; for
K1 and K2 also "device_ms", the kernel's own device time by
torch.profiler: their calls are short enough that the events time the
wrapper's host work too; for the tables kernel "device_ms" is the
stream's ms a call, the host held out of the way; "launches" summed over the main-path phases
that run the kernel, "launches_by_phase" each phase's count).
"""

import collections
import ctypes
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GIST_CSV = os.path.join(HERE, "data", "GIST.csv")
GIST_NPZ = os.path.join(HERE, "data", "gist.npz")
TOL_MASS_M = 1e-5  # tests/test_pallas_sweep.py:61-73
TOL_Y = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants (Linux
    prctl(PR_SET_CHILD_SUBREAPER)): a process whose parent ends before it
    (a spawned rank's helper, a compiler's child) becomes this process's
    child, so stop_descendants() finds it."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def descendants() -> list:
    """(pid, command line) of every live process below this one, read
    from /proc."""
    children = collections.defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the fields after the command's closing parenthesis: state, ppid
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z":
            children[int(fields[1])].append(int(entry))
    found, todo = [], [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode().strip()
            except OSError:
                cmd = "?"
            found.append((pid, cmd))
            todo.append(pid)
    return found


def stop_descendants(wait: float = 10.0) -> list:
    """Stop every process this one started that still runs: first the
    multiprocessing resource tracker that spawned processes start (it
    lives until its parent ends, unless stopped), then any other
    descendant by SIGTERM and, after `wait` seconds, SIGKILL. Reaps them,
    and returns the command lines of those it had to signal."""
    from multiprocessing import resource_tracker
    tracker = getattr(resource_tracker, "_resource_tracker", None)
    if getattr(tracker, "_pid", None) is not None and hasattr(tracker,
                                                               "_stop"):
        tracker._stop()
    left = descendants()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, _ in descendants():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline:
            try:
                while os.waitpid(-1, os.WNOHANG)[0] > 0:
                    pass
            except ChildProcessError:
                pass
            if not descendants():
                break
            time.sleep(0.05)
    return [cmd for _, cmd in left]


def gist_golden_mcs() -> float:
    return float(np.asarray(np.load(GIST_NPZ)["golden_meanChiSq"]).reshape(-1)[0])


# ----------------------------------------------------------------------
# phase 3: kernel vs plain
# ----------------------------------------------------------------------
def make_case(name, D, rows_are_genes, k, B, C, nch, budget, seed, device):
    """NCH sampler states for D (rows x m after orienting), made from a
    numpy seed: random compact atom tables, M from them, a gamma partner
    factor, and the tables of one update call."""
    import torch
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops.atoms import AtomTable, total_mass_per_element
    from cogaps_tpu_torch.ops.sweep import MassParams, make_consts

    rng = np.random.default_rng(seed)
    Dm = D if rows_are_genes else D.T
    NR, m = Dm.shape
    NB = NR * k
    invS2 = 1.0 / np.maximum(0.1 * Dm, 0.1) ** 2
    lam = dense.compute_lambda(D, 0.01, k)
    mass_list, elem_list, n_list, other_list = [], [], [], []
    for _ in range(nch):
        n0 = int(min(C // 4, NB // 3))
        elem = np.full(C, -1, np.int32)
        elem[:n0] = rng.integers(0, NB, n0)
        mass = np.zeros(C, np.float32)
        mass[:n0] = rng.gamma(2.0, 0.5, n0)
        mass_list.append(mass)
        elem_list.append(elem)
        n_list.append(n0)
        other_list.append(rng.gamma(2.0, 1.0, (m, k)).astype(np.float32))
    to = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)  # noqa: E731
    atoms = AtomTable(mass=to(np.stack(mass_list)), elem=to(np.stack(elem_list)),
                      n=to(np.asarray(n_list, np.int32)))
    M = torch.stack([total_mass_per_element(atoms.chain(c), NB).reshape(NR, k)
                     for c in range(nch)])
    other = to(np.stack(other_list))
    Dt = to(np.broadcast_to(Dm, (nch, NR, m)).astype(np.float32))
    inv = to(np.broadcast_to(invS2, (nch, NR, m)).astype(np.float32))
    Y = dense.rebuild_cache(Dt, inv, M, other).Y
    phase = dense.make_phase(inv, other)
    consts = make_consts(NR, m, k, C, B, 0.01)
    mass_p = MassParams(lam=to(np.full(nch, lam, np.float32)),
                        max_gibbs_mass=to(np.full(nch, 100.0 / lam, np.float32)))
    budgets = to(np.full(nch, budget, np.int32))
    return dict(name=name, atoms=atoms, M=M, Y=Y, phase=phase, consts=consts,
                mass=mass_p, budgets=budgets, nch=nch, B=B)


def compare(case, out_k, out_p, what):
    """Decision-exact agreement; returns the largest absolute difference
    of mass, M and Y."""
    a_k, M_k, Y_k, done_k, ns_k, cnt_k = out_k
    a_p, M_p, Y_p, done_p, ns_p, cnt_p = out_p
    problems = []
    for label, x, y in (("done", done_k, done_p), ("sweeps", ns_k, ns_p),
                        ("n", a_k.n, a_p.n),
                        ("processed", cnt_k.processed, cnt_p.processed),
                        ("accepted", cnt_k.accepted, cnt_p.accepted),
                        ("elem", a_k.elem, a_p.elem)):
        if not np.array_equal(x.cpu().numpy(), y.cpu().numpy()):
            problems.append(label)
    errs = {}
    for label, x, y, tol in (("mass", a_k.mass, a_p.mass, TOL_MASS_M),
                             ("M", M_k, M_p, TOL_MASS_M),
                             ("Y", Y_k, Y_p, TOL_Y)):
        x, y = x.double().cpu().numpy(), y.double().cpu().numpy()
        errs[label] = float(np.abs(x - y).max())
        if not np.all(np.abs(x - y) <= tol + tol * np.abs(y)):
            problems.append(label)
    log(f"  {case['name']} {what}: done {done_k.tolist()} sweeps "
        f"{ns_k.tolist()} accepted/processed "
        f"{int(cnt_k.accepted.sum())}/{int(cnt_k.processed.sum())} "
        f"max|diff| mass {errs['mass']:.3g} M {errs['M']:.3g} "
        f"Y {errs['Y']:.3g}")
    return problems, max(errs.values())


def locate_divergence(case, source):
    """Step kernel and plain version sweep by sweep (exact mode) and
    print the first sweep after which they differ, with the lanes of
    that sweep that touch a differing row."""
    import torch
    from cogaps_tpu_torch.ops import sweep_cuda
    args = (case["atoms"], case["M"], case["Y"], case["phase"],
            case.get("temp", 1.0), case["budgets"], case["consts"],
            case["mass"], source)
    K = case["consts"].k
    for j in range(1, 10_000):
        k_out = sweep_cuda.run_updates_multi(*args, max_sweeps=j)
        p_out = sweep_cuda.run_updates_multi_plain(*args, max_sweeps=j)
        for c in range(case["nch"]):
            dM = (k_out[1][c] - p_out[1][c]).abs().reshape(-1)
            de = (k_out[0].elem[c] != p_out[0].elem[c])
            if bool(de.any()) or float(dM.max()) > TOL_MASS_M:
                rows = sorted(set((torch.nonzero(dM > TOL_MASS_M).flatten()
                                   // K).tolist()))
                log(f"  first difference: chain {c}, sweep {j - 1}; "
                    f"differing rows {rows[:8]}, slots "
                    f"{torch.nonzero(de).flatten().tolist()[:8]}")
                prev = sweep_cuda.run_updates_multi_plain(
                    *args, max_sweeps=j - 1)
                uni = source(c, j - 1, 1)
                elem = prev[0].elem[c]
                n = int(prev[0].n[c])
                B = case["B"]
                for lane in range(B):
                    u = uni[:, lane].tolist()
                    a1 = min(int(u[5] * max(n, 1)), max(n, 1) - 1)
                    r1 = int(elem[a1]) // K if n else -1
                    if r1 in rows or lane < 2:
                        kind = ("birth/death" if u[0] < 0.5 else
                                "move" if u[0] < 0.75 else "exchange")
                        e1 = int(elem[a1]) if n else 0
                        s = float(case["phase"].SQ[c].reshape(-1)[e1])
                        smu = float(prev[2][c].reshape(-1)[e1])
                        log(f"    lane {lane}: {kind} row {r1} s {s:.9g} "
                            f"s_mu {smu:.9g} u {[f'{x:.9g}' for x in u[:9]]}")
                return
        if bool((k_out[3] >= case["budgets"]).all()):
            return


def time_calls(fn, reps):
    """ms per call of fn() by CUDA events, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, name, reps=5, sessions=3):
    """Mean device time in ms per call of fn() of the kernels whose name
    holds `name` (torch.profiler's CUDA events), after a warm-up call:
    the kernel alone, without the host work around its launches. A
    session of torch.profiler now and then records none of the card's
    events: up to `sessions` are tried."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and name in e.name())
        if ns:
            return ns * 1e-6 / reps
    raise RuntimeError(f"torch.profiler recorded no {name} on the card in "
                       f"{sessions} sessions")


def stream_ms(fn, reps=20, tries=5):
    """(device ms, host ms) a call of fn(), medians of `tries` batches of
    reps calls: the device's time for the batch run back to back at its
    own pace, gaps between kernels included, and the host's time to
    enqueue it. Each batch is enqueued behind a spin kernel that
    outlasts its enqueueing, so the host never starves the stream
    (checked: the event after the spin has not completed when the last
    call is enqueued)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    streams, hosts, cycles = [], [], 1 << 26
    while len(streams) < tries:
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        ahead = not start.query()
        stop.record()
        torch.cuda.synchronize()
        if ahead:
            streams.append(start.elapsed_time(stop) / reps)
            hosts.append(host)
        elif cycles < 1 << 32:
            cycles *= 4
        else:
            raise RuntimeError("the host never got ahead of the stream")
    return float(np.median(streams)), float(np.median(hosts))


def time_plain(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def uniform_source(nch, B, device, seed=7, sweeps=512):
    import torch
    slab = torch.as_tensor(np.random.default_rng(seed).random(
        (nch, sweeps * 16, B), dtype=np.float32), device=device)

    def source(c, first, n):
        if (first + n) * 16 > slab.shape[1]:
            raise RuntimeError("uniform slab used up")
        return slab[c, first * 16:(first + n) * 16]

    return source


def random_atoms(rng, nch, NR, k, C, device):
    """Compact atom tables of n0 = min(C/4, NB/3) random atoms per chain
    and M from them."""
    import torch
    from cogaps_tpu_torch.ops.atoms import AtomTable, total_mass_per_element
    NB = NR * k
    n0 = int(min(C // 4, NB // 3))
    elem = np.full((nch, C), -1, np.int32)
    mass = np.zeros((nch, C), np.float32)
    for c in range(nch):
        elem[c, :n0] = rng.integers(0, NB, n0)
        mass[c, :n0] = rng.gamma(2.0, 0.5, n0)
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    atoms = AtomTable(mass=to(mass), elem=to(elem),
                      n=to(np.full(nch, n0, np.int32)))
    M = torch.stack([total_mass_per_element(atoms.chain(c), NB).reshape(NR, k)
                     for c in range(nch)])
    return atoms, M


# bytes and float32 operations of one update call that the bound counts
# (PERF.md section 6): each proposal touches one row (birth, death) or
# two (move, exchange); the atom table is read and written once
def sweep_work(processed, n_atoms, row_bytes, prop_flops, fixed_bytes=0):
    p = np.asarray(processed.cpu(), np.int64).reshape(-1, 4)
    rows = p[:, 0] + p[:, 1] + 2 * (p[:, 2] + p[:, 3])
    n_bytes = (fixed_bytes + float(rows.sum()) * row_bytes
               + 16.0 * float(np.asarray(n_atoms.cpu(), np.int64).sum()))
    return n_bytes, float(p.sum()) * prop_flops


def sweep_bound_ms(processed, n_atoms, row_bytes, prop_flops,
                   fixed_bytes=0):
    from cogaps_tpu_torch.probes import bound_ms
    return bound_ms(*sweep_work(processed, n_atoms, row_bytes, prop_flops,
                                fixed_bytes))


def tables_case(name, D, rows_are_genes, k, B, C, nch, budget, seed, device):
    """NCH sparse-model sampler states and the (SQ, Y0, G) tables of one
    update call (models/sparse.kernel_tables), made from a numpy seed as
    make_case makes the dense ones."""
    import torch
    from cogaps_tpu_torch.models import dense, sparse
    from cogaps_tpu_torch.ops.sweep import MassParams, make_consts
    rng = np.random.default_rng(seed)
    Dm = D if rows_are_genes else D.T
    NR, m = Dm.shape
    r, c = np.nonzero(Dm)
    csr = sparse.coo_to_csr(r, c, Dm[r, c], NR)
    Wd, D1 = (w[0].to(device) for w in sparse.dense_weights(csr, m))
    atoms, M = random_atoms(rng, nch, NR, k, C, device)
    other = torch.as_tensor(rng.gamma(2.0, 1.0, (nch, m, k)).astype(
        np.float32), device=device)
    SQ, Y0, G = sparse.kernel_tables(Wd, D1, other, M)
    phase = dense.DensePhase(SQ=SQ, Z=G, col_nz=other.amax(dim=1) > 0.0)
    lam = 0.01 * float(np.sqrt(k / Dm[Dm != 0].mean()))
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return dict(name=name, atoms=atoms, M=M, Y=Y0, phase=phase,
                consts=make_consts(NR, m, k, C, B, 0.01),
                mass=MassParams(lam=to(np.full(nch, lam, np.float32)),
                                max_gibbs_mass=to(np.full(nch, 100.0 / lam,
                                                          np.float32))),
                budgets=to(np.full(nch, budget, np.int32)), nch=nch, B=B)


def gist_state_cases(device, nch=4, seed=31, n_it=50):
    """GIST's A and P sampler cases from the state of nch chains after
    n_it per-call equilibration iterations, at the budgets and the
    temperature of iteration n_it (the sweeps a call of a real run)."""
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import throughput_engine
    from cogaps_tpu_torch.engine import (EQUILIBRATION, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.io import parsers
    D, _, _ = parsers.read_matrix(GIST_CSV)
    eng, _ = throughput_engine(D, cogaps_tpu_torch.CogapsParams(
        n_patterns=7, n_iterations=2000, seed=seed, output_frequency=0),
        nch, None, device)
    rand = PhiloxRandom([seed + c for c in range(nch)], device)
    st, _ = ChainEngine.run_phase(eng, eng.init_state(), eng.init_stats(),
                                  rand, EQUILIBRATION, 0, n_it)
    cases = []
    for side, args in zip("AP", chain_calls(eng, st, rand, EQUILIBRATION,
                                            n_it)):
        atoms, M, Y, phase, temp, budgets, consts, mass, _ = args
        cases.append(dict(
            name=(f"GIST {side} after {n_it} iterations ({consts.n_rows}x"
                  f"{consts.m}, k=7, B={consts.batch}, C={consts.capacity},"
                  f" atoms {atoms.n.tolist()})"),
            atoms=atoms, M=M, Y=Y, phase=phase, consts=consts,
            mass=mass, budgets=budgets, nch=nch, B=consts.batch, temp=temp))
    return cases


def chain_calls(eng, st, rand, phase, it):
    """The arguments of iteration `it`'s two sweep-kernel calls of a
    ChainEngine from state st, as engine.run_iteration builds them: the
    A sampler's, then the P sampler's (on st's M_a), each with the
    iteration's budgets, temperature and Philox key."""
    from cogaps_tpu_torch.engine import SAMPLER_A, SAMPLER_P, annealing_temp
    from cogaps_tpu_torch.models import dense
    n_a, n_p = rand.budgets(phase, it, st.atoms_a.n, st.atoms_p.n)
    temp = annealing_temp(eng.config, phase, it)
    d = eng.data
    calls = []
    for atoms, M, tabs, consts, mass, budgets, sampler in (
            (st.atoms_a, st.M_a, (d.D, d.invS2, st.M_a, st.M_p),
             eng.consts_a, d.mass_a, n_a, SAMPLER_A),
            (st.atoms_p, st.M_p, (d.D_t, d.invS2_t, st.M_p, st.M_a),
             eng.consts_p, d.mass_p, n_p, SAMPLER_P)):
        cache, tphase = dense.tables(*tabs)
        calls.append((atoms, M, cache.Y, tphase, temp, budgets, consts, mass,
                      rand.sweeps(phase, it, sampler)))
    return calls


def check_call(name, args, atlas=False):
    """One update call of a main path at its own shapes, the kernel
    against its plain version on the same arguments (the path's Philox
    key): decisions exact, mass and M within phase 3's tolerances
    (compare, compare_atlas for K4). Returns the largest |difference|;
    raises on a mismatch."""
    import torch
    from cogaps_tpu_torch.ops import atlas_cuda, sweep_cuda
    if atlas:
        kernel, plain, cmp = (atlas_cuda.run_updates_atlas_multi,
                              atlas_cuda.run_updates_atlas_multi_plain,
                              compare_atlas)
    else:
        kernel, plain, cmp = (sweep_cuda.run_updates_multi,
                              sweep_cuda.run_updates_multi_plain, compare)
    out_k = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = plain(*args)
    torch.cuda.synchronize()
    problems, err = cmp({"name": name}, out_k, out_p,
                        f"kernel vs plain ({time.perf_counter() - t0:.1f} s "
                        f"plain)")
    if problems:
        raise AssertionError(f"{name}: kernel and plain version disagree: "
                             f"{problems}")
    return err


def sweep_classes(report):
    """ptxas's (registers, spill bytes) of each width class of the sweep
    kernel, as a printable string."""
    return ", ".join(
        f"B<={t}: {ptxas_of(report, f'sweep_kernelILi{t}E')}"
        for t in (32, 256, 1024))


def run_sweep_cases(cases, device, reps=10):
    """K1/K2 cases: kernel vs plain in both modes, then per-call times in
    fast mode: CUDA events over back-to-back calls (the wrapper's host
    work included where it outlasts the kernel), the kernel's own device
    time, and the call's stream and host times (stream_ms). Returns
    (rows, max_err) with rows (name, ms, plain ms, bound ms, bound_by,
    sweeps a call, device us a sweep, placement, device ms)."""
    import torch
    from cogaps_tpu_torch.ops import sweep_cuda
    results, failed, max_err = [], [], 0.0
    for case in cases:
        nch, B, K = case["nch"], case["B"], case["consts"].k
        source = uniform_source(nch, B, device)
        key = sweep_cuda.PhiloxKey(
            key0=torch.arange(11, 11 + nch, device=device), key1=5)
        args = (case["atoms"], case["M"], case["Y"], case["phase"],
                case.get("temp", 1.0), case["budgets"], case["consts"],
                case["mass"])
        for what, rand in (("exact", source), ("fast", key)):
            out_k = sweep_cuda.run_updates_multi(*args, rand)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p = sweep_cuda.run_updates_multi_plain(*args, rand)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3  # fast mode's is kept
            problems, err = compare(case, out_k, out_p, what)
            max_err = max(max_err, err)
            if problems:
                log(f"  MISMATCH ({what}): {problems}")
                if what == "exact":
                    locate_divergence(case, source)
                failed.append((case["name"], what))
        out_k = sweep_cuda.run_updates_multi(*args, key)
        k_ms = time_calls(lambda: sweep_cuda.run_updates_multi(*args, key),
                          reps)
        dev_ms = device_ms(lambda: sweep_cuda.run_updates_multi(*args, key),
                           "sweep_kernel", reps)
        s_ms, h_ms = stream_ms(lambda: sweep_cuda.run_updates_multi(*args,
                                                                    key))
        bound, by = sweep_bound_ms(
            out_k[5].processed, out_k[0].n, 4 * (5 * K + K * K), 300 + 2 * K)
        c = case["consts"]
        plan = sweep_cuda.smem_plan(c.n_rows, K, c.capacity, B, nch)
        sweeps = out_k[4].tolist()
        us = dev_ms * 1e3 / max(max(sweeps), 1)
        log(f"  {case['name']}: kernel {k_ms:.4f} ms/call ({dev_ms:.4f} ms "
            f"on the device; the call's stream {s_ms:.4f} ms, its host "
            f"{h_ms:.4f} ms), plain {p_ms:.1f} ms/call, bound {bound:.6f} ms"
            f" ({by}) (budgets {case['budgets'].tolist()}); sweeps a call "
            f"{sweeps}, {us:.3f} us a sweep on the device; placement: "
            f"{plan.describe()}")
        results.append((case["name"], k_ms, p_ms, bound, by, sweeps, us,
                        plan.describe(), dev_ms))
    if failed:
        raise AssertionError(f"kernel and plain version disagree: {failed}")
    return results, max_err


def sweep_cases(device, D_sparse):
    """Phase 3's K1 cases (GIST A and P and a 5000-row sampler from random
    atoms, GIST A and P from a run's state) and K2 cases (the sweep
    kernel on the tables of D_sparse, synthetic_sparse(2000, 10000, 10,
    1, 11)): (K1's, K2's), 4 chains each."""
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.io import parsers
    D_gist, _, _ = parsers.read_matrix(GIST_CSV)
    [D_big] = synthetic_dense(5000, 2000, 10, 1, 0)
    k1 = [
        make_case("GIST A sampler (1363x9, k=7, B=1024, C=8192)", D_gist,
                  True, 7, 1024, 8192, 4, 4000, 1, device),
        make_case("GIST P sampler (9x1363, k=7, B=32, C=1024)", D_gist,
                  False, 7, 32, 1024, 4, 2000, 2, device),
        make_case("5000-row sampler (5000x2000, k=10, B=1024, C=32768)",
                  D_big, True, 10, 1024, 32768, 4, 4000, 3, device),
    ] + gist_state_cases(device)
    k2 = [
        tables_case("tables A sampler (2000x10000, k=10, B=1024, C=16384)",
                    D_sparse, True, 10, 1024, 16384, 4, 4000, 4, device),
        tables_case("tables P sampler (10000x2000, k=10, B=1024, C=65536)",
                    D_sparse, False, 10, 1024, 65536, 4, 4000, 5, device),
    ]
    return k1, k2


TOL_ATLAS_ATOL, TOL_ATLAS_RTOL = 5e-3, 1e-4


def atlas_case(name, csr, m, k, B, C, budget, seed, device):
    import torch
    from cogaps_tpu_torch.ops.sweep import MassParams, make_consts
    rng = np.random.default_rng(seed)
    NR = csr.n_rows
    atoms, M = random_atoms(rng, 1, NR, k, C, device)
    other = torch.as_tensor(rng.gamma(2.0, 1.0, (1, m, k)).astype(
        np.float32), device=device)
    lam = 0.01 * float(np.sqrt(k / float(csr.val.mean())))
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return dict(name=name, atoms=atoms, M=M, csr=csr, other=other,
                consts=make_consts(NR, m, k, C, B, 0.01),
                mass=MassParams(lam=to(np.float32([lam])),
                                max_gibbs_mass=to(np.float32([100.0 / lam]))),
                budgets=to(np.int32([budget])), B=B)


def compare_atlas(case, out_k, out_p, what):
    """The per-call contract of tests/test_atlas_engine.py:218-227, plus
    n and elem; returns (problems, max |diff| of mass and M)."""
    a_k, M_k, done_k, ns_k, cnt_k = out_k
    a_p, M_p, done_p, ns_p, cnt_p = out_p
    problems = []
    for label, x, y in (("done", done_k, done_p), ("sweeps", ns_k, ns_p),
                        ("n", a_k.n, a_p.n),
                        ("processed", cnt_k.processed, cnt_p.processed),
                        ("accepted", cnt_k.accepted, cnt_p.accepted),
                        ("elem", a_k.elem, a_p.elem)):
        if not np.array_equal(x.cpu().numpy(), y.cpu().numpy()):
            problems.append(label)
    errs = {}
    for label, x, y in (("mass", a_k.mass, a_p.mass), ("M", M_k, M_p)):
        x, y = x.double().cpu().numpy(), y.double().cpu().numpy()
        errs[label] = float(np.abs(x - y).max())
        if not np.all(np.abs(x - y)
                      <= TOL_ATLAS_ATOL + TOL_ATLAS_RTOL * np.abs(y)):
            problems.append(label)
    log(f"  {case['name']} {what}: done {done_k.tolist()} sweeps "
        f"{ns_k.tolist()} accepted/processed {cnt_k.accepted.tolist()}/"
        f"{cnt_k.processed.tolist()} max|diff| mass {errs['mass']:.3g} "
        f"M {errs['M']:.3g}")
    return problems, max(errs.values())


def locate_atlas_divergence(case, source):
    """Step K4 and its plain version sweep by sweep (exact mode); print
    the first sweep after which they differ and its lanes that touch a
    differing row."""
    import torch
    from cogaps_tpu_torch.ops import atlas_cuda
    args = (case["atoms"], case["M"], case["csr"], case["other"], 1.0,
            case["budgets"], case["consts"], case["mass"], source)
    K = case["consts"].k
    for j in range(1, 1000):
        k_out = atlas_cuda.run_updates_atlas_multi(*args, max_sweeps=j)
        p_out = atlas_cuda.run_updates_atlas_multi_plain(*args, max_sweeps=j)
        dM = (k_out[1][0] - p_out[1][0]).abs().reshape(-1)
        de = k_out[0].elem[0] != p_out[0].elem[0]
        if bool(de.any()) or float(dM.max()) > TOL_ATLAS_ATOL:
            rows = sorted(set((torch.nonzero(dM > TOL_ATLAS_ATOL).flatten()
                               // K).tolist()))
            log(f"  first difference: sweep {j - 1}; rows {rows[:8]}, "
                f"slots {torch.nonzero(de).flatten().tolist()[:8]}, "
                f"max |dM| {float(dM.max()):.3g}")
            prev = atlas_cuda.run_updates_atlas_multi_plain(
                *args, max_sweeps=j - 1)
            uni = source(0, j - 1, 1)
            elem, n = prev[0].elem[0], int(prev[0].n[0])
            for lane in range(case["B"]):
                u = uni[:, lane].tolist()
                a1 = min(int(u[5] * max(n, 1)), max(n, 1) - 1)
                r1 = int(elem[a1]) // K if n else -1
                if r1 in rows:
                    kind = ("birth/death" if u[0] < 0.5 else
                            "move" if u[0] < 0.75 else "exchange")
                    log(f"    lane {lane}: {kind} row {r1} "
                        f"u {[f'{x:.9g}' for x in u[:9]]}")
            return
        if bool((k_out[2] >= case["budgets"]).all()):
            return


def sweep_gather_ms(case, uni):
    """The partner rows of one K4 sweep (its kept rows' nonzeros, by the
    kernel's work schedule, on the uniform block `uni`) and the median ms
    of F9's gather_rows of them (probes/dma.py)."""
    import torch
    from cogaps_tpu_torch.ops import atlas_cuda
    from cogaps_tpu_torch.ops import sweep as sweep_ops
    from cogaps_tpu_torch.probes import dma
    from cogaps_tpu_torch.probes.__main__ import device_ms as probe_ms
    q = sweep_ops.propose(uni, case["atoms"].chain(0),
                          int(case["budgets"][0]), case["consts"])
    pair = q.is_move | q.is_exch
    items, _, _ = atlas_cuda.work_items_plain(
        case["csr"].indptr.cpu(), torch.where(q.keep, q.r1, -1)[None].cpu(),
        torch.where(pair, q.r2, -1)[None].cpu())
    n = items[:, 4] - items[:, 3]
    pos = torch.repeat_interleave(items[:, 3], n) + torch.arange(
        int(n.sum())) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rows = case["csr"].idx[pos.to(case["csr"].idx.device)].float()
    table = case["other"][0]
    return rows.numel(), probe_ms(lambda: dma.gather_rows(table, rows), 20)


def phase_atlas_kernel(device, side_a, side_p, reps=5):
    """K4 vs its plain version at the atlas shape, A and P samplers."""
    import torch
    from cogaps_tpu_torch.ops import atlas_cuda, sweep_cuda
    k, B, C = 50, 512, 1 << 19
    cases = [
        atlas_case("atlas A sampler (30000 rows, partner 50000, k=50)",
                   side_a, side_p.n_rows, k, B, C, 4000, 6, device),
        atlas_case("atlas P sampler (50000 rows, partner 30000, k=50)",
                   side_p, side_a.n_rows, k, B, C, 4000, 7, device),
    ]
    log(f"  K4 grid: {atlas_cuda.grid_blocks(device)} resident blocks of "
        f"1024 threads, work items of {atlas_cuda.CHUNK} nonzeros")
    results, failed, max_err = [], [], 0.0
    for case in cases:
        source = uniform_source(1, B, device, sweeps=256)
        key = sweep_cuda.PhiloxKey(key0=torch.tensor([13], device=device),
                                   key1=3)
        args = (case["atoms"], case["M"], case["csr"], case["other"], 1.0,
                case["budgets"], case["consts"], case["mass"])
        for what, rand in (("exact", source), ("fast", key)):
            out_k = atlas_cuda.run_updates_atlas_multi(*args, rand)
            out_p = atlas_cuda.run_updates_atlas_multi_plain(*args, rand)
            torch.cuda.synchronize()
            problems, err = compare_atlas(case, out_k, out_p, what)
            max_err = max(max_err, err)
            if problems:
                log(f"  MISMATCH ({what}): {problems}")
                if what == "exact":
                    locate_atlas_divergence(case, source)
                failed.append((case["name"], what))
        out_k = atlas_cuda.run_updates_atlas_multi(*args, key)
        atlas_cuda.reset_part_times(device)
        k_ms = time_calls(lambda: atlas_cuda.run_updates_atlas_multi(
            *args, key), reps)
        parts = atlas_cuda.part_times(device)
        p_ms = time_plain(lambda: atlas_cuda.run_updates_atlas_multi_plain(
            *args, key))
        csr, m = case["csr"], case["other"].shape[1]
        nnz_row = csr.idx.numel() / csr.n_rows
        bound, by = sweep_bound_ms(
            out_k[4].processed, out_k[0].n, 4 * 2 * k + 8 * nnz_row,
            300 + nnz_row * (2 * k + 16), fixed_bytes=4 * (m * k + k * k))
        n_sweeps = int(out_k[3][0])
        per_sweep = {part: parts[f"{part}_ns"] * 1e-6 / parts["sweeps"]
                     for part in ("a", "b", "c")}
        g_rows, g_ms = sweep_gather_ms(case, source(0, 0, 1))
        log(f"  {case['name']}: kernel {k_ms:.4f} ms/call ({n_sweeps} "
            f"sweeps, {k_ms / n_sweeps:.4f} ms a sweep; block 0 over "
            f"{parts['sweeps']} sweeps: (a)+(c) "
            f"{per_sweep['a'] + per_sweep['c']:.4f} ms = (a) "
            f"{per_sweep['a']:.4f} + (c) {per_sweep['c']:.4f}, (b) "
            f"{per_sweep['b']:.4f} ms a sweep), plain "
            f"{p_ms:.1f} ms/call, bound {bound:.6f} ms ({by}) (budget "
            f"{int(case['budgets'][0])}, {nnz_row:.1f} nonzeros per row); "
            f"F9 gather_rows of the {g_rows} partner rows of the first "
            f"exact-mode sweep: {g_ms:.4f} ms")
        results.append((case["name"], k_ms, p_ms, bound, by))
    if failed:
        raise AssertionError(f"K4 and its plain version disagree: {failed}")
    return results, max_err


# ----------------------------------------------------------------------
# phase 3: K3, the fused span
# ----------------------------------------------------------------------
def rebuild_flops(G, S, k):
    """float64 operations of csrc/span.cu's two table rebuilds of one
    chain: per data entry and sampler its residual (2k + 2), Y (2k) and Z
    (2 a pair c <= c'; SQ is Z's diagonal); per partner and sampler the
    pair products of partner values."""
    kp = k * (k + 1) // 2
    return 2 * G * S * (4 * k + 2 + 2 * kp) + (G + S) * kp


def rebuild_bound_ms(G, S, k, nch):
    """The bound of the rebuild-only entry point: D and invS2 read once
    (D_t and invS2_t are layouts of the same inputs), both factors read
    once, every table (Y, SQ, Z of each sampler) written once; the float64
    operations of rebuild_flops."""
    from cogaps_tpu_torch.probes import bound_ms
    n_bytes = 4 * nch * (2 * G * S + (G + S) * k + (G + S) * k * (2 + k))
    return bound_ms(n_bytes, nch * rebuild_flops(G, S, k))


def span_bound_ms(G, S, k, nch, n_it, before, after, sampling):
    """The bound of an n_it-iteration span from the run's own counts. Once
    a span: D and invS2 read, both factors read and written, the atom
    tables at the span's end read and written, and the running sums read
    and written while sampling. The sweeps' row traffic and operations as
    sweep_bound_ms counts them, and the rebuilds' float64 operations every
    iteration. The tables the kernel rebuilds and rereads in between are
    its scratch, neither input nor output of the span."""
    from cogaps_tpu_torch.probes import bound_ms
    n_bytes = 4 * nch * (2 * G * S + 2 * (G + S) * k)
    flops = n_it * nch * rebuild_flops(G, S, k)
    done = after[1].prop_counts - before[1].prop_counts
    for row, atoms in ((0, after[0].atoms_a), (1, after[0].atoms_p)):
        b, f = sweep_work(done[:, row], atoms.n, 4 * (5 * k + k * k),
                          300 + 2 * k)
        n_bytes, flops = n_bytes + b, flops + f
    if sampling:
        n_bytes += 2 * 4 * 2 * (G + S) * k * nch
    return bound_ms(n_bytes, flops)


def compare_span(what, out_k, out_p):
    """Decision-exact agreement of two spans' (state, stats); returns
    (problems, largest |difference| of mass, M and the running sums)."""
    (st_k, ss_k), (st_p, ss_p) = out_k, out_p
    problems = []
    for label, x, y in (
            ("elem_a", st_k.atoms_a.elem, st_p.atoms_a.elem),
            ("n_a", st_k.atoms_a.n, st_p.atoms_a.n),
            ("elem_p", st_k.atoms_p.elem, st_p.atoms_p.elem),
            ("n_p", st_k.atoms_p.n, st_p.atoms_p.n),
            ("done", ss_k.upd, ss_p.upd),
            ("sweeps", ss_k.sweep_counts, ss_p.sweep_counts),
            ("processed", ss_k.prop_counts, ss_p.prop_counts),
            ("accepted", ss_k.acc_counts, ss_p.acc_counts),
            ("n_stat", ss_k.n_stat, ss_p.n_stat)):
        if not np.array_equal(x.cpu().numpy(), y.cpu().numpy()):
            problems.append(label)
    errs = {}
    for label, x, y in (
            ("mass_a", st_k.atoms_a.mass, st_p.atoms_a.mass),
            ("mass_p", st_k.atoms_p.mass, st_p.atoms_p.mass),
            ("M_a", st_k.M_a, st_p.M_a), ("M_p", st_k.M_p, st_p.M_p),
            ("a_sum", ss_k.a_sum, ss_p.a_sum),
            ("a_sumsq", ss_k.a_sumsq, ss_p.a_sumsq),
            ("p_sum", ss_k.p_sum, ss_p.p_sum),
            ("p_sumsq", ss_k.p_sumsq, ss_p.p_sumsq)):
        x, y = x.double().cpu().numpy(), y.double().cpu().numpy()
        errs[label] = float(np.abs(x - y).max())
        if not np.all(np.abs(x - y) <= TOL_MASS_M + TOL_MASS_M * np.abs(y)):
            problems.append(label)
    log(f"  {what}: updates {ss_k.upd.tolist()}, sweeps "
        f"{ss_k.sweep_counts.tolist()}, atoms A {st_k.atoms_a.n.tolist()} P "
        f"{st_k.atoms_p.n.tolist()}; max|diff| "
        + ", ".join(f"{name} {e:.3g}" for name, e in errs.items()))
    return problems, max(errs.values())


def locate_span_divergence(eng, span_args, state, stats, rand):
    """Run kernel and plain version one iteration at a time from the
    plain version's state; print the first iteration that differs."""
    import torch
    from cogaps_tpu_torch.ops import span, span_cuda
    cfg, ca, cp, hist, phase, data, it0, n_it = span_args
    for it in range(it0, it0 + n_it):
        one = (cfg, ca, cp, hist, phase, data, it, 1, state, stats)
        out_k = span_cuda.run_span(*one, rand())
        out_p = span.run_span_plain(*one, rand())
        torch.cuda.synchronize()
        problems, _ = compare_span(f"iteration {it} alone", out_k, out_p)
        if problems:
            log(f"  first difference: iteration {it} of phase {phase}: "
                f"{problems}")
            return
        state, stats = out_p


def numpy_tables(D, inv, M_a, M_p):
    """Both samplers' tables in numpy float64, each rounded once to
    float32 (the fields of ops/span.SpanTables)."""
    def side(X, W, M, O):
        R = (X - M @ O.T) * W
        Z = W @ (O[:, :, None] * O[:, None, :]).reshape(len(O), -1)
        return (R @ O, W @ (O * O), Z.reshape(-1, O.shape[1]),
                O.max(axis=0) > 0)

    D, inv, M_a, M_p = (x.astype(np.float64) for x in (D, inv, M_a, M_p))
    out = side(D, inv, M_a, M_p) + side(D.T, inv.T, M_p, M_a)
    return [x if x.dtype == bool else x.astype(np.float32) for x in out]


def rebuild_library_ms(data, M_a, M_p, reps):
    """The library yardstick of the rebuild: float64 torch.bmm of its
    contractions, R.O and W.[O*O | O_c O_c'] of both samplers, on a
    residual R formed beforehand (the port never calls them)."""
    import torch
    k = M_a.shape[-1]
    iu = torch.triu_indices(k, k)
    ops = []
    for X, W, M, O in ((data.D, data.invS2, M_a, M_p),
                       (data.D_t, data.invS2_t, M_p, M_a)):
        X, W, M, O = (x.double() for x in (X, W, M, O))
        R = (X - M @ O.transpose(1, 2)) * W
        OO = torch.cat([O * O, O[:, :, iu[0]] * O[:, :, iu[1]]], dim=2)
        ops.append((R, O, W, OO))

    def library():
        for R, O, W, OO in ops:
            torch.bmm(R, O)
            torch.bmm(W, OO)

    return time_calls(library, reps)


def rebuild_check(name, Ds, k, seed, device, reps=20):
    """The span kernel's rebuild alone on len(Ds) chains with random
    factors, against numpy_tables chain by chain, bit for bit; returns
    {cl, ms (device), plain, library, bound, by}."""
    import torch
    from cogaps_tpu_torch.engine import _device_data
    from cogaps_tpu_torch.ops import span, span_cuda
    rng = np.random.default_rng(seed)
    nch = len(Ds)
    G, S = Ds[0].shape
    D = np.stack(Ds)
    inv = (1.0 / np.maximum(0.1 * D, 0.1) ** 2).astype(np.float32)
    M_a = rng.gamma(2.0, 1.0, (nch, G, k)).astype(np.float32)
    M_p = rng.gamma(2.0, 1.0, (nch, S, k)).astype(np.float32)
    one = np.ones(nch, np.float32)
    data = _device_data(D, inv, one, one, one, one, device)
    Ma_t = torch.as_tensor(M_a, device=device)
    Mp_t = torch.as_tensor(M_p, device=device)
    shape = span_cuda.launch_shape(1, device, nch, G, S, k,
                                   span_cuda.block_threads(1024, 1, k))
    got = [x.cpu().numpy() for x in span_cuda.rebuild_tables(data, Ma_t,
                                                             Mp_t)]
    unequal = {}
    for c in range(nch):
        want = numpy_tables(D[c], inv[c], M_a[c], M_p[c])
        for field, x, y in zip(span.SpanTables._fields, got, want):
            bad = x[c] != y
            if bad.any():
                rel = (np.abs(x[c].astype(np.float64) - y).max()
                       / max(np.abs(y).max(), 1e-30) if y.dtype != bool
                       else 1.0)
                unequal.setdefault(field, []).append(
                    (c, int(bad.sum()), float(rel)))
    ms = device_ms(lambda: span_cuda.rebuild_tables(data, Ma_t, Mp_t),
                   "rebuild_kernel", reps)
    plain = time_plain(lambda: span.rebuild_tables_plain(data, Ma_t, Mp_t))
    library = rebuild_library_ms(data, Ma_t, Mp_t, reps)
    bound, by = rebuild_bound_ms(G, S, k, nch)
    log(f"  rebuild alone, {name}: "
        + ("bit-equal to numpy float64 rounded once" if not unequal else
           f"UNEQUAL (chain, entries, max relative error) {unequal}")
        + f"; cluster of {shape.cl} CTAs a chain, plans A {tuple(shape.plan_a)}"
        f" P {tuple(shape.plan_p)}, {shape.smem} B shared memory; "
        f"{ms:.4f} ms on the device, plain {plain:.4f} ms, float64 bmm "
        f"{library:.4f} ms, bound {bound:.6f} ms ({by}), share "
        f"{bound / ms:.4f}")
    if unequal:
        raise AssertionError(f"span rebuild differs from numpy: {name}")
    return {"cl": shape.cl, "ms": ms, "plain": plain, "library": library,
            "bound": bound, "by": by}


def phase_span(device, report, reps=5, n_chains=16, seed=21):
    """K3 against its plain version on GIST (n_chains chains, as phase 5
    runs it; 5-iteration spans from a state after 50 per-call
    equilibration iterations), its rebuild alone against numpy, and its
    times, with the share of the kernel's iteration that is not the
    sweeps. Returns (row, max_err, extra) with row (name, kernel ms,
    plain ms, bound ms, bound_by) for the 5-iteration sampling span."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import throughput_engine
    from cogaps_tpu_torch.engine import (EQUILIBRATION, SAMPLING, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.io import parsers
    from cogaps_tpu_torch.ops import span, span_cuda
    D, _, _ = parsers.read_matrix(GIST_CSV)
    G, S = D.shape
    k = 7
    eng, _ = throughput_engine(D, cogaps_tpu_torch.CogapsParams(
        n_patterns=k, n_iterations=2000, seed=seed, output_frequency=0),
        n_chains, None, device)
    seeds = [seed + c for c in range(n_chains)]

    def rand():
        return PhiloxRandom(seeds, device)

    class NoSweeps(PhiloxRandom):
        """Budget normals of -1e30: every budget is 0, so a span runs its
        rebuilds, statistics and counters, and no sweep."""

        def budget_normals(self, phase, start, n):
            return torch.full((n_chains, n, 2), -1e30, device=device)

    state, stats = ChainEngine.run_phase(eng, eng.init_state(),
                                         eng.init_stats(), rand(),
                                         EQUILIBRATION, 0, 50)

    def args(phase, it0, n_it):
        return (eng.config, eng.consts_a, eng.consts_p, eng.hist, phase,
                eng.data, it0, n_it)

    failed, max_err, plain_ms = [], 0.0, {}
    for phase, it0 in ((EQUILIBRATION, 50), (SAMPLING, 0)):
        out_k = span_cuda.run_span(*args(phase, it0, 5), state, stats,
                                   rand())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = span.run_span_plain(*args(phase, it0, 5), state, stats,
                                    rand())
        torch.cuda.synchronize()
        plain_ms[phase] = (time.perf_counter() - t0) * 1e3
        problems, err = compare_span(
            f"GIST x{n_chains}, 5 iterations from {it0} of phase {phase}",
            out_k, out_p)
        max_err = max(max_err, err)
        if problems:
            log(f"  MISMATCH (phase {phase}): {problems}")
            locate_span_divergence(eng, args(phase, it0, 5), state, stats,
                                   rand)
            failed.append(phase)
        if phase == SAMPLING:
            bound, by = span_bound_ms(G, S, k, n_chains, 5, (state, stats),
                                      out_k, True)
    if failed:
        raise AssertionError(f"K3 and its plain version disagree: {failed}")
    warm = rand()  # the budget normals of 256 iterations, drawn once

    def run(phase, it0, n_it):
        return span_cuda.run_span(*args(phase, it0, n_it), state, stats,
                                  warm)

    span_ms = time_calls(lambda: run(SAMPLING, 0, 5), reps)
    chunk_ms = {phase: time_calls(lambda: run(phase, it0, span_cuda.CHUNK),
                                  reps)
                for phase, it0 in ((EQUILIBRATION, 50), (SAMPLING, 0))}
    kernel_ms = device_ms(lambda: run(SAMPLING, 0, span_cuda.CHUNK),
                          "span_kernel", reps)
    no_sweeps_ms = device_ms(lambda: span_cuda.run_span(
        *args(SAMPLING, 0, span_cuda.CHUNK), state, stats,
        NoSweeps(seeds, device)), "span_kernel", reps) / span_cuda.CHUNK
    tables_ms = device_ms(lambda: span_cuda.rebuild_tables(
        eng.data, state.M_a, state.M_p), "rebuild_kernel", reps)
    span_cl = span_cuda.launch_shape(
        0, device, n_chains, G, S, k, span_cuda.block_threads(
            eng.consts_a.batch, eng.consts_p.batch, k)).cl
    log(f"  K3 GIST x{n_chains}: {span_ms:.4f} ms per 5-iteration sampling "
        f"span ({span_ms / 5:.4f} ms per iteration), plain "
        f"{plain_ms[SAMPLING]:.1f} ms (equilibration {plain_ms[0]:.1f} ms),"
        f" bound {bound:.6f} ms ({by}); {span_cuda.CHUNK}-iteration chunk "
        f"{chunk_ms[EQUILIBRATION]:.4f} ms in equilibration from iteration "
        f"50 ({chunk_ms[EQUILIBRATION] / span_cuda.CHUNK:.4f} ms per "
        f"iteration), {chunk_ms[SAMPLING]:.4f} ms in sampling "
        f"({chunk_ms[SAMPLING] / span_cuda.CHUNK:.4f} ms per iteration); "
        f"on the device, span_kernel {kernel_ms / span_cuda.CHUNK:.4f} ms "
        f"per sampling iteration; without sweeps (all budgets 0: rebuilds, "
        f"statistics, counters) {no_sweeps_ms:.4f} ms, a share "
        f"{no_sweeps_ms * span_cuda.CHUNK / kernel_ms:.4f}; rebuild_kernel "
        f"alone on the same state {tables_ms:.4f} ms; span_kernel runs "
        f"clusters of {span_cl} CTAs a chain; ptxas (registers, bytes of "
        f"spill stores): span_kernel {ptxas_of(report, 'span_kernel')}, "
        f"rebuild_kernel {ptxas_of(report, 'rebuild_kernel')}")
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    rebuilds = {
        "probe": rebuild_check(
            "tools/probe_rebuild.py shape (384 x 9, k=7)",
            [np.random.default_rng(0).gamma(2.0, 2.0, (384, 9)).astype(
                np.float32)], 7, 1, device),
        "gist": rebuild_check("GIST (1363 x 9, k=7)", [D], 7, 2, device),
        "gist_x16": rebuild_check(f"GIST x{n_chains}", [D] * n_chains, 7, 3,
                                  device),
        "wide_x16": rebuild_check(
            f"20000 x 100, k=10, x{n_chains}",
            synthetic_dense(20000, 100, 10, n_chains, 45), 10, 4, device,
            reps=5),
    }
    return ((f"GIST x{n_chains}, 5 iterations", span_ms, plain_ms[SAMPLING],
             bound, by), max_err, {"rebuilds": rebuilds,
                                   "chunk_ms": chunk_ms,
                                   "kernel_ms_per_iter":
                                       kernel_ms / span_cuda.CHUNK,
                                   "no_sweeps_ms_per_iter": no_sweeps_ms,
                                   "rebuild_ms_per_iter": tables_ms})


# ----------------------------------------------------------------------
# phase 3: the per-call tables kernel
# ----------------------------------------------------------------------
TABLES_CASES = (  # (name, rows R, partners m, k, chains): both samplers
    ("GIST A x1", 1363, 9, 7, 1), ("GIST P x1", 9, 1363, 7, 1),
    ("GIST A x16", 1363, 9, 7, 16), ("GIST P x16", 9, 1363, 7, 16),
    ("5000x2000 A x4", 5000, 2000, 10, 4),
    ("5000x2000 P x4", 2000, 5000, 10, 4),
    ("20000x100 A x16", 20000, 100, 10, 16),
    ("20000x100 P x16", 100, 20000, 10, 16),
    ("20000x2000 block A", 2500, 2000, 10, 1),
    ("20000x2000 block P", 2000, 2500, 10, 1),
    ("phase 11 subsets A x4", 5005, 100, 10, 4),
    ("phase 11 subsets P x4", 100, 5005, 10, 4),
    ("modsim A", 25, 20, 3, 1), ("modsim P", 20, 25, 3, 1),
    # above k = 12: single-cell and genome-wide runs ask for more patterns
    # than GIST's 7
    ("5000x2000 A x4 k=20", 5000, 2000, 20, 4),
    ("5000x2000 P x4 k=20", 2000, 5000, 20, 4),
    ("20000x100 A x16 k=20", 20000, 100, 20, 16),
    ("20000x100 P x16 k=20", 100, 20000, 20, 16),
    ("5000x2000 A x4 k=50", 5000, 2000, 50, 4),
    ("5000x2000 P x4 k=50", 2000, 5000, 50, 4),
    ("GIST A x1 k=13", 1363, 9, 13, 1), ("GIST P x1 k=13", 9, 1363, 13, 1),
    # above k = 64: the column tiles on a ring of two stages; phase 4's
    # CoGAPS() at 100 x 100 k=90; Y's columns over two tiles at k=150
    ("5000x2000 A x4 k=80", 5000, 2000, 80, 4),
    ("5000x2000 P x4 k=80", 2000, 5000, 80, 4),
    ("5000x2000 A x4 k=100", 5000, 2000, 100, 4),
    ("5000x2000 P x4 k=100", 2000, 5000, 100, 4),
    ("100x100 A x1 k=90", 100, 100, 90, 1),
    ("100x100 P x1 k=90", 100, 100, 90, 1),
    ("300x400 A x1 k=150", 300, 400, 150, 1),
    # simt_tiles_kernel's ground (once quads_kernel's): bulk data of 40
    # samples, m < 64, above k = 12; and rows_kernel on the same data at
    # k=10, its yardstick
    ("20000x40 A x1 k=20", 20000, 40, 20, 1),
    ("20000x40 A x1 k=39", 20000, 40, 39, 1),
    ("20000x40 A x1 k=10", 20000, 40, 10, 1))
TABLES_HEADLINE = "5000x2000 A x4"


def tables_inputs(R, m, k, nch, seed, device):
    """One sampler's float32 inputs for nch chains, made on the card: D
    with a fifth zeros, invS2 = 1 / max(0.1 D, 0.1)^2, M with 30% zeros,
    the partner factor with an empty last column."""
    import torch
    g = torch.Generator(device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    D = 20.0 * u(nch, R, m) ** 2
    D = torch.where(u(nch, R, m) < 0.2, torch.zeros_like(D), D)
    inv = 1.0 / torch.clamp(0.1 * D, min=0.1) ** 2
    M = torch.where(u(nch, R, k) < 0.3, torch.zeros(()), 2.0 * u(nch, R, k))
    O = 2.0 * u(nch, m, k)
    O[:, :, -1] = 0.0
    return D, inv, M, O


def tables_errors(got, exact, terms):
    """The largest |table - exact| over each entry's summed |terms| (Y, SQ
    and Z together), and whether every entry is within 1e-5 of them."""
    worst, ok = 0.0, True
    for x, e, t in zip(got, exact, terms):
        d = (x.double() - e.double()).abs()
        ok = ok and bool((d <= 1e-5 * t).all())
        pos = t > 0
        if pos.any():
            worst = max(worst, float((d[pos] / t[pos]).max()))
    return worst, ok


def tables_terms(D, inv, M, O):
    """Each entry's sum of |terms| in float64: Y's of (|D| + |M| |O|^T)
    invS2 |O| (Y cancels), SQ's and Z's of invS2 |O_c O_c'|."""
    D, inv, M, O = (x.double().abs() for x in (D, inv, M, O))
    k = O.shape[-1]
    Y = ((D + M @ O.transpose(-1, -2)) * inv) @ O
    OO = (O.unsqueeze(-1) * O.unsqueeze(-2)).flatten(-2)
    Z = (inv @ OO).reshape(inv.shape[:-2] + (inv.shape[-2] * k, k))
    return Y, inv @ (O * O), Z


def phase_tables(device, report, card, reps=20):
    """The per-call tables kernel at TABLES_CASES against the float64
    tables rounded once and its plain cuBLAS version; per case the
    kernel's ms by events around back-to-back calls (the host's pace
    where it is slower) and its device ms, the stream's ms a call with
    the host held out of the way (stream_ms: torch.profiler's events
    of this kernel were found short of its launches, reading under the
    bound), with the host's ms to enqueue a call; the same two of the
    plain tables; the bound, the plan. Returns (rows {name: (shape, ms,
    plain_ms, bound, by, device_ms, plain_device_ms)}, the largest
    |kernel - plain| entry)."""
    import torch
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    from cogaps_tpu_torch.probes import H100_TF32_OPS_PER_S, bound_ms
    n_sm = cuda_build.sm_count(device.index or 0)
    rows, max_err, bad = {}, 0.0, []
    for i, (name, R, m, k, nch) in enumerate(TABLES_CASES):
        args = tables_inputs(R, m, k, nch, 100 + i, device)
        before = tables_cuda.dense_tables.launches
        cache, phase = dense.tables(*args)
        launched = tables_cuda.dense_tables.launches - before
        pc, pp = dense.tables_plain(*args)
        ec, ep = dense.exact_tables(*args)
        terms = tables_terms(*args)
        err_k, ok = tables_errors((cache.Y, phase.SQ, phase.Z),
                                  (ec.Y, ep.SQ, ep.Z), terms)
        err_p, _ = tables_errors((pc.Y, pp.SQ, pp.Z), (ec.Y, ep.SQ, ep.Z),
                                 terms)
        diff = max(float((a - b).abs().max()) for a, b in (
            (cache.Y, pc.Y), (phase.SQ, pp.SQ), (phase.Z, pp.Z)))
        max_err = max(max_err, diff)
        ok = (ok and err_k <= 2 * err_p and launched == 1
              and torch.equal(phase.col_nz, ep.col_nz))
        plan = tables_cuda.tables_plan(R, m, k, n_sm)
        beside = ""
        if plan.form == "simt":  # quads_kernel on the same inputs
            quads = tables_cuda.cuda_core_plan(R, m, k, n_sm)
            got = tables_cuda.dense_tables(*args, plan=quads)
            same = all(torch.equal(x, y) for x, y in zip(
                got, (cache.Y, phase.SQ, phase.Z, phase.col_nz)))
            q_dev, _ = stream_ms(
                lambda: tables_cuda.dense_tables(*args, plan=quads))
            ok = ok and same
            beside = (f"; quads_kernel<{quads.PQ}> forced: device "
                      f"{q_dev:.4f} ms, bits equal {same}")
            del got
        del pc, pp, ec, ep, terms, cache, phase
        ms = time_calls(lambda: dense.tables(*args), reps)
        dev, host = stream_ms(lambda: dense.tables(*args))
        plain_ms = time_calls(lambda: dense.tables_plain(*args), reps)
        plain_dev, _ = stream_ms(lambda: dense.tables_plain(*args))
        bound, by = bound_ms(*tables_cuda.tables_counts(R, m, k, nch))
        tc, tc_by = bound_ms(*tables_cuda.tables_tc_counts(R, m, k, nch),
                             ops_per_s=H100_TF32_OPS_PER_S)
        regs, spill = ptxas_of(report, tables_symbol(plan))
        rows[name] = (f"{nch} x ({R},{m}) k={k}", ms, plain_ms, bound, by,
                      dev, plain_dev, tc, tc_by)
        log(f"  tables {name} ({nch} x {R}x{m}, k={k}): kernel {ms:.4f} ms "
            f"(device {dev:.4f}, the host's {host:.4f}), plain cuBLAS "
            f"tables {plain_ms:.4f} ms (device {plain_dev:.4f}), float32 "
            f"bound {bound:.4f} ms ({by}), bound/device {bound / dev:.3f}, "
            f"tensor-core bound {tc:.4f} ms ({tc_by}), bound/device "
            f"{tc / dev:.3f}; worst |error|/terms against "
            f"the float64 tables {err_k:.3g} (cuBLAS {err_p:.3g}), "
            f"max|kernel - cuBLAS| {diff:.3g}; {launched} launch a call; "
            f"plan {tables_form(plan)}"
            f" RT={plan.RT} S={plan.S} CH={plan.CH} L={plan.L}, "
            f"{plan.blocks} blocks a chain, {plan.smem} B shared, ptxas "
            f"{regs} registers, {spill} bytes of spill stores{beside}"
            + ("" if ok else "  MISMATCH"))
        if not ok:
            bad.append(name)
        del args
    for a, p in (("5000x2000 A x4", "5000x2000 P x4"),
                 ("20000x100 A x16", "20000x100 P x16")):
        log(f"  an iteration's tables at {a[:-5]}, both samplers: kernel "
            f"device {rows[a][5] + rows[p][5]:.4f} ms, cuBLAS tables device"
            f" {rows[a][6] + rows[p][6]:.4f} ms; card: {card}")
    regs = {f"{kind}_kernel<{q}>": ptxas_of(report, f"{kind}_kernelILi{q}E")
            for kind in ("mma", "rows")
            for q in range(1, tables_cuda.ROWS_MAX_K + 1)}
    regs.update({f"quads_kernel<{q}>": ptxas_of(report, f"quads_kernelILi{q}E")
                 for q in tables_cuda.QUADS})
    regs["simt_tiles_kernel"] = ptxas_of(report, "simt_tiles_kernel")
    regs.update({f"mma_tiles_kernel<{q}, {ns}>": ptxas_of(
        report, f"mma_tiles_kernelILi{q}ELi{ns}E")
        for q, ns in ((tables_cuda.TILE_NT, tables_cuda.STAGES),
                      (2 * tables_cuda.TILE_NT, tables_cuda.STAGES),
                      (2 * tables_cuda.TILE_NT, 2))})
    log(f"  tables kernels' ptxas (registers, bytes of spill stores): "
        f"{regs}")
    if bad:
        raise AssertionError(f"the tables kernel disagrees with the float64"
                             f" tables or launched otherwise than once: "
                             f"{bad}")
    return rows, max_err


def tables_form(plan):
    """The tables kernel a plan runs, as phase 3 prints it."""
    if plan.form in ("mma", "short") and plan.NCT:
        return (f"{plan.form}: mma_tiles_kernel<{plan.NCT}, {plan.stages}> "
                f"RW={plan.RW} KW={plan.KW}, {plan.acc_tiles} column tiles "
                f"of {plan.NC}")
    if plan.form in ("mma", "short"):
        return (f"{plan.form}: mma_kernel<{plan.k}> RW={plan.RW} "
                f"KW={plan.KW}")
    if plan.form == "rows":
        return f"rows: rows_kernel<{plan.k}>"
    if plan.form == "simt":
        return (f"simt: simt_tiles_kernel RT={plan.RT} G={plan.G}, "
                f"{plan.acc_tiles} band(s) of at most {plan.smq} of Z's rows")
    return f"quads: quads_kernel<{plan.PQ}> G={plan.G}"


def tables_symbol(plan):
    """The part of the mangled name of the tables kernel a plan runs that
    ptxas_of looks for."""
    if plan.form in ("mma", "short") and plan.NCT:
        return f"mma_tiles_kernelILi{plan.NCT}ELi{plan.stages}E"
    if plan.form in ("mma", "short"):
        return f"mma_kernelILi{plan.k}E"
    if plan.form == "rows":
        return f"rows_kernelILi{plan.k}E"
    if plan.form == "simt":
        return "simt_tiles_kernel"
    return f"quads_kernelILi{plan.PQ}E"


def ptxas_of(report, kernel):
    """(registers, bytes of spill stores) that ptxas reported for the
    entry function whose name holds `kernel`."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            after = "\n".join(lines[i + 1:i + 3])
            spill = re.search(r"(\d+) bytes spill stores", after)
            regs = re.search(r"Used (\d+) registers", after)
            return (int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else None)
    return None, None


def realistic_run(Ds, k, device, n_it=50, seed=7):
    """Phase 6 at k patterns: the chains of Ds (4 x 5000 x 2000) in a
    MultichainEngine, n_it + n_it iterations, a chi^2 every 10, on the
    per-call route; it fails unless chi^2 is finite and falling, the
    tables launch twice an iteration and both samplers' plans are
    column tiles. Returns the tables launches."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    G, S = Ds[0].shape
    n_sm = cuda_build.sm_count(device.index or 0)
    plans = [tables_cuda.tables_plan(R, m, k, n_sm)
             for R, m in ((G, S), (S, G))]
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=k, n_iterations=n_it, seed=seed, output_frequency=10)
    cfg = params.engine_config(G, S)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = MultichainEngine(stack_device_data(Ds, None, cfg, device), cfg,
                           device)
    rand = PhiloxRandom([seed + c for c in range(len(Ds))], device)
    state, stats = eng.init_state(), eng.init_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables_cuda.dense_tables.launches = 0
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = eng.run_phase(state, stats, rand, ph)
    hist = stats.chisq_hist.cpu().numpy()  # waits for the device
    t2 = time.perf_counter()
    launches = tables_cuda.dense_tables.launches
    ups = int(stats.upd.sum()) / (t2 - t1)
    log(f"  {len(Ds)} chains x {G}x{S}, k={k}, {n_it}+{n_it} iterations: "
        f"{ups:.1f} updates/s, {t2 - t1:.2f} s (+{t1 - t0:.2f} s set-up), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
        f" atoms A {state.atoms_a.n.tolist()} P {state.atoms_p.n.tolist()};"
        f" tables launches {launches}, A and P "
        + " and ".join(tables_form(p) for p in plans))
    for c in range(len(Ds)):
        log(f"  chain {c} chi^2 history {np.round(hist[c], 1).tolist()}")
    if not np.isfinite(hist).all() or not (hist[:, -1] < hist[:, 0]).all():
        raise AssertionError(f"k={k} chi^2 history is not finite and "
                             f"falling")
    if launches != 2 * 2 * n_it:
        raise AssertionError(f"{launches} tables launches at k={k}, not two"
                             f" an iteration")
    if not all(p.NCT and p.form == "mma" for p in plans):
        raise AssertionError(f"k={k} tables not in column tiles: {plans}")
    return launches


def bulk_few_samples_run(device, card, genes=20000, samples=40, k=20,
                         n_it=100, seed=23):
    """Phase 6 on bulk data of few samples: CoGAPS() on a synthetic genes
    x samples matrix (bench_harness.synthetic_dense, from seed) at k
    patterns, n_it + n_it iterations, one chain on the per-call route,
    through the public entry point: A's tables (samples < MMA_MIN_M
    partners) in simt_tiles_kernel, one launch an iteration, P's in
    mma_tiles_kernel. It fails unless the chi^2 history is finite and
    falling and the forms launched so. Returns the tables launches."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    [D] = synthetic_dense(genes, samples, k, 1, seed)
    n_sm = cuda_build.sm_count(device.index or 0)
    plans = [tables_cuda.tables_plan(R, m, k, n_sm)
             for R, m in ((genes, samples), (samples, genes))]
    torch.cuda.reset_peak_memory_stats()
    tables_cuda.dense_tables.launches = 0
    tables_cuda.dense_tables.by_form = {}
    t0 = time.perf_counter()
    res = cogaps_tpu_torch.CoGAPS(D, n_patterns=k, n_iterations=n_it,
                                  seed=seed, messages=False,
                                  output_frequency=n_it // 4, device="cuda")
    elapsed = time.perf_counter() - t0
    launches = tables_cuda.dense_tables.launches
    by_form = dict(tables_cuda.dense_tables.by_form)
    h = np.asarray(res.diagnostics["chisqHistory"], dtype=np.float64)
    ups = (res.diagnostics["totalUpdates"]
           / res.diagnostics["totalRunningTime"])
    log(f"  CoGAPS() {genes}x{samples} k={k} (synthetic, seed {seed}), "
        f"{n_it}+{n_it} iterations: meanChiSq {res.mean_chi_sq:.1f}, "
        f"{elapsed:.2f} s in all, {ups:.1f} updates/s over its "
        f"{res.diagnostics['totalRunningTime']:.2f} s of iterations "
        f"({res.diagnostics['totalUpdates']} updates), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; tables "
        f"launches {launches} by form {by_form}, A "
        + " and P ".join(tables_form(p) for p in plans)
        + f"; chi^2 history {np.round(h, 1).tolist()}; card: {card}")
    if not (len(h) > 1 and np.isfinite(h).all() and h[-1] < h[0]
            and np.isfinite(res.mean_chi_sq)):
        raise AssertionError(f"{genes}x{samples} k={k}: chi^2 history is "
                             f"not finite and falling")
    if (plans[0].form != "simt" or by_form.get("simt") != 2 * n_it
            or launches != 4 * n_it):
        raise AssertionError(f"{genes}x{samples} k={k}: tables launches "
                             f"{by_form}, not A's in simt_tiles_kernel once"
                             f" an iteration: {plans[0]}")
    return launches


def phase_many_patterns(device, card, n=100, k=90, n_it=100, seed=17):
    """Phase 4 above k = 88: CoGAPS() on an n x n matrix at k patterns,
    n_it + n_it iterations, through the public entry point (one chain,
    the per-call route: both samplers' tables in column tiles), then one
    chain of the same data in a MultichainEngine with no history, whose
    gate sends it to the per-call route too (K3 cannot launch past k =
    88: span_cuda.span_fits). Each ends with a finite meanChiSq, two
    tables launches an iteration and no K3 launch. Returns the tables
    launches."""
    import cogaps_tpu_torch
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops import cuda_build, span_cuda, tables_cuda
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    from cogaps_tpu_torch.result import finalize_statistics, mean_chi_sq
    D = np.random.default_rng(seed).gamma(2.0, 2.0, (n, n)).astype(
        np.float32)
    plan = tables_cuda.tables_plan(n, n, k, cuda_build.sm_count(
        device.index or 0))
    t0 = time.perf_counter()
    tables_cuda.dense_tables.launches = 0
    span_cuda.run_span.launches = 0
    res = cogaps_tpu_torch.CoGAPS(D, n_patterns=k, n_iterations=n_it,
                                  seed=seed, messages=False, device="cuda")
    t1 = time.perf_counter()
    launches = tables_cuda.dense_tables.launches
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=k, n_iterations=n_it, seed=seed, output_frequency=0)
    cfg = params.engine_config(n, n)
    eng = MultichainEngine(stack_device_data([D], None, cfg, device), cfg,
                           device)
    fused = eng._fused_ok()
    state, stats = eng.init_state(), eng.init_stats()
    rand = PhiloxRandom([seed], device)
    tables_cuda.dense_tables.launches = 0
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = eng.run_phase(state, stats, rand, ph)
    amean, _, pmean, _ = finalize_statistics(*(
        x[0].cpu().numpy() for x in (stats.a_sum, stats.a_sumsq,
                                     stats.p_sum, stats.p_sumsq,
                                     stats.n_stat)))
    t2 = time.perf_counter()
    multi = tables_cuda.dense_tables.launches
    mcs_multi = mean_chi_sq(amean, pmean, D, dense.default_uncertainty(D))
    spans = span_cuda.run_span.launches
    log(f"  CoGAPS() {n}x{n} k={k}, {n_it}+{n_it} iterations: meanChiSq "
        f"{res.mean_chi_sq:.1f}, {t1 - t0:.2f} s, tables launches "
        f"{launches} ({tables_form(plan)}, {plan.smem} B shared); one "
        f"chain of a MultichainEngine, gate fused {fused}: meanChiSq "
        f"{mcs_multi:.1f}, {t2 - t1:.2f} s, tables launches {multi}; K3 "
        f"launches {spans}; card: {card}")
    if not (np.isfinite(res.mean_chi_sq) and np.isfinite(mcs_multi)):
        raise AssertionError(f"k={k}: meanChiSq not finite")
    if fused or spans or launches != 4 * n_it or multi != 4 * n_it:
        raise AssertionError(f"k={k} did not take the per-call route: gate "
                             f"{fused}, {spans} K3 launches, tables "
                             f"launches {launches} and {multi}")
    if not (plan.form == "mma" and plan.NCT):
        raise AssertionError(f"k={k} tables not in column tiles: {plan}")
    return launches + multi


def build_all():
    """nvcc for every source at once; returns {name: (seconds, report)}."""
    from concurrent.futures import ThreadPoolExecutor
    from cogaps_tpu_torch.ops import (atlas_cuda, span_cuda, sweep_cuda,
                                      tables_cuda)
    from cogaps_tpu_torch.probes import dma, mosaic

    def timed(fn):
        t0 = time.perf_counter()
        _, report = fn()
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(7) as pool:
        futs = {"sweep": pool.submit(timed, sweep_cuda.build),
                "atlas": pool.submit(timed, atlas_cuda.build),
                "span": pool.submit(timed, span_cuda.build),
                "tables": pool.submit(timed, tables_cuda.build),
                "probe_mosaic": pool.submit(timed, mosaic.build),
                "probe_dma": pool.submit(timed, dma.build),
                "fastparse": pool.submit(timed, build_native)}
        return {name: f.result() for name, f in futs.items()}


def build_native():
    """The native parser (io/native.py: native/fastparse.cpp by the host's
    C++ compiler into cogaps_tpu_torch/_build/); fails if it cannot be
    built."""
    from cogaps_tpu_torch.io import native
    if not native.available():
        raise AssertionError(f"the native parser did not build: "
                             f"{native.failure()}")
    return None, ""


def time_modes(D, device, n_warm=150, n_timed=20):
    """Iteration time of each sparse mode from one state: n_warm
    equilibration iterations in "dense" mode, then n_timed iterations of
    each mode from a copy of that state (the rule's measurement)."""
    import copy
    import dataclasses
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.engine import EQUILIBRATION, PhiloxRandom
    from cogaps_tpu_torch.sparse_engine import SparseGapsEngine
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=10, n_iterations=500, seed=3, output_frequency=0)
    base = params.engine_config(*D.shape)
    engines = {m: SparseGapsEngine(D, dataclasses.replace(
        base, sparse_table_mode=m), device) for m in ("dense", "ell", "xla")}
    warm = engines["dense"]
    st, ss = warm.run_phase(warm.init_state(), warm.init_stats(),
                            PhiloxRandom([3], device), EQUILIBRATION, 0,
                            n_warm)
    times = {}
    for mode, eng in engines.items():
        rand = PhiloxRandom([3], device)
        st_m, ss_m = copy.deepcopy(st), copy.deepcopy(ss)
        eng.run_phase(st_m, ss_m, rand, EQUILIBRATION, n_warm, n_warm + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_m, ss_m = eng.run_phase(st_m, ss_m, rand, EQUILIBRATION, n_warm,
                                   n_warm + n_timed)
        torch.cuda.synchronize()
        times[mode] = (time.perf_counter() - t0) * 1e3 / n_timed
    return times, int(st.atoms_a.n[0]), int(st.atoms_p.n[0])


def falling(hist):
    return bool(np.isfinite(hist).all() and hist[-1] < hist[0])


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# phase 11: distributed runs (GWCoGAPS, scCoGAPS)
# ----------------------------------------------------------------------
def launch_counters():
    """The wrappers whose launch counts phases 11-15 read: the kernels a
    distributed stage records (parallel/distributed.KERNELS) and the
    per-call tables kernel."""
    from cogaps_tpu_torch.ops import tables_cuda
    from cogaps_tpu_torch.parallel.distributed import KERNELS
    return {**KERNELS, "dense_tables": tables_cuda.dense_tables}


def chisq_fit(D, A, P, S, device):
    """(chi^2 of D against A P^T under S, chi^2 of the zero model), in
    float64 on the card."""
    import torch

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).double()

    Dt, St = t(D), t(S)
    fit = float((((Dt - t(A) @ t(P).T) / St) ** 2).sum())
    return fit, float(((Dt / St) ** 2).sum())


def span_padded_check(D, device, n_warm=20, n_it=3, seed=5):
    """K3 against its plain version on unequal, padded gene subsets of D
    (4990, 5000, 5005 and 5005 of its 20000 rows, padded to 5005 with
    invS2 = 0), n_it equilibration iterations from a state after n_warm
    per-call ones: the padded rows must not change a decision."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.engine import (EQUILIBRATION, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.ops import span, span_cuda
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    cuts = np.cumsum([0, 4990, 5000, 5005, 5005])
    Ds = [D[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    cfg = cogaps_tpu_torch.CogapsParams(
        n_patterns=10, n_iterations=500, seed=seed,
        output_frequency=0).engine_config(5005, D.shape[1])
    eng = MultichainEngine(stack_device_data(Ds, None, cfg, device), cfg,
                           device)
    if not eng._fused_ok():
        raise AssertionError("padded subsets left the fused route")

    def rand():
        return PhiloxRandom([seed] * 4, device)

    state, stats = ChainEngine.run_phase(eng, eng.init_state(),
                                         eng.init_stats(), rand(),
                                         EQUILIBRATION, 0, n_warm)
    args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, EQUILIBRATION,
            eng.data, n_warm, n_it, state, stats)
    out_k = span_cuda.run_span(*args, rand())
    out_p = span.run_span_plain(*args, rand())
    torch.cuda.synchronize()
    problems, err = compare_span(
        f"K3 on padded subsets (4990/5000/5005/5005 x 100, k=10), {n_it} "
        f"iterations from {n_warm}", out_k, out_p)
    if problems:
        raise AssertionError(f"K3 and its plain version disagree on padded "
                             f"subsets: {problems}")
    # one launch of a stage's chunk at the subset shape, against its bound
    state, stats = out_p
    n_chunk = span_cuda.CHUNK
    args = args[:6] + (n_warm + n_it, n_chunk, state, stats)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = span_cuda.run_span(*args, rand())
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    bound, by = span_bound_ms(5005, D.shape[1], 10, 4, n_chunk,
                              (state, stats), out, False)
    log(f"  K3 at the subset shape (4 x 5005x100, k=10), one {n_chunk}-"
        f"iteration launch from iteration {n_warm + n_it}: {ms:.3f} ms, "
        f"bound {bound:.4f} ms ({by}), bound/kernel {bound / ms:.5f}")
    return err, bound, by


def gw_arrays(res) -> dict:
    """What phase 11 holds bit-equal across rank counts: the factors,
    meanChiSq and the consensus of a GWCoGAPS result."""
    return {"Amean": res.Amean, "Asd": res.Asd, "Pmean": res.Pmean,
            "Psd": res.Psd, "meanChiSq": np.float64(res.mean_chi_sq),
            "consensus": res.diagnostics["consensusPatterns"]}


def rank_gw(rank, n, D, params, out):
    """One of n ranks sharing the card over gloo, making phase 11's
    GWCoGAPS call (params: CogapsParams fields); writes its arrays and its
    stages' launches (summed over the ranks) to <out>.rank<rank>.npz."""
    import torch
    import cogaps_tpu_torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cogaps_tpu_torch.GWCoGAPS(D, cogaps_tpu_torch.CogapsParams(
        **params), messages=False, device="cuda")
    secs = time.perf_counter() - t0
    stages = res.diagnostics["stages"]
    np.savez(f"{out}.rank{rank}.npz", **gw_arrays(res),
             span=[st["launches"]["span"] for st in stages],
             sweep=[st["launches"]["sweep"] for st in stages])
    log(f"  rank {rank} of {n} (gloo, the card shared): GWCoGAPS "
        f"{secs:.3f} s, stages "
        + ", ".join(f"{st['seconds']:.3f} s" for st in stages))


def gw_across_ranks(D, card, n_it=200, seed=13):
    """GWCoGAPS of D (four 5000-gene subsets, k=10, n_it + n_it a stage) on
    2 and then on 4 ranks that share the card (parallel/launch.py, gloo:
    the subset chains on the JAX rule's mesh, a rank a chain at 4), and in
    this process at mesh=None: every rank's factors, meanChiSq and
    consensus bit-equal to the one-process run's, and each stage's
    launches of K3 and K1, summed over the ranks, n times the one-process
    run's (each rank runs every iteration of its chains). Returns the
    one-process run's launches by kernel."""
    import tempfile
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.parallel import launch
    params = dict(n_patterns=10, n_iterations=n_it, seed=seed, n_sets=4,
                  output_frequency=0)
    with tempfile.TemporaryDirectory() as tmp:
        for n in (2, 4):
            t0 = time.perf_counter()
            launch.join(launch.start(rank_gw, n, D, params,
                                     os.path.join(tmp, f"gw{n}")),
                        timeout=600)
            log(f"  GWCoGAPS 20000x100 k=10, {n_it}+{n_it} a stage, on {n} "
                f"ranks sharing the card: {time.perf_counter() - t0:.1f} s "
                f"from spawn to join; card: {card}")
        counters = launch_counters()
        for w in counters.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cogaps_tpu_torch.GWCoGAPS(D, cogaps_tpu_torch.CogapsParams(
            **params), messages=False, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counters.items()}
        one = gw_arrays(res)
        stages = res.diagnostics["stages"]
        log(f"  the same call in this process (mesh=None): {secs:.3f} s, "
            f"stages " + ", ".join(f"{st['seconds']:.3f} s" for st in stages)
            + f", launches {launches}")
        for n in (2, 4):
            for rank in range(n):
                with np.load(os.path.join(tmp, f"gw{n}.rank{rank}.npz")) as z:
                    for k, v in one.items():
                        if not np.array_equal(z[k], v):
                            raise AssertionError(
                                f"GWCoGAPS on {n} ranks, rank {rank}: {k} "
                                f"differs from one process")
                    for kernel in ("span", "sweep"):
                        want = [n * st["launches"][kernel] for st in stages]
                        if z[kernel].tolist() != want:
                            raise AssertionError(
                                f"{n} ranks launched {kernel} "
                                f"{z[kernel].tolist()} times, not {want}")
        log("  every rank of 2 and of 4 bit-equal to one process in Amean, "
            "Asd, Pmean, Psd, meanChiSq and the consensus")
    return launches


def phase_distributed(device, card, seed=13):
    """GWCoGAPS on bulk data and scCoGAPS on single-cell data, each
    through its entry point on the card, four subsets each; each run
    driven with the launch counts set to 0 just before it and read just
    after, and every stage (one multichain program,
    parallel/distributed.py) read from the result's diagnostics["stages"]:
    its seconds, updates and launches. Returns (launches by kernel summed
    over both runs, launches by run and stage, K3's max |difference| on
    padded subsets)."""
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import (synthetic_dense,
                                                synthetic_sparse)
    from cogaps_tpu_torch.models import dense
    from cogaps_tpu_torch.ops import span_cuda
    from cogaps_tpu_torch.parallel.distributed import KERNELS
    from cogaps_tpu_torch.sparse_engine import resolve_sparse_mode
    counters = launch_counters()

    def drive(entry, D, params, **kw):
        """(result, seconds, stages) of one run; the stages' launches
        must sum to the run's."""
        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = entry(D, params, messages=False, device="cuda", **kw)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = {n: w.launches for n, w in counters.items()}
        stages = res.diagnostics["stages"]
        if len(stages) != 2 or any(
                sum(st["launches"][n] for st in stages) != launches[n]
                for n in KERNELS):
            raise AssertionError(f"stage launches {stages} do not add up "
                                 f"to the run's {launches}")
        return res, t_run, stages, launches["dense_tables"]

    def report(what, res, t_run, n_it, modes, base):
        stages = res.diagnostics["stages"]
        for i, st in enumerate(stages):
            log(f"  {what} stage {i + 1} ({'free' if i == 0 else 'fixed'}"
                f"): {st['seconds']:.3f} s, {st['updates'] / st['seconds']:.1f}"
                f" updates/s ({st['updates']} updates, {n_it}+{n_it} "
                f"iterations, 4 chains), launches {st['launches']}")
        peak = torch.cuda.max_memory_allocated()
        log(f"  {what}: {t_run:.3f} s in all, k_out {res.Amean.shape[1]}, "
            f"{modes}, peak device memory of the run "
            f"{(peak - base) / 2**30:.3f} GiB (above the "
            f"{base / 2**30:.3f} GiB held before it), meanChiSq "
            f"{res.mean_chi_sq:.1f}; card: {card}")

    by_run = {}
    # genome-wide bulk RNA-seq: 20000 genes in four 5000-gene subsets
    n_it = 500
    [D] = synthetic_dense(20000, 100, 10, 1, seed)
    err, k3_bound, k3_by = span_padded_check(D, device)
    genes = [f"g{i}" for i in range(D.shape[0])]
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=10, n_iterations=n_it, seed=seed, n_sets=4,
        output_frequency=0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, t_run, stages, gw_tables = drive(cogaps_tpu_torch.GWCoGAPS, D,
                                          params, gene_names=genes)
    report("[11 distributed] GWCoGAPS 20000x100 k=10", res, t_run, n_it,
           "dense model (stage 1 fused span K3, stage 2 per-call K1)",
           base)
    by_run["GWCoGAPS"] = [st["launches"] for st in stages]
    free = stages[0]
    k3_ms = free["seconds"] * 1e3 / free["launches"]["span"]
    log(f"  GWCoGAPS stage 1: {k3_ms:.3f} ms a K3 launch "
        f"({free['launches']['span']} launches in {free['seconds']:.3f} s), "
        f"bound {k3_bound:.4f} ms ({k3_by}) a launch at the subset shape; "
        f"tables kernel launches {gw_tables} (stage 2, A only)")
    if gw_tables != 2 * n_it:
        raise AssertionError(f"GWCoGAPS launched the tables kernel "
                             f"{gw_tables} times, not once an iteration of "
                             f"its fixed stage")
    consensus = res.diagnostics["consensusPatterns"]
    fit, zero = chisq_fit(D, res.Amean, consensus,
                          dense.default_uncertainty(D), device)
    log(f"  GWCoGAPS chi^2 of D against Amean consensus^T {fit:.1f}, "
        f"zero model {zero:.1f} (ratio {fit / zero:.6f}, gate <= 0.2)")
    k_out = consensus.shape[1]
    if (res.Amean.shape != (20000, k_out)
            or not np.isfinite(res.Amean).all()
            or not np.abs(res.Amean).sum() > 0):
        raise AssertionError("GWCoGAPS: Amean not finite and nonzero")
    if np.abs(res.Pmean).sum() != 0 or res.gene_names != genes:
        raise AssertionError("GWCoGAPS: Pmean not zero or genes reordered")
    if not fit <= 0.2 * zero:
        raise AssertionError(f"GWCoGAPS does not fit: {fit} vs {zero}")
    if (stages[0]["launches"]["span"] < 2 * n_it // span_cuda.CHUNK
            or stages[1]["launches"]["sweep"] < 2 * n_it):
        raise AssertionError(f"GWCoGAPS launches {by_run['GWCoGAPS']}")
    del res
    beside = gw_across_ranks(D, card)
    by_run["GWCoGAPS on one process, beside the ranks"] = [beside]
    del D

    # single-cell: 40000 cells in four 10000-cell subsets, sparse model
    n_it = 300
    [D] = synthetic_sparse(2000, 40000, 10, 1, seed)
    cells = [f"c{j}" for j in range(D.shape[1])]
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=10, n_iterations=n_it, seed=seed, n_sets=4,
        output_frequency=0)
    mode = resolve_sparse_mode(4, 2000, 10000, 10, device)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, t_run, stages, sc_tables = drive(cogaps_tpu_torch.scCoGAPS, D,
                                          params, sample_names=cells)
    report(f"scCoGAPS 2000x40000 k=10 ({(D == 0).mean():.4f} zeros)",
           res, t_run, n_it, f"sparse model, mode {mode}", base)
    by_run["scCoGAPS"] = [st["launches"] for st in stages]
    consensus = res.diagnostics["consensusPatterns"]
    fit, zero = chisq_fit(D, consensus, res.Pmean,
                          np.maximum(0.1 * D, 0.1), device)
    log(f"  scCoGAPS chi^2 of D against consensus Pmean^T {fit:.1f}, "
        f"zero model {zero:.1f} (ratio {fit / zero:.6f}, gate <= 0.2)")
    k_out = consensus.shape[1]
    if (res.Pmean.shape != (40000, k_out)
            or not np.isfinite(res.Pmean).all()
            or not np.abs(res.Pmean).sum() > 0):
        raise AssertionError("scCoGAPS: Pmean not finite and nonzero")
    if np.abs(res.Amean).sum() != 0 or res.sample_names != cells:
        raise AssertionError("scCoGAPS: Amean not zero or cells reordered")
    if not fit <= 0.2 * zero:
        raise AssertionError(f"scCoGAPS does not fit: {fit} vs {zero}")
    calls = (2 * 2 * n_it, 2 * n_it)  # sampler calls: both, then P only
    for st, n in zip(stages, calls):
        if st["launches"]["sweep"] + st["launches"]["atlas"] < n:
            raise AssertionError(f"scCoGAPS launches {by_run['scCoGAPS']}")
    if sc_tables:
        raise AssertionError(f"scCoGAPS launched the dense tables kernel "
                             f"{sc_tables} times")
    total = {n: sum(st[n] for runs in by_run.values() for st in runs)
             for n in KERNELS}
    return total, by_run, err, gw_tables + beside["dense_tables"]


# ----------------------------------------------------------------------
# phase 12: checkpoints
# ----------------------------------------------------------------------
def phase_checkpoint(device, n_it=1000, every=250):
    """CoGAPS on GIST with a checkpoint every `every` iterations, a
    resume from the file that run leaves (with another seed argument),
    and the same run without checkpoints: all three bit-equal. Returns
    the sweep kernel's launches in the three runs."""
    import shutil
    import tempfile
    import cogaps_tpu_torch
    counters = launch_counters()
    for w in counters.values():
        w.launches = 0
    kw = dict(n_patterns=7, n_iterations=n_it, messages=False,
              device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gist_checkpoint.npz")
        t0 = time.perf_counter()
        r_ck = cogaps_tpu_torch.CoGAPS(GIST_CSV, seed=42,
                                       checkpoint_interval=every,
                                       checkpoint_out_file=out, **kw)
        t1 = time.perf_counter()
        left = os.path.join(tmp, "left.npz")
        shutil.copy(out, left)
        z = np.load(left)
        at = (int(z["phase"]), int(z["iteration"]))
        t2 = time.perf_counter()
        r_res = cogaps_tpu_torch.CoGAPS(GIST_CSV, seed=99,
                                        checkpoint_in_file=left, **kw)
        t3 = time.perf_counter()
        r_plain = cogaps_tpu_torch.CoGAPS(GIST_CSV, seed=42, **kw)
        t4 = time.perf_counter()
    launches = {n: w.launches for n, w in counters.items()}
    log(f"[12 checkpoints] CoGAPS GIST k=7 {n_it}+{n_it} iterations: "
        f"checkpointed every {every} {t1 - t0:.3f} s, resumed from the "
        f"file it left (phase {at[0]}, iteration {at[1]}) with seed=99 "
        f"{t3 - t2:.3f} s, without checkpoints {t4 - t3:.3f} s; launches "
        f"{launches}; meanChiSq {r_ck.mean_chi_sq!r}, {r_res.mean_chi_sq!r},"
        f" {r_plain.mean_chi_sq!r}")
    if at != (1, n_it - every) or r_res.diagnostics["seed"] != 42:
        raise AssertionError(f"checkpoint left at {at}")
    for other, what in ((r_res, "resumed"), (r_plain, "uninterrupted")):
        for name in ("Amean", "Pmean", "Asd"):
            if not np.array_equal(getattr(r_ck, name), getattr(other, name)):
                raise AssertionError(f"{what} run: {name} differs")
        if other.mean_chi_sq != r_ck.mean_chi_sq:
            raise AssertionError(f"{what} run: meanChiSq differs")
    if launches["sweep"] < 2 * 2 * n_it * 2 + 2 * every:
        raise AssertionError(f"only {launches} launches")
    if launches["dense_tables"] != launches["sweep"]:
        raise AssertionError(f"launches {launches}: not one tables launch "
                             f"a sampler call")
    return launches


# ----------------------------------------------------------------------
# phase 13: the command line, the parsers and the analysis toolkit
# ----------------------------------------------------------------------
def write_mtx(path, D):
    """D as a MatrixMarket coordinate file; %.9g holds a float32 exactly."""
    r, c = np.nonzero(D)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n"
                f"{D.shape[0]} {D.shape[1]} {len(r)}\n")
        np.savetxt(f, np.column_stack([r + 1, c + 1, D[r, c]]),
                   fmt=("%d", "%d", "%.9g"))


def phase_cli(D, card, n_it=500, seed=13):
    """``python -m cogaps_tpu_torch <D>.mtx --sparse`` on the card, as a
    subprocess with no --device and again in this process under the
    launch counters; the two parsers on the file it reads; the analysis
    toolkit on the result it wrote. Returns the kernels' launches in the
    in-process run."""
    import contextlib
    import io
    import tempfile
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch import __main__ as cli
    from cogaps_tpu_torch import analysis, sparse_engine
    from cogaps_tpu_torch.io import native, parsers
    from cogaps_tpu_torch.result import CogapsResult
    counters = launch_counters()
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "sc.mtx"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        write_mtx(path, D)
        t_write = time.perf_counter() - t0
        # 2. the native and the Python parser on the file
        if not native.available():
            raise AssertionError(f"no native parser: {native.failure()}")
        t0 = time.perf_counter()
        nat = parsers.read_matrix(path)
        t1 = time.perf_counter()
        py = parsers.read_matrix(path, use_native=False)
        t2 = time.perf_counter()
        if not (np.array_equal(nat[0], py[0]) and nat[1:] == py[1:]
                and np.array_equal(nat[0], D)):
            raise AssertionError("the native and Python parsers disagree")
        log(f"[13 cli] {D.shape[0]}x{D.shape[1]} mtx of {int((D != 0).sum())}"
            f" nonzeros ({os.path.getsize(path) / 2**20:.1f} MiB, written in "
            f"{t_write:.3f} s): read_matrix chose the native parser "
            f"({native.library_path().name}) {t1 - t0:.3f} s, the Python "
            f"parser {t2 - t1:.3f} s, equal matrices and names; card: {card}")
        del nat, py
        # 3. the command line as a user runs it: the card by default
        argv = [path, "--sparse", "--n-patterns", "10", "--n-iterations",
                str(n_it), "--output-frequency", "50", "-o", out, "--csv",
                "--seed", str(seed)]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "cogaps_tpu_torch",
                               *argv], cwd=HERE, capture_output=True,
                              text=True, timeout=600)
        t_sub = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        res = CogapsResult.load(out + ".npz")
        back = CogapsResult.from_csv(out)
        h = np.asarray(res.diagnostics["chisqHistory"])
        csv_err = max(float(np.abs(getattr(back, n) - getattr(res, n)).max())
                      for n in ("Amean", "Pmean", "Asd", "Psd"))
        log(f"  python -m cogaps_tpu_torch sc.mtx {' '.join(argv[1:])}: "
            f"{t_sub:.3f} s in all (process start-up included), summary "
            f"{json.dumps(summary)}; device {res.diagnostics['device']}; "
            f"from_csv - load max|diff| {csv_err!r}; chi^2 history "
            f"{np.round(h, 1).tolist()}")
        if not (np.isfinite(summary["meanChiSq"])
                and summary["totalUpdates"] > 0):
            raise AssertionError(f"CLI summary {summary}")
        if not res.diagnostics["device"].startswith("cuda"):
            raise AssertionError("the CLI did not run on the card")
        if not (np.isfinite(h).all() and h[-1] < 0.2 * h[0]):
            raise AssertionError("the CLI's chi^2 history did not fall 5x")
        for n in ("Amean", "Pmean", "Asd", "Psd"):
            a, b = getattr(back, n), getattr(res, n)
            if a.shape != b.shape or not np.allclose(a, b, rtol=5e-10,
                                                     atol=0.0):
                raise AssertionError(f"from_csv and load disagree on {n}")
        # 4. the same argv in this process, under the launch counters and
        # counting the sparse model's update calls by mode
        table_calls = collections.Counter()
        table_call = sparse_engine._table_call

        def counted(mode, *args, **kwargs):
            table_calls[mode] += 1
            return table_call(mode, *args, **kwargs)

        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        sparse_engine._table_call = counted
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                cli.main(argv)
            torch.cuda.synchronize()
            t_in = time.perf_counter() - t0
        finally:
            sparse_engine._table_call = table_call
        launches = {n: w.launches for n, w in counters.items()}
        again = CogapsResult.load(out + ".npz")
        same = all(np.array_equal(getattr(again, n), getattr(res, n))
                   for n in ("Amean", "Pmean", "Asd", "Psd"))
        log(f"  in-process main(): {t_in:.3f} s, launches {launches}, "
            f"the sparse model's update calls by mode {dict(table_calls)}, "
            f"result bit-equal to the subprocess's: {same}; summary "
            f"{said.getvalue().strip().splitlines()[-1]}")
        # two K2 launches an iteration, each one of the sparse model's
        # "dense"-mode update calls, and no other kernel
        want = 2 * 2 * n_it
        if (launches != {"sweep": want, "span": 0, "atlas": 0,
                         "dense_tables": 0}
                or dict(table_calls) != {"dense": want}):
            raise AssertionError(f"launches {launches} and sparse update "
                                 f"calls {dict(table_calls)} for {n_it} + "
                                 f"{n_it} iterations")
        if not same:
            raise AssertionError("the same argv and seed gave another result")
    # 5. the analysis toolkit on the result the CLI wrote
    rs = np.random.default_rng(seed)
    genes, n_cells = res.gene_names, res.Pmean.shape[0]
    sets = {f"set{i}": [genes[j] for j in rs.choice(len(genes), 50,
                                                    replace=False)]
            for i in range(5)}
    labels = rs.integers(0, 3, n_cells)
    groups = np.stack([labels == 1, labels == 2], axis=1).astype(np.float64)
    k = res.Amean.shape[1]
    checks = {
        "pattern_markers": (lambda: analysis.pattern_markers(res), lambda o: (
            o["PatternRanks"].shape == (len(genes), k)
            and sorted(g for v in o["PatternMarkers"].values() for g in v)
            == sorted(genes))),
        "calc_z": (lambda: analysis.calc_z(res), lambda o: (
            o.shape == (len(genes), k) and np.isfinite(o).all())),
        "calc_cogaps_stat": (lambda: analysis.calc_cogaps_stat(res, sets),
                             lambda o: o["GSUpreg"].shape == (5, k) and all(
                                 np.isfinite(o[x]).all() for x in (
                                     "twoSidedPValue", "GSUpreg",
                                     "GSDownreg", "GSActEst"))),
        "get_pattern_gene_set": (
            lambda: analysis.get_pattern_gene_set(res, sets),
            lambda o: len(o) == k and all(
                len(p["results"]) == 5 and all(
                    0.0 <= r["padj"] <= 1.0 and np.isfinite(r["ES"])
                    for r in p["results"]) for p in o)),
        "manova": (lambda: analysis.manova(groups, res), lambda o: (
            len(o) == k and all(np.isfinite([f["pillai"], f["approx_f"],
                                             f["p_value"]]).all()
                                for f in o.values()))),
    }
    seconds = {}
    for name, (run, ok) in checks.items():
        t0 = time.perf_counter()
        o = run()
        seconds[name] = time.perf_counter() - t0
        if not ok(o):
            raise AssertionError(f"{name} gave a result of the wrong shape "
                                 f"or not finite")
    log(f"  analysis on the loaded result ({len(genes)} genes x {n_cells} "
        f"cells, k={k}), seconds: " + ", ".join(
            f"{n} {t:.3f}" for n, t in seconds.items())
        + f" (5 gene sets of 50; enrichment with 100 permutations; MANOVA of"
        f" 3 seeded groups); card: {card}")
    log("  build_report():\n    " + cogaps_tpu_torch.build_report().replace(
        "\n", "\n    "))
    return launches


# ----------------------------------------------------------------------
# phase 14: the sequential oracle
# ----------------------------------------------------------------------
def make_modsim(n_genes=25, n_samples=20, k=3, noise=0.1, seed=0):
    """The modsim toy of tests/conftest.py::make_modsim (the reference's
    modsimdata, R/data.R:12), copied: (D, A, P)."""
    rng = np.random.default_rng(seed)
    A = rng.gamma(2.0, 1.0, (n_genes, k)).astype(np.float32)
    P = rng.gamma(2.0, 1.0, (n_samples, k)).astype(np.float32)
    D = (A @ P.T + rng.normal(0, noise, (n_genes, n_samples)))
    return D.clip(0).astype(np.float32), A, P


def oracle_equilibrium(seed, n_it):
    """(chi^2, atoms A, atoms P) of the SequentialOracle on modsim after
    n_it + n_it iterations: a worker of phase 14's process pool."""
    from cogaps_tpu_torch.oracle import SequentialOracle
    orc = SequentialOracle(make_modsim()[0], k=3, seed=seed).run(n_it)
    return orc.chisq(), orc.dom_a.size(), orc.dom_p.size()


def phase_oracle(device, card, n_it=600, seeds=(0, 1, 2, 3)):
    """The oracle on the host (one process a seed), then, once it has
    ended, the port on the card with the same seeds and iterations: the
    per-call route (a one-chain GapsEngine a seed, K1) and the fused
    route (a 4-chain MultichainEngine with output_frequency 0, K3). Each
    route's mean chi^2 within 25% of the oracle's, its mean atom counts
    within 30% (tests/test_oracle.py:68-75). Then each kernel against
    its plain version at the routes' shapes, from their final states:
    K1's A and P calls of one more iteration of the last seed, K3 over a
    5-iteration span of the 4 chains. Returns (each route's launches by
    kernel, the largest |difference| of K1, of K3)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.engine import (EQUILIBRATION, SAMPLING, GapsEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.ops import span, span_cuda
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    D = make_modsim()[0]
    cfg = cogaps_tpu_torch.CogapsParams(
        n_patterns=3, n_iterations=n_it,
        output_frequency=0).engine_config(*D.shape)
    counters = launch_counters()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(seeds), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        futs = [pool.submit(oracle_equilibrium, s, n_it) for s in seeds]
        runs = {"oracle": [f.result(timeout=600) for f in futs]}
    secs = {"oracle": time.perf_counter() - t0}
    launches, ends = {}, {}
    for route in ("per-call", "fused"):
        for w in counters.values():
            w.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if route == "per-call":
            out = []
            for s in seeds:
                eng = GapsEngine(D, None, cfg, device)
                rand = PhiloxRandom([s], device)
                st, ss = eng.init_state(), eng.init_stats()
                for ph in (EQUILIBRATION, SAMPLING):
                    st, ss = eng.run_phase(st, ss, rand, ph)
                out.append((float(eng.chisq(st)[0]), int(st.atoms_a.n[0]),
                            int(st.atoms_p.n[0])))
        else:
            eng = MultichainEngine(stack_device_data(
                [D] * len(seeds), None, cfg, device), cfg, device)
            rand = PhiloxRandom(list(seeds), device)
            st, ss = eng.init_state(), eng.init_stats()
            for ph in (EQUILIBRATION, SAMPLING):
                st, ss = eng.run_phase(st, ss, rand, ph)
            out = list(zip(eng.chisq(st).tolist(), st.atoms_a.n.tolist(),
                           st.atoms_p.n.tolist()))
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t1
        runs[route] = out
        launches[route] = {n: w.launches for n, w in counters.items()}
        ends[route] = (eng, st, ss, rand)
    ref = np.mean(runs["oracle"], axis=0)
    log(f"[14 oracle] modsim 25x20 k=3, seeds {list(seeds)}, {n_it}+{n_it} "
        f"iterations (the oracle on the host, {len(seeds)} processes; the "
        f"card's routes after it); card: {card}")
    log("  run | mean chi^2 | mean atoms A | mean atoms P | per seed "
        "(chi^2, A, P) | launches | seconds")
    for route in ("oracle", "per-call", "fused"):
        m = np.mean(runs[route], axis=0)
        log(f"  {route} | {m[0]:.2f} | {m[1]:.2f} | {m[2]:.2f} | "
            f"{[(round(c, 2), a, p) for c, a, p in runs[route]]} | "
            f"{launches.get(route, '-')} | {secs[route]:.2f}")
    for route in ("per-call", "fused"):
        m = np.mean(runs[route], axis=0)
        for i, (what, band) in enumerate((("chi^2", 0.25), ("atoms A", 0.3),
                                          ("atoms P", 0.3))):
            if not abs(m[i] - ref[i]) < band * ref[i]:
                raise AssertionError(
                    f"{route} route: mean {what} {m[i]:.2f} outside "
                    f"{band:.0%} of the oracle's {ref[i]:.2f}")
    k1, k3 = launches["per-call"], launches["fused"]
    if not (k1["sweep"] > 0 and k1["span"] == 0 and k3["span"] > 0
            and k3["sweep"] == 0 and k1["dense_tables"] == k1["sweep"]
            and k3["dense_tables"] == 0):
        raise AssertionError(f"routes launched {launches}")

    eng, st, _, rand = ends["per-call"]
    err_k1 = max(check_call(f"14 per-call {side} sampler (modsim, k=3, "
                            f"seed {seeds[-1]}, iteration {n_it})", args)
                 for side, args in zip("AP", chain_calls(
                     eng, st, rand, SAMPLING, n_it)))
    eng, st, ss, rand = ends["fused"]
    span_args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, SAMPLING,
                 eng.data, 0, 5, st, ss)
    out_k = span_cuda.run_span(*span_args, rand)
    out_p = span.run_span_plain(*span_args, rand)
    torch.cuda.synchronize()
    problems, err_k3 = compare_span(
        f"14 fused, K3 vs plain: modsim x{len(seeds)}, 5 sampling "
        f"iterations from the final state", out_k, out_p)
    if problems:
        raise AssertionError(f"K3 and its plain version disagree at "
                             f"modsim: {problems}")
    return launches, err_k1, err_k3


# ----------------------------------------------------------------------
# phase 15: gene-sharded chains and chain-sharded runs
# ----------------------------------------------------------------------
def sharded_specs():
    from cogaps_tpu_torch.parallel.multichain import CHAIN_SPEC
    from cogaps_tpu_torch.parallel.sharded import STATE_SPEC, STATS_SPEC
    return {"dense": (STATE_SPEC, STATS_SPEC),
            "sparse": (STATE_SPEC, STATS_SPEC), "chains": CHAIN_SPEC,
            "percall": CHAIN_SPEC}


def job_engine(kind, n_it, mesh, device):
    """(engine, random source, checkpoint seed) of phase 15's runs:
    "dense", ShardedGapsEngine on synthetic_dense(20000, 2000, 10) with
    n_blocks = 8; "sparse", SparseShardedEngine on synthetic_sparse(2000,
    10000, 10) with n_shards = 4; "chains", MultichainEngine of 16 GIST
    chains (k=7, output_frequency 0: the fused span), chain c seeded
    17 + c; "percall", MultichainEngine of 8 chains of
    synthetic_dense(2000, 200, 10) (200 samples and a chi^2 history every
    5: the per-call route), chain c seeded 18 + c."""
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import (synthetic_dense,
                                                synthetic_sparse)
    from cogaps_tpu_torch.engine import PhiloxRandom
    from cogaps_tpu_torch.io.coo import CooMatrix
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    from cogaps_tpu_torch.parallel.sharded import (ShardedGapsEngine,
                                                   ShardedRandom)
    from cogaps_tpu_torch.parallel.sparse_sharded import SparseShardedEngine
    P = cogaps_tpu_torch.CogapsParams
    if kind == "dense":
        [D] = synthetic_dense(20000, 2000, 10, 1, 15)
        cfg = P(n_patterns=10, n_iterations=n_it, seed=15,
                output_frequency=max(n_it // 10, 1)).engine_config(*D.shape)
        return (ShardedGapsEngine(D, None, cfg, mesh=mesh, n_blocks=8,
                                  device=device),
                ShardedRandom(15, device), 15)
    if kind == "sparse":
        [D] = synthetic_sparse(2000, 10000, 10, 1, 16)
        r, c = np.nonzero(D)
        coo = CooMatrix(r.astype(np.int32), c.astype(np.int32), D[r, c],
                        D.shape)
        cfg = P(n_patterns=10, n_iterations=n_it, seed=16,
                output_frequency=1).engine_config(*D.shape)
        return (SparseShardedEngine(coo, cfg, mesh=mesh, n_shards=4,
                                    device=device),
                ShardedRandom(16, device), 16)
    if kind == "percall":
        [D] = synthetic_dense(2000, 200, 10, 1, 18)
        cfg = P(n_patterns=10, n_iterations=n_it, seed=18,
                output_frequency=5).engine_config(*D.shape)
        eng = MultichainEngine(stack_device_data([D] * 8, None, cfg, "cpu"),
                               cfg, device, mesh=mesh)
        seeds = [18 + c for c in range(8)]
        return (eng, PhiloxRandom([seeds[c] for c in eng.chains], device),
                np.asarray(seeds))
    D = np.load(GIST_NPZ)["D"].astype(np.float32)
    cfg = P(n_patterns=7, n_iterations=n_it, seed=17,
            output_frequency=0).engine_config(*D.shape)
    eng = MultichainEngine(stack_device_data([D] * 16, None, cfg, "cpu"),
                           cfg, device, mesh=mesh)
    seeds = [17 + c for c in range(16)]
    return (eng, PhiloxRandom([seeds[c] for c in eng.chains], device),
            np.asarray(seeds))


def run_job(kind, n_it, out, mesh=None, device="cuda", resume=None,
            save=None):
    """A whole run of one kind (from the checkpoint `resume`, if given;
    writing one at save = (prefix, phase, iteration) on the way), its end
    written as a per-rank checkpoint to `out`. Returns (engine, state,
    stats, seconds of the iterations)."""
    import torch
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING
    eng, rand, seed = job_engine(kind, n_it, mesh, device)
    start = (EQUILIBRATION, 0)
    if resume is None:
        state, stats = eng.init_state(), eng.init_stats()
    else:
        state, stats, phase, it, _ = eng.load_checkpoint(resume)
        start = (phase, it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for phase in (EQUILIBRATION, SAMPLING):
        if phase < start[0]:
            continue
        it = start[1] if phase == start[0] else 0
        if save is not None and save[1] == phase:
            state, stats = eng.run_phase(state, stats, rand, phase, it,
                                         save[2])
            eng.save_checkpoint(save[0], state, stats, phase, save[2], seed)
            it = save[2]
        state, stats = eng.run_phase(state, stats, rand, phase, it, n_it)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eng.save_checkpoint(out, state, stats, SAMPLING, n_it, seed)
    return eng, state, stats, secs


def rank_card(rank, n, jobs):
    """One of n ranks sharing the card over gloo: each job (kind,
    iterations, out, save) on the group's mesh."""
    from cogaps_tpu_torch.parallel import multihost
    for kind, n_it, out, save in jobs:
        mesh = multihost.global_mesh("chains" if kind in ("chains",
                                                          "percall")
                                     else "genes")
        secs = run_job(kind, n_it, out, mesh, save=save)[3]
        log(f"  rank {rank} of {n} ({mesh.backend}, the card shared): "
            f"{kind} {n_it}+{n_it} iterations {secs:.2f} s")


def job_leaves(kind, out):
    """(name, array) of every leaf of a run's final checkpoint, whole."""
    import dataclasses
    from cogaps_tpu_torch.parallel import multihost
    spec = sharded_specs()[kind]
    full = multihost.load_sharded_checkpoint(out, spec)
    names = []
    for part, tree in zip(("state", "stats"), spec):
        for f in dataclasses.fields(tree):
            sub = getattr(tree, f.name)
            if dataclasses.is_dataclass(sub):
                names += [f"{part}.{f.name}.{g.name}"
                          for g in dataclasses.fields(sub)]
            else:
                names.append(f"{part}.{f.name}")
    return list(zip(names, multihost.flatten(full)))


def same_bits(kind, a, b, what):
    """Fail unless two runs' final checkpoints are bit-equal, leaf by
    leaf."""
    la, lb = job_leaves(kind, a), job_leaves(kind, b)
    for (name, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                x, y):
            diff = (np.abs(x.astype(np.float64) - y.astype(np.float64)).max()
                    if x.shape == y.shape else "shape")
            raise AssertionError(f"{what}: {name} differs ({diff})")
    return len(la)


def run_report(what, stats, secs, launches, n_it, held):
    """Phase 15's line for one run: seconds, seconds an iteration,
    updates/s, the run's peak device memory above the `held` bytes
    allocated before it, and launches by kernel."""
    import torch
    upd = int(stats.upd.sum())
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  {what}: {secs:.3f} s, {secs / (2 * n_it):.5f} s an iteration, "
        f"{upd / secs:.1f} updates/s ({upd} updates), peak device memory "
        f"of the run {peak:.2f} GiB (above the {held / 2**30:.2f} GiB held "
        f"before it), launches {launches}")


def p_drift(state, n_samples, k):
    """max |M_p - the P atoms' mass per element| and its limit, 0.01 x
    max(1, max M_p) (tests/test_parallel.py:78-92 at this scale)."""
    from cogaps_tpu_torch.ops.atoms import total_mass_per_element
    mp = total_mass_per_element(state.atoms_p.chain(0),
                                n_samples * k).reshape(n_samples, k)
    drift = float((mp - state.M_p[0]).abs().max())
    return drift, 0.01 * max(1.0, float(state.M_p.max()))


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def unit_checks(what, eng, st, units, seed, it):
    """Phase 15's update calls of one more sampling iteration of a
    gene-sharded engine (its own a_call and p_call, the run's streams),
    each kernel against its plain version. Returns the largest
    |difference| of the A call and of the P call."""
    from cogaps_tpu_torch.engine import SAMPLER_A, SAMPLER_P, SAMPLING
    from cogaps_tpu_torch.parallel.sharded import ShardedRandom
    rand = ShardedRandom(seed, eng.device)
    n_a, n_p = rand.budgets(SAMPLING, it, st.atoms_a.n, st.atoms_p.n, units)
    err_a = check_call(f"{what} A sampler ({len(units)} units)", eng.a_call(
        st, n_a, 1.0, rand.sweeps(SAMPLING, it, SAMPLER_A, units)),
        atlas=getattr(eng, "mode", None) == "xla")
    return err_a, check_call(f"{what} P sampler", eng.p_call(
        st.atoms_p, st.M_p, st.M_a, 1.0, n_p,
        rand.sweeps(SAMPLING, it, SAMPLER_P)))


def sparse_split(eng, state, it):
    """One more sampling iteration of the sparse sharded engine, timed in
    its parts (ms) through the engine's own steps: the A sampler's
    arguments (a_call: its tables, a shard at a time, unless the mode is
    "xla") and its launch, the P sampler's per-shard table build
    (p_parts), their ordered sum (sum_p_parts) and its K2 launch."""
    from cogaps_tpu_torch.engine import SAMPLER_A, SAMPLER_P, SAMPLING
    from cogaps_tpu_torch.ops.atlas_cuda import run_updates_atlas_multi
    from cogaps_tpu_torch.ops.sweep_cuda import run_updates_multi
    from cogaps_tpu_torch.parallel.sharded import ShardedRandom
    rand = ShardedRandom(19, eng.device)
    n_a, n_p = rand.budgets(SAMPLING, it, state.atoms_a.n, state.atoms_p.n,
                            eng.shards)
    xla = eng.mode == "xla"
    ms = {}
    args, ms["A tables"] = timed(lambda: eng.a_call(
        state, n_a, 1.0, rand.sweeps(SAMPLING, it, SAMPLER_A, eng.shards)))
    out_a, ms["A launch (K4)" if xla else "A launch (K2)"] = timed(
        lambda: (run_updates_atlas_multi if xla else run_updates_multi)(
            *args))
    del args
    parts, ms["P table build"] = timed(lambda: eng.p_parts(out_a[1],
                                                           state.M_p))
    (Y0, phase), ms["P table sum"] = timed(lambda: eng.sum_p_parts(
        parts, out_a[1]))
    del parts
    _, ms["P launch (K2)"] = timed(lambda: run_updates_multi(
        state.atoms_p, state.M_p, Y0, phase, 1.0, n_p, eng.consts_p,
        eng.mass_p, rand.sweeps(SAMPLING, it, SAMPLER_P)))
    return {k: round(v, 3) for k, v in ms.items()}


def phase_sharded(device, card, n_full=200, n_atlas=40):
    """Bitwise checks across rank counts with ranks that share the card
    over gloo, run first, while this process waits: (b) the dense
    engine, 20 + 20 iterations, on 2 and 4 ranks, and a checkpoint
    written by 2 ranks at sampling iteration 10; (d) the sparse engine
    at 2000 x 10000, k=10, n_shards=4, 5 + 5, on 2 ranks; (e) 16 GIST
    chains (the fused span), 100 + 100, on 2 ranks, and their checkpoint
    after equilibration. Then, with the card and the host to this
    process alone: (a) ShardedGapsEngine at 20000 x 2000, k=10,
    n_blocks=8, mesh=None, n_full + n_full iterations; (c)
    SparseShardedEngine at 30000 x 50000 (2% nonzeros), k=50,
    n_shards=4, mesh=None, n_atlas + n_atlas; each with its update calls
    of one more iteration held against their plain versions; (b), (d)
    and (e) on mesh=None and the two resumes on 1 rank, bit-equal to the
    ranks' runs. Returns (the launches by kernel of this process's runs,
    the largest |difference| by kernel of those checks)."""
    import tempfile
    import torch
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import synthetic_coo
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING
    from cogaps_tpu_torch.parallel import launch
    from cogaps_tpu_torch.parallel.sharded import ShardedRandom
    from cogaps_tpu_torch.parallel.sparse_sharded import SparseShardedEngine
    counters = launch_counters()
    total = collections.Counter()

    def counted(kind, fn):
        """fn() with the launch counts set to 0 just before and read just
        after; returns (its result, the launches, the device bytes
        allocated before it)."""
        for w in counters.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = fn()
        got = {n: w.launches for n, w in counters.items()}
        if kind == "sparse":  # the sweep kernel on sparse tables is K2
            got["tables"] = got.pop("sweep")
        total.update(got)
        return out, {n: c for n, c in got.items() if c}, held

    with tempfile.TemporaryDirectory() as tmp:
        def p(name):
            return os.path.join(tmp, name)

        t0 = time.perf_counter()
        groups = [launch.start(rank_card, 2, [
            ("dense", 20, p("d2"), (p("dmid"), SAMPLING, 10)),
            ("sparse", 5, p("s2"), None),
            ("chains", 100, p("c2"), (p("cmid"), EQUILIBRATION, 100)),
            ("percall", 30, p("q2"), None)]),
            launch.start(rank_card, 4, [("dense", 20, p("d4"), None),
                                        ("percall", 30, p("q4"), None)])]
        try:
            for g in groups:
                launch.join(g, timeout=600)
        except BaseException:
            for g in groups:
                launch.kill(g)
            raise
        log(f"[15 sharded] the groups of 2 and 4 ranks, run together, "
            f"ended after {time.perf_counter() - t0:.1f} s (start-up "
            f"included); card: {card}")

        # (a) dense, full width
        (eng, st, ss, secs), got, held = counted(
            "dense", lambda: run_job("dense", n_full, p("d_full")))
        log(f"  (a) ShardedGapsEngine, synthetic_dense(20000, 2000, 10), "
            f"n_blocks=8, mesh=None, {n_full}+{n_full} iterations, alone "
            f"on the card")
        run_report("dense full width", ss, secs, got, n_full, held)
        hist = ss.chisq_hist[0].cpu().numpy()
        drift, limit = p_drift(st, eng.n_samples, 10)
        log(f"  chi^2 history {np.round(hist, 1).tolist()}; atoms A "
            f"{int(st.atoms_a.n.sum())} ({st.atoms_a.n.tolist()}), P "
            f"{int(st.atoms_p.n[0])}; P mass drift {drift:.3g} (limit "
            f"{limit:.3g})")
        if not falling(hist) or drift > limit:
            raise AssertionError("dense sharded run: chi^2 not falling "
                                 "or P drifted")
        if eng.trim(st.M_a.cpu().numpy()).shape != (20000, 10):
            raise AssertionError("trimmed A has the wrong shape")
        if got != {"sweep": 2 * 2 * n_full, "dense_tables": 2 * 2 * n_full}:
            raise AssertionError(f"launches {got}, expected K1 and the "
                                 f"tables kernel twice an iteration")
        errs = {"sweep": max(unit_checks("15 (a)", eng, st, eng.blocks, 15,
                                         n_full))}
        del eng, st, ss

        # (c) sparse, full width
        t0 = time.perf_counter()
        coo = synthetic_coo(30000, 50000, 0.02, 19)
        t1 = time.perf_counter()
        cfg = cogaps_tpu_torch.CogapsParams(
            n_patterns=50, n_iterations=n_atlas, seed=19,
            output_frequency=max(n_atlas // 2, 1)).engine_config(*coo.shape)
        eng = SparseShardedEngine(coo, cfg, n_shards=4, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nnz = len(coo.vals)
        del coo

        def sparse_run():
            rand = ShardedRandom(19, device)
            st, ss = eng.init_state(), eng.init_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for ph in (EQUILIBRATION, SAMPLING):
                st, ss = eng.run_phase(st, ss, rand, ph)
            torch.cuda.synchronize()
            return st, ss, time.perf_counter() - t

        (st, ss, secs), got, held = counted("sparse", sparse_run)
        log(f"  (c) SparseShardedEngine, synthetic_coo(30000, 50000, "
            f"0.02): {nnz} nonzeros, k=50, n_shards=4, mesh=None, A-side "
            f"mode {eng.mode!r} (sparse_engine.resolve_sparse_mode at one "
            f"shard of {eng.g_local} genes), {n_atlas}+{n_atlas} "
            f"iterations, alone on the card; set-up {t1 - t0:.1f} s COO "
            f"generation + {t2 - t1:.1f} s shards")
        run_report("sparse full width", ss, secs, got, n_atlas, held)
        hist = ss.chisq_hist[0].cpu().numpy()
        drift, limit = p_drift(st, eng.n_samples, 50)
        split = sparse_split(eng, st, n_atlas)
        log(f"  chi^2 history {np.round(hist, 1).tolist()}; atoms A "
            f"{st.atoms_a.n.tolist()}, P {int(st.atoms_p.n[0])}; P mass "
            f"drift {drift:.3g} (limit {limit:.3g}); one more iteration "
            f"in parts (ms): {json.dumps(split)}")
        if not falling(hist) or drift > limit:
            raise AssertionError("sparse sharded run: chi^2 not falling "
                                 "or P drifted")
        want = ({"atlas": 2 * n_atlas, "tables": 2 * n_atlas}
                if eng.mode == "xla" else {"tables": 4 * n_atlas})
        if got != want:
            raise AssertionError(f"sparse sharded launches {got}, expected "
                                 f"{want} in mode {eng.mode!r}")
        err_a, errs["tables"] = unit_checks("15 (c)", eng, st, eng.shards,
                                            19, n_atlas)
        a_kind = "atlas" if eng.mode == "xla" else "tables"
        errs[a_kind] = max(errs.get(a_kind, 0.0), err_a)
        del eng, st, ss

        # (b), (d), (e) on one rank, and the resumes from 2 ranks' files
        one = {}
        for part, kind, n_it in (("(b)", "dense", 20), ("(d)", "sparse", 5),
                                 ("(e)", "chains", 100),
                                 ("(b)", "percall", 30)):
            (_, _, ss, secs), got, held = counted(
                kind, lambda: run_job(kind, n_it, p(kind[0] + "1")))
            one[kind] = got
            run_report(f"{part} {kind}, mesh=None", ss, secs, got, n_it,
                       held)
        if not (one["chains"].get("span") and not one["chains"].get("sweep")):
            raise AssertionError(f"the chains left the fused span: "
                                 f"{one['chains']}")
        if one["percall"] != {"sweep": 2 * 2 * 30, "dense_tables": 2 * 2 * 30}:
            raise AssertionError(f"the per-call chains launched "
                                 f"{one['percall']}, not K1 and the tables "
                                 f"kernel twice an iteration")
        for kind, n_it, resume, out in (("dense", 20, "dmid", "dr"),
                                        ("chains", 100, "cmid", "cr")):
            counted(kind, lambda: run_job(kind, n_it, p(out),
                                          resume=p(resume)))
        checks = [("dense", "d1", "d2", "2 ranks"),
                  ("dense", "d1", "d4", "4 ranks"),
                  ("dense", "d1", "dr", "resumed on 1 from 2 ranks"),
                  ("sparse", "s1", "s2", "2 ranks"),
                  ("chains", "c1", "c2", "2 ranks"),
                  ("chains", "c1", "cr", "resumed on 1 from 2 ranks"),
                  ("percall", "p1", "q2", "2 ranks"),
                  ("percall", "p1", "q4", "4 ranks")]
        for kind, a, b, what in checks:
            n = same_bits(kind, p(a), p(b), f"{kind}, {what}")
            log(f"  {kind}: mesh=None == {what}, all {n} leaves bit-equal")
    return dict(total), errs


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cogaps_tpu_torch")):
        log("cogaps_tpu_torch is not beside this script: run it from a "
            "checkout of the repository")
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 3
    import cogaps_tpu_torch
    from cogaps_tpu_torch.ops import (atlas_cuda, span_cuda, sweep_cuda,
                                      tables_cuda)

    device = torch.device("cuda")
    card = nvidia_smi()
    t_all = time.perf_counter()

    # 1. device
    log(f"[1 device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    builds = build_all()
    log(f"[2 build] the six kernel sources and the native parser built "
        f"and loaded in "
        f"{time.perf_counter() - t0:.1f} s (" + ", ".join(
            f"{name} {sec:.1f} s" for name, (sec, _) in builds.items()) + ")")
    for name, (_, report) in builds.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas ({name}): {line.strip()}")

    # 3. kernel vs plain version
    from cogaps_tpu_torch.bench_harness import synthetic_coo, synthetic_sparse
    from cogaps_tpu_torch.parallel.atlas_engine import AtlasEngine
    t0 = time.perf_counter()
    log(f"  sweep_kernel width classes, ptxas (registers, bytes of spill "
        f"stores): {sweep_classes(builds['sweep'][1])}")
    [D_sparse] = synthetic_sparse(2000, 10000, 10, 1, 11)
    k1_cases, k2_cases = sweep_cases(device, D_sparse)
    kernel_times, max_err = run_sweep_cases(k1_cases, device)
    tables_times, tables_err = run_sweep_cases(k2_cases, device)
    del k1_cases, k2_cases
    t1 = time.perf_counter()
    coo = synthetic_coo(30000, 50000, 0.02, 17)
    t2 = time.perf_counter()
    atlas_params = cogaps_tpu_torch.CogapsParams(
        n_patterns=50, n_iterations=100, seed=9, sparse_optimization=True,
        output_frequency=25)
    atlas = AtlasEngine(coo, atlas_params.engine_config(*coo.shape),
                        chisq_every=1, device=device)
    torch.cuda.synchronize()
    atlas_setup = (t2 - t1, time.perf_counter() - t2, len(coo.vals))
    del coo
    atlas_times, atlas_err = phase_atlas_kernel(device, atlas.side_a,
                                                atlas.side_p)
    span_times, span_err, span_extra = phase_span(device, builds["span"][1])
    dense_rows, dense_err = phase_tables(device, builds["tables"][1], card)
    log(f"[3 kernels] K1, K2, K3 == plain versions, K4 within its per-call "
        f"contract, the tables kernel within its tolerance, at the "
        f"main-path shapes ({time.perf_counter() - t0:.1f} s)")

    # 4. CoGAPS() on GIST: the main path, with its debug checks
    from cogaps_tpu_torch import api
    checked = []

    def counted_check(state, k, check=api.check_state):
        check(state, k)
        checked.append(k)

    api.check_state = counted_check
    golden = gist_golden_mcs()
    n_it = 2000
    t0 = time.perf_counter()
    sweep_cuda.run_updates_multi.launches = 0
    tables_cuda.dense_tables.launches = 0
    res = cogaps_tpu_torch.CoGAPS(GIST_CSV, n_patterns=7,
                                  n_iterations=n_it, seed=42,
                                  messages=False, debug_checks=True,
                                  device="cuda")
    launches = sweep_cuda.run_updates_multi.launches
    dense_by = {"4": tables_cuda.dense_tables.launches}
    elapsed = time.perf_counter() - t0
    mcs = res.mean_chi_sq
    log(f"[4 CoGAPS] GIST k=7 {n_it} iterations: meanChiSq {mcs:.1f} "
        f"(gate < {2 * golden:.1f}), totalUpdates "
        f"{res.diagnostics['totalUpdates']}, {elapsed:.2f} s, kernel "
        f"launches {launches}, tables kernel {dense_by['4']}; debug_checks:"
        f" check_state passed after {len(checked)} phases")
    if not np.isfinite(mcs) or mcs >= 2.0 * golden:
        raise AssertionError(f"CoGAPS did not converge: {mcs}")
    if launches < 2 * 2 * n_it:
        raise AssertionError(f"only {launches} kernel launches")
    if dense_by["4"] != 2 * 2 * n_it:
        raise AssertionError(f"{dense_by['4']} tables launches, not two an "
                             f"iteration")
    if len(checked) != 2:
        raise AssertionError(f"check_state ran {len(checked)} times")
    dense_by["4 (k=90)"] = phase_many_patterns(device, card)

    # 5. throughput path: the fused span, then the per-call route
    import functools
    from cogaps_tpu_torch.bench_harness import (run_throughput,
                                                synthetic_dense,
                                                throughput_engine, time_run)
    from cogaps_tpu_torch.engine import ChainEngine
    from cogaps_tpu_torch.io import parsers
    D, _, _ = parsers.read_matrix(GIST_CSV)
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=7, n_iterations=2000, seed=42, output_frequency=0)
    t0 = time.perf_counter()
    span_cuda.run_span.launches = 0
    sweep_cuda.run_updates_multi.launches = 0
    r = run_throughput(D, params, n_chains=16, device="cuda")
    span_launches = span_cuda.run_span.launches
    fused_sweeps = sweep_cuda.run_updates_multi.launches
    eng, rand = throughput_engine(D, params, 16, None, device)
    tables_cuda.dense_tables.launches = 0
    r_call = time_run(eng, rand, D, None,
                      functools.partial(ChainEngine.run_phase, eng))
    dense_by["5"] = tables_cuda.dense_tables.launches
    for route, x in (("fused span (K3)", r), ("per-call", r_call)):
        log(f"[5 throughput] GIST k=7, 16 chains, 2000 iterations, {route}:"
            f" {x['updates_per_second']:.1f} updates/s "
            f"({x['total_updates']} updates in {x['elapsed_s']:.3f} s), "
            f"meanChiSq {x['mean_chi_sq']:.1f} (gate < {2 * golden:.1f})")
    log(f"  K3 launches {span_launches}, sweep-kernel launches in the fused"
        f" run {fused_sweeps}, tables launches in the per-call run "
        f"{dense_by['5']}; card: {card}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    n_run = 2000 + min(eng.config.dispatch_iters, 2000)  # with warm-up
    if dense_by["5"] != 2 * 2 * n_run:
        raise AssertionError(f"{dense_by['5']} tables launches in the "
                             f"per-call run, not two an iteration")
    if max(r["mean_chi_sq"], r_call["mean_chi_sq"]) >= 2.0 * golden:
        raise AssertionError("throughput run did not converge")
    if span_launches < 2 * 2000 // span_cuda.CHUNK or fused_sweeps:
        raise AssertionError("the throughput run did not take the fused span")

    # 6. realistic size
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    Ds = synthetic_dense(5000, 2000, 10, 4, 42)
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=10, n_iterations=100, seed=7, output_frequency=25)
    cfg = params.engine_config(5000, 2000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = stack_device_data(Ds, None, cfg, device)
    eng = MultichainEngine(data, cfg, device)
    rand = PhiloxRandom([7 + c for c in range(4)], device)
    state, stats = eng.init_state(), eng.init_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables_cuda.dense_tables.launches = 0
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = eng.run_phase(state, stats, rand, ph)
    hist = stats.chisq_hist.cpu().numpy()  # waits for the device
    t2 = time.perf_counter()
    dense_by["6"] = tables_cuda.dense_tables.launches
    ups = int(stats.upd.sum()) / (t2 - t1)
    log(f"[6 realistic] 4 chains x 5000x2000, k=10, 100+100 iterations:"
        f" {ups:.1f} updates/s, {t2 - t1:.2f} s (+{t1 - t0:.2f} s set-up),"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; atoms A {state.atoms_a.n.tolist()} P "
        f"{state.atoms_p.n.tolist()}; tables launches {dense_by['6']}")
    for c in range(4):
        log(f"  chain {c} chi^2 history {np.round(hist[c], 1).tolist()}")
    if not np.isfinite(hist).all() or not (hist[:, -1] < hist[:, 0]).all():
        raise AssertionError("chi^2 history is not finite and falling")
    if dense_by["6"] != 2 * 2 * 100:
        raise AssertionError(f"{dense_by['6']} tables launches, not two an "
                             f"iteration")
    # the same data at k=20 and k=100: both samplers' tables in column
    # tiles (mma_tiles_kernel; at k=100 on a ring of two stages, and K1
    # above k = 64), the per-call route
    del eng, data, state, stats
    for k in (20, 100):
        dense_by[f"6 (k={k})"] = realistic_run(Ds, k, device)
    del Ds
    # bulk data of few samples: A's tables below 64 partners above k = 12
    dense_by["6 (20000x40 k=20)"] = bulk_few_samples_run(device, card)

    # 7. the sparse model through CoGAPS()
    from cogaps_tpu_torch.sparse_engine import resolve_sparse_mode
    t0 = time.perf_counter()
    mode_ms, n_a, n_p = time_modes(D_sparse, device)
    log(f"[7 sparse] iteration time by mode at 2000x10000 k=10 "
        f"({(D_sparse == 0).mean():.4f} zeros, {int((D_sparse != 0).sum())}"
        f" nonzeros), from one state after 150 iterations (atoms A {n_a}, "
        f"P {n_p}): " + ", ".join(f"{m} {ms:.4f} ms"
                                  for m, ms in mode_ms.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    mode = resolve_sparse_mode(1, 2000, 10000, 10, device)
    n_sp = 500
    sweep_cuda.run_updates_multi.launches = 0
    atlas_cuda.run_updates_atlas_multi.launches = 0
    t0 = time.perf_counter()
    checked.clear()
    res = cogaps_tpu_torch.CoGAPS(D_sparse, n_patterns=10,
                                  n_iterations=n_sp, seed=5,
                                  sparse_optimization=True, messages=False,
                                  output_frequency=100, debug_checks=True,
                                  device="cuda")
    sparse_launches = {"sweep": sweep_cuda.run_updates_multi.launches,
                       "atlas": atlas_cuda.run_updates_atlas_multi.launches}
    elapsed = time.perf_counter() - t0
    h = np.asarray(res.diagnostics["chisqHistory"])
    ups = res.diagnostics["totalUpdates"] / res.diagnostics[
        "totalRunningTime"]
    log(f"  CoGAPS(sparse_optimization=True) k=10 {n_sp} iterations, mode "
        f"{mode}: meanChiSq {res.mean_chi_sq:.1f}, {ups:.1f} updates/s "
        f"({res.diagnostics['totalUpdates']} updates), {elapsed:.2f} s, "
        f"launches {sparse_launches}; debug_checks: check_state passed "
        f"after {len(checked)} phases; chi^2 history "
        f"{np.round(h, 1).tolist()}")
    if not np.isfinite(res.mean_chi_sq) or not h[-1] < 0.2 * h[0]:
        raise AssertionError("sparse CoGAPS did not converge")
    if sum(sparse_launches.values()) < 2 * 2 * n_sp:
        raise AssertionError(f"only {sparse_launches} kernel launches")
    if len(checked) != 2:
        raise AssertionError(f"check_state ran {len(checked)} times")

    # 8. sparse multichain
    from cogaps_tpu_torch.sparse_engine import (SparseMultichainEngine,
                                                stack_sparse_device_data)
    Ds = synthetic_sparse(2000, 10000, 10, 4, 12)
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=10, n_iterations=200, seed=8, output_frequency=50)
    cfg = params.engine_config(2000, 10000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data, _ = stack_sparse_device_data(Ds, cfg, device)
    del Ds
    eng = SparseMultichainEngine(data, cfg, device)
    rand = PhiloxRandom([8 + c for c in range(4)], device)
    state, stats = eng.init_state(), eng.init_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sweep_cuda.run_updates_multi.launches = 0
    atlas_cuda.run_updates_atlas_multi.launches = 0
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = eng.run_phase(state, stats, rand, ph)
    hist = stats.chisq_hist.cpu().numpy()
    t2 = time.perf_counter()
    multi_launches = {"sweep": sweep_cuda.run_updates_multi.launches,
                      "atlas": atlas_cuda.run_updates_atlas_multi.launches}
    log(f"[8 sparse multichain] 4 chains x 2000x10000, k=10, mode "
        f"{eng.config.sparse_table_mode}, 200+200 iterations: "
        f"{int(stats.upd.sum()) / (t2 - t1):.1f} updates/s, {t2 - t1:.2f} s "
        f"(+{t1 - t0:.2f} s set-up), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{multi_launches}")
    for c in range(4):
        log(f"  chain {c} chi^2 history {np.round(hist[c], 1).tolist()}")
    if not all(falling(hist[c]) for c in range(4)):
        raise AssertionError("sparse chi^2 history is not finite and falling")

    # 9. atlas
    from cogaps_tpu_torch.ops.atoms import total_mass_per_element
    from cogaps_tpu_torch.parallel.atlas_engine import AtlasRandom
    from cogaps_tpu_torch.models import sparse as sparse_model
    torch.cuda.reset_peak_memory_stats()
    state, stats = atlas.init_state(), atlas.init_stats()
    chisq0 = float(sparse_model.sparse_chisq(atlas.side_a, state.M_a[0],
                                             state.M_p[0]))
    rand = AtlasRandom(9, device)
    atlas_cuda.run_updates_atlas_multi.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = atlas.run_phase(state, stats, rand, ph)
    hist = stats.chisq_hist[0].cpu().numpy()
    t1 = time.perf_counter()
    atlas_launches = atlas_cuda.run_updates_atlas_multi.launches
    k = atlas.k
    drift = max(
        float(((total_mass_per_element(st_atoms.chain(0), nr * k)
                .reshape(nr, k) - Mx[0]).abs()
               - 2e-4 * Mx[0].abs()).max())
        for st_atoms, Mx, nr in ((state.atoms_a, state.M_a, atlas.n_genes),
                                 (state.atoms_p, state.M_p,
                                  atlas.n_samples)))
    log(f"[9 atlas] 30000x50000 COO, {atlas_setup[2]} nonzeros, k=50, "
        f"100+100 iterations: {int(stats.upd.sum()) / (t1 - t0):.1f} "
        f"updates/s ({int(stats.upd.sum())} updates in {t1 - t0:.2f} s), "
        f"set-up {atlas_setup[0]:.1f} s COO generation + {atlas_setup[1]:.1f}"
        f" s COO -> CSR, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K4 launches "
        f"{atlas_launches}, atoms A {int(state.atoms_a.n[0])} P "
        f"{int(state.atoms_p.n[0])}; chi^2 {chisq0:.1f} at the start, "
        f"history {np.round(hist, 1).tolist()}; M - atom masses beyond "
        f"2e-4: {drift:.3g}")
    if not falling(np.concatenate([[chisq0], hist])) or drift > 2e-4:
        raise AssertionError("atlas run: chi^2 not falling or M drifted")
    if atlas_launches < 2 * 200:
        raise AssertionError(f"only {atlas_launches} K4 launches")

    # 10. the probe suite
    from cogaps_tpu_torch.probes import __main__ as probe_suite
    for wrappers in probe_suite.WRAPPERS_OF.values():
        for w in wrappers:
            w.launches = 0
    t0 = time.perf_counter()
    log("[10 probes] kernel vs plain version and times of F1-F11; card: "
        f"{card}")
    probe_records = probe_suite.run_suite(device, log=log)
    probe_launches = {f: sum(w.launches for w in wrappers)
                      for f, wrappers in probe_suite.WRAPPERS_OF.items()}
    log(f"  {len(probe_records)} cases, every kernel equal to its plain "
        f"version or within its tolerance; launches {probe_launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")

    # 11. distributed runs through GWCoGAPS() and scCoGAPS()
    t0 = time.perf_counter()
    dist_launches, dist_by_run, padded_err, dense_by["11"] = (
        phase_distributed(device, card))
    log(f"  launches by run and stage {json.dumps(dist_by_run)}; phase "
        f"{time.perf_counter() - t0:.1f} s")

    # 12. checkpoints
    t0 = time.perf_counter()
    ckpt_launches = phase_checkpoint(device)
    dense_by["12"] = ckpt_launches["dense_tables"]
    log(f"  phase {time.perf_counter() - t0:.1f} s")

    # 13. the command line on one scCoGAPS worker's single-cell subset
    t0 = time.perf_counter()
    cli_launches = phase_cli(D_sparse, card)
    log(f"  phase {time.perf_counter() - t0:.1f} s")

    # 14. the sequential oracle against both routes
    t0 = time.perf_counter()
    oracle_launches, oracle_k1_err, oracle_k3_err = phase_oracle(device,
                                                                 card)
    dense_by["14"] = oracle_launches["per-call"]["dense_tables"]
    log(f"  phase {time.perf_counter() - t0:.1f} s")

    # 15. gene-sharded chains and chain-sharded runs
    t0 = time.perf_counter()
    sharded_launches, sharded_errs = phase_sharded(device, card)
    dense_by["15"] = sharded_launches.get("dense_tables", 0)
    log(f"  phase {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, launches, err, row, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row[1], "plain_ms": row[2],
                "bound_ms": row[3], "bound_by": row[4], "library_ms": None,
                "shape": row[0], **extra}

    # launches by main-path phase: the dense sweep (K1) in phases 4, 11
    # (GWCoGAPS's fixed stages), 12, 14 (the per-call route) and 15 (the
    # dense sharded engine); the same kernel on the sparse tables (K2) in
    # 7, 8, 11 (scCoGAPS), 13 (the CLI) and 15 (the sparse sharded
    # engine); K3 in 5, 11, 14 (the fused route) and 15 (the chains); K4
    # in 9, and in 15 where the sparse mode rule picks it
    sweep_by = {"4": launches, "11": sum(
                    st["sweep"] for run, stages in dist_by_run.items()
                    if run != "scCoGAPS" for st in stages),
                "12": ckpt_launches["sweep"],
                "14": oracle_launches["per-call"]["sweep"],
                "15": sharded_launches.get("sweep", 0)}
    tables_by = {"7": sparse_launches["sweep"], "8": multi_launches["sweep"],
                 "11": sum(st["sweep"] for st in dist_by_run["scCoGAPS"]),
                 "13": cli_launches["sweep"],
                 "15": sharded_launches.get("tables", 0)}
    span_by = {"5": span_launches, "11": dist_launches["span"],
               "14": oracle_launches["fused"]["span"],
               "15": sharded_launches.get("span", 0)}
    atlas_by = {"7": sparse_launches["atlas"], "8": multi_launches["atlas"],
                "9": atlas_launches, "11": dist_launches["atlas"]}
    if sharded_launches.get("atlas"):
        atlas_by["15"] = sharded_launches["atlas"]

    def by_phase(counts):
        return dict(launches=sum(counts.values()), launches_by_phase=counts)

    kernel_line = {"kernels": [
        entry("sweep", "cogaps_tpu_torch/csrc/sweep.cu",
              "cogaps_tpu/ops/pallas_sweep.py:815", 0,
              max(max_err, oracle_k1_err, sharded_errs["sweep"]),
              kernel_times[0], device_ms=kernel_times[0][8]) | by_phase(
                  sweep_by),
        entry("sweep_tables", "cogaps_tpu_torch/csrc/sweep.cu",
              "cogaps_tpu/ops/pallas_sweep.py:1074", 0,
              max(tables_err, sharded_errs["tables"]),
              tables_times[0], device_ms=tables_times[0][8]) | by_phase(
                  tables_by),
        entry("atlas", "cogaps_tpu_torch/csrc/atlas.cu",
              "cogaps_tpu/ops/pallas_atlas.py:760", 0,
              max(atlas_err, sharded_errs.get("atlas", 0.0)),
              atlas_times[0]) | by_phase(atlas_by),
        entry("span", "cogaps_tpu_torch/csrc/span.cu",
              "cogaps_tpu/ops/pallas_iter.py:161", 0,
              max(span_err, padded_err, oracle_k3_err),
              span_times) | by_phase(span_by),
        # no Pallas counterpart: the JAX package's XLA dots of an update
        # call's tables
        entry("dense_tables", "cogaps_tpu_torch/csrc/tables.cu",
              "cogaps_tpu/models/dense.py:108", 0, dense_err,
              dense_rows[TABLES_HEADLINE], device_ms=dense_rows[
                  TABLES_HEADLINE][5], library_ms=dense_rows[
                      TABLES_HEADLINE][2]) | by_phase(dense_by),
    ] + probe_suite.kernel_entries(probe_records, probe_launches)}
    if min(e["launches"] for e in kernel_line["kernels"]) <= 0:
        raise AssertionError("a kernel of the path was never launched")
    log(f"K3 rebuild alone (P*r): {json.dumps(span_extra['rebuilds'])}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(kernel_line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        rc = main()
    finally:
        stopped = stop_descendants()
        if stopped:
            print(f"stopped {len(stopped)} process(es) still running at the "
                  f"end: {stopped}", file=sys.stderr, flush=True)
        if descendants():
            print("a process could not be stopped", file=sys.stderr,
                  flush=True)
    sys.exit(rc)
