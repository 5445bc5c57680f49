#!/usr/bin/env python3
"""Smoke check of cogaps_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
sweep kernel from cogaps_tpu_torch/csrc/sweep.cu, holds it against its
plain PyTorch version on the card, drives the port's main path through
``CoGAPS()`` and the multi-chain throughput harness on GIST, runs a
5,000 x 2,000 k=10 dataset, and fails on the first phase that fails.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.

Phases:
  1 device  — name and power limit (nvidia-smi);
  2 build   — nvcc build of the sweep kernel, with ptxas's report;
  3 kernels — kernel vs plain version on CUDA tensors at the main path's
              sampler shapes (GIST A and P, and a 5000-row sampler), NCH=4,
              in exact mode (the same uniform slab) and in fast mode
              (in-kernel Philox): equal done, counts and elem table, mass
              and M within 1e-5, Y within 1e-3; per-call times;
  4 CoGAPS  — CoGAPS("data/GIST.csv", k=7, 2000 iterations, device=cuda):
              meanChiSq below 2x the golden GIST value, and the kernel
              launched at least twice per iteration of each phase;
  5 throughput — run_throughput on GIST, 16 chains, 2000 iterations,
              the same gate; updates/s;
  6 realistic — 4 chains of a synthetic 5000 x 2000 matrix (k=10), 100
              iterations per phase: a finite, falling chi^2 history;
              updates/s and peak device memory.

The last line is {"ok": true, "device": {...}}; the one before it is the
card's name and power limit; before that, one JSON line describing each
kernel of the path.
"""

import json
import os
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
    args = (case["atoms"], case["M"], case["Y"], case["phase"], 1.0,
            case["budgets"], case["consts"], case["mass"], source)
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


def phase_kernels(device):
    import torch
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.io import parsers
    from cogaps_tpu_torch.ops import sweep_cuda

    D_gist, _, _ = parsers.read_matrix(GIST_CSV)
    [D_big] = synthetic_dense(5000, 2000, 10, 1, 0)
    cases = [
        make_case("GIST A sampler (1363x9, k=7, B=1024, C=8192)", D_gist,
                  True, 7, 1024, 8192, 4, 4000, 1, device),
        make_case("GIST P sampler (9x1363, k=7, B=32, C=1024)", D_gist,
                  False, 7, 32, 1024, 4, 2000, 2, device),
        make_case("5000-row sampler (5000x2000, k=10, B=1024, C=32768)",
                  D_big, True, 10, 1024, 32768, 4, 4000, 3, device),
    ]
    del D_big
    results = []
    max_err = 0.0
    failed = []
    for case in cases:
        nch, B = case["nch"], case["B"]
        slab = torch.as_tensor(np.random.default_rng(7).random(
            (nch, 512 * 16, B), dtype=np.float32), device=device)

        def source(c, first, n, slab=slab):
            if (first + n) * 16 > slab.shape[1]:
                raise RuntimeError("uniform slab used up")
            return slab[c, first * 16:(first + n) * 16]

        key = sweep_cuda.PhiloxKey(
            key0=torch.arange(11, 11 + nch, device=device), key1=5)
        args = (case["atoms"], case["M"], case["Y"], case["phase"], 1.0,
                case["budgets"], case["consts"], case["mass"])
        for what, rand in (("exact", source), ("fast", key)):
            out_k = sweep_cuda.run_updates_multi(*args, rand)
            out_p = sweep_cuda.run_updates_multi_plain(*args, rand)
            torch.cuda.synchronize()
            problems, err = compare(case, out_k, out_p, what)
            max_err = max(max_err, err)
            if problems:
                log(f"  MISMATCH ({what}): {problems}")
                if what == "exact":
                    locate_divergence(case, source)
                failed.append((case["name"], what))

        # per-call times in fast mode
        for _ in range(2):
            sweep_cuda.run_updates_multi(*args, key)
        torch.cuda.synchronize()
        reps = 10
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            sweep_cuda.run_updates_multi(*args, key)
        stop.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(stop) / reps
        t0 = time.perf_counter()
        sweep_cuda.run_updates_multi_plain(*args, key)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        log(f"  {case['name']}: kernel {k_ms:.4f} ms/call, plain "
            f"{p_ms:.1f} ms/call (budget {int(case['budgets'][0])} x "
            f"{nch} chains)")
        results.append((case["name"], k_ms, p_ms))
    if failed:
        raise AssertionError(f"kernel and plain version disagree: {failed}")
    return results, max_err


# ----------------------------------------------------------------------
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
    from cogaps_tpu_torch.ops import sweep_cuda

    device = torch.device("cuda")
    card = nvidia_smi()
    t_all = time.perf_counter()

    # 1. device
    log(f"[1 device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _, report = sweep_cuda.build()
    log(f"[2 build] sweep kernel built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version
    t0 = time.perf_counter()
    kernel_times, max_err = phase_kernels(device)
    log(f"[3 kernels] kernel == plain version at the main-path shapes "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4. CoGAPS() on GIST: the main path
    golden = gist_golden_mcs()
    n_it = 2000
    t0 = time.perf_counter()
    sweep_cuda.run_updates_multi.launches = 0
    res = cogaps_tpu_torch.CoGAPS(GIST_CSV, n_patterns=7,
                                  n_iterations=n_it, seed=42,
                                  messages=False, device="cuda")
    launches = sweep_cuda.run_updates_multi.launches
    elapsed = time.perf_counter() - t0
    mcs = res.mean_chi_sq
    log(f"[4 CoGAPS] GIST k=7 {n_it} iterations: meanChiSq {mcs:.1f} "
        f"(gate < {2 * golden:.1f}), totalUpdates "
        f"{res.diagnostics['totalUpdates']}, {elapsed:.2f} s, kernel "
        f"launches {launches}")
    if not np.isfinite(mcs) or mcs >= 2.0 * golden:
        raise AssertionError(f"CoGAPS did not converge: {mcs}")
    if launches < 2 * 2 * n_it:
        raise AssertionError(f"only {launches} kernel launches")

    # 5. throughput path
    from cogaps_tpu_torch.bench_harness import run_throughput, synthetic_dense
    from cogaps_tpu_torch.io import parsers
    D, _, _ = parsers.read_matrix(GIST_CSV)
    params = cogaps_tpu_torch.CogapsParams(
        n_patterns=7, n_iterations=2000, seed=42, output_frequency=0)
    t0 = time.perf_counter()
    r = run_throughput(D, params, n_chains=16, device="cuda")
    log(f"[5 throughput] GIST k=7, 16 chains, 2000 iterations: "
        f"{r['updates_per_second']:.1f} updates/s "
        f"({r['total_updates']} updates in {r['elapsed_s']:.3f} s), "
        f"meanChiSq {r['mean_chi_sq']:.1f} (gate < {2 * golden:.1f}); "
        f"card: {card}; phase {time.perf_counter() - t0:.1f} s")
    if r["mean_chi_sq"] >= 2.0 * golden:
        raise AssertionError("throughput run did not converge")

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
    del Ds
    eng = MultichainEngine(data, cfg, device)
    rand = PhiloxRandom([7 + c for c in range(4)], device)
    state, stats = eng.init_state(), eng.init_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = eng.run_phase(state, stats, rand, ph)
    hist = stats.chisq_hist.cpu().numpy()  # waits for the device
    t2 = time.perf_counter()
    ups = int(stats.upd.sum()) / (t2 - t1)
    log(f"[6 realistic] 4 chains x 5000x2000, k=10, 100+100 iterations:"
        f" {ups:.1f} updates/s, {t2 - t1:.2f} s (+{t1 - t0:.2f} s set-up),"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; atoms A {state.atoms_a.n.tolist()} P "
        f"{state.atoms_p.n.tolist()}")
    for c in range(4):
        log(f"  chain {c} chi^2 history {np.round(hist[c], 1).tolist()}")
    if not np.isfinite(hist).all() or not (hist[:, -1] < hist[:, 0]).all():
        raise AssertionError("chi^2 history is not finite and falling")

    kernel_line = {"kernels": [{
        "name": "sweep",
        "route": "cuda",
        "source": "cogaps_tpu_torch/csrc/sweep.cu",
        "replaces": "cogaps_tpu/ops/pallas_sweep.py:815",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_times[0][1],
        "plain_ms": kernel_times[0][2],
        "shape": kernel_times[0][0],
    }]}
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(kernel_line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
