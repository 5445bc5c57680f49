"""Whole dense iterations in one launch: the fused-span kernel K3
(csrc/span.cu) and its wrapper.

``run_span`` is the counterpart of cogaps_tpu/ops/pallas_iter.py::
run_span_fused: n_it whole MCMC iterations of NCH chains (budgets, both
samplers' table rebuilds and sweeps, the sampling-phase statistics and
the counters), one launch per chunk of at most CHUNK iterations, with
nothing read back to the host. For tensors on the CPU it runs the plain
version (ops/span.run_span_plain); for CUDA tensors it launches the
kernel or raises.

The chunk: the JAX package cut its spans at 50 iterations for the TPU's
watchdog, and the H100 has none. Here the chunk bounds the budget normals
drawn ahead of a launch ((NCH, CHUNK, 2) floats) and sets how often the
caller sees progress (MultichainEngine.run_phase calls progress_cb at
chunk ends). A GIST chunk keeps the card busy for tens of milliseconds,
against a few microseconds to launch it, so 50 is kept.

``rebuild_tables`` launches the kernel's rebuild alone on one state: the
counterpart of tools/probe_rebuild.py, which checked the TPU kernel's
in-kernel rebuild contractions.

The kernel is built from csrc/span.cu (with csrc/sweep_common.cuh and
csrc/dense_model.cuh) by ops/cuda_build.py at first use.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import engine
from . import cuda_build
from .span import SpanTables, rebuild_tables_plain, run_span_plain
from .sweep_cuda import MAX_BATCH, KernelState

CHUNK = 50


def rebuild_ops(G: int, S: int, k: int) -> int:
    """float64 operations of one chain's two table rebuilds in one
    iteration (csrc/span.cu::rebuild): per data entry and sampler, its
    residual entry (2k + 2), its terms of the row's Y sums (2k), SQ sums
    (3k) and Z sums over the pairs c <= c' (3 k(k+1)/2)."""
    return 2 * G * S * (7 * k + 2 + 3 * (k * (k + 1) // 2))


def build() -> tuple:
    """Compile csrc/span.cu (once per source hash) and load it. Returns
    (ctypes library, compiler report)."""
    lib, report = cuda_build.load("span")
    fn = lib.cogaps_span_launch
    fn.argtypes = ([ctypes.c_int] * 13 + [ctypes.c_float] * 4
                   + [ctypes.c_void_p] * 44)
    fn.restype = ctypes.c_int
    fn = lib.cogaps_span_rebuild
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 16
    fn.restype = ctypes.c_int
    return lib, report


def run_span(cfg, consts_a, consts_p, hist: engine.HistConfig, phase: int,
             data: engine.DeviceData, it0: int, n_it: int,
             state: engine.ChainState, stats: engine.RunStats, rand):
    """Iterations [it0, it0 + n_it) of one phase of every chain, as
    engine.run_iteration runs them one at a time. The kernel samples both
    factors and records no history, snapshot or PUMP count; `rand` is an
    engine.PhiloxRandom. The inputs are left untouched. Returns (state,
    stats)."""
    if (cfg.which_matrix_fixed != "N" or hist.n_hist or hist.snap_freq
            or cfg.take_pump_samples):
        raise ValueError("the fused span samples both factors and records "
                         "no history, snapshot or PUMP count")
    if state.M_a.device.type == "cpu":
        return run_span_plain(cfg, consts_a, consts_p, hist, phase, data,
                              it0, n_it, state, stats, rand)
    if state.M_a.device.type != "cuda":
        raise ValueError(f"no fused span for tensors on {state.M_a.device}")
    if not isinstance(rand, engine.PhiloxRandom):
        raise TypeError("the fused span draws from an engine.PhiloxRandom")
    return _run_kernel(cfg, consts_a, consts_p, phase, data, it0, n_it,
                       state, stats, rand)


run_span.launches = 0


def _check_data(data: engine.DeviceData, NCH, G, S, dev):
    f32 = torch.float32
    for name, t, shape in (("D", data.D, (NCH, G, S)),
                           ("invS2", data.invS2, (NCH, G, S)),
                           ("D_t", data.D_t, (NCH, S, G)),
                           ("invS2_t", data.invS2_t, (NCH, S, G))):
        cuda_build.check(name, t, f32, shape, dev)


def _run_kernel(cfg, consts_a, consts_p, phase, data, it0, n_it, state,
                stats, rand):
    NCH, G, K = state.M_a.shape
    S = state.M_p.shape[1]
    dev = state.M_a.device
    f32, i32 = torch.float32, torch.int32
    _check_data(data, NCH, G, S, dev)
    for name, t, dt, shape in (
            ("a_sum", stats.a_sum, f32, (NCH, G, K)),
            ("a_sumsq", stats.a_sumsq, f32, (NCH, G, K)),
            ("p_sum", stats.p_sum, f32, (NCH, S, K)),
            ("p_sumsq", stats.p_sumsq, f32, (NCH, S, K)),
            ("n_stat", stats.n_stat, i32, (NCH,)),
            ("upd", stats.upd, torch.int64, (NCH,)),
            ("prop_counts", stats.prop_counts, i32, (NCH, 2, 4)),
            ("acc_counts", stats.acc_counts, i32, (NCH, 2, 4)),
            ("sweep_counts", stats.sweep_counts, i32, (NCH, 2)),
            ("key0", rand.key0, torch.int64, (NCH,))):
        cuda_build.check(name, t, dt, shape, dev)
    budget = torch.empty((2, NCH), dtype=i32, device=dev)
    st_a = KernelState.make(state.atoms_a, state.M_a, consts_a, data.mass_a,
                            budget[0])
    st_p = KernelState.make(state.atoms_p, state.M_p, consts_p, data.mass_p,
                            budget[1])
    # the kernel adds to copies of what it changes: the sums only while
    # sampling
    sums = [x.clone() if phase == engine.SAMPLING else x
            for x in (stats.a_sum, stats.a_sumsq, stats.p_sum,
                      stats.p_sumsq)]
    counts = [x.clone() for x in (stats.n_stat, stats.upd, stats.prop_counts,
                                  stats.acc_counts, stats.sweep_counts)]
    scratch = [torch.empty(shape, dtype=f32, device=dev) for shape in (
        (NCH, G, K), (NCH, G, K), (NCH, G * K, K),   # Y, SQ, Z of A
        (NCH, S, K), (NCH, S, K), (NCH, S * K, K),   # Y, SQ, Z of P
        (NCH, K))]                                   # column norms
    R = torch.empty((NCH, G * S), dtype=torch.float64, device=dev)
    colnz = torch.empty((2, NCH, K), dtype=i32, device=dev)
    lib, _ = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [x.data_ptr() for x in (
        data.mass_a.lam, data.mass_a.max_gibbs_mass, data.mass_p.lam,
        data.mass_p.max_gibbs_mass, data.D, data.invS2, data.D_t,
        data.invS2_t)]
    with torch.cuda.device(dev):
        for off in range(0, n_it, CHUNK):
            n = min(CHUNK, n_it - off)
            z = rand.budget_normals(phase, it0 + off, n)
            err = lib.cogaps_span_launch(
                NCH, G, S, K, n, phase, it0 + off, cfg.n_iterations,
                consts_a.batch, consts_a.capacity, consts_p.batch,
                consts_p.capacity, int(consts_a.local_moves),
                float(consts_a.alpha * consts_a.n_bins),
                float(consts_a.domain_length),
                float(consts_p.alpha * consts_p.n_bins),
                float(consts_p.domain_length), *ptr, z.data_ptr(),
                st_a.mass.data_ptr(), st_a.elem.data_ptr(),
                st_a.n.data_ptr(), st_p.mass.data_ptr(),
                st_p.elem.data_ptr(), st_p.n.data_ptr(), st_a.M.data_ptr(),
                st_p.M.data_ptr(), *(x.data_ptr() for x in sums),
                *(x.data_ptr() for x in counts), R.data_ptr(),
                *(x.data_ptr() for x in scratch), colnz[0].data_ptr(),
                colnz[1].data_ptr(), budget[0].data_ptr(),
                budget[1].data_ptr(), st_a.out.data_ptr(),
                st_p.out.data_ptr(), st_a.scratch.data_ptr(),
                st_p.scratch.data_ptr(), rand.key0.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(
                    f"span kernel launch failed: CUDA error {err}")
            run_span.launches += 1
    state = engine.ChainState(atoms_a=st_a.atoms(), atoms_p=st_p.atoms(),
                              M_a=st_a.M, M_p=st_p.M)
    stats = dataclasses.replace(
        stats, a_sum=sums[0], a_sumsq=sums[1], p_sum=sums[2],
        p_sumsq=sums[3], n_stat=counts[0], upd=counts[1],
        prop_counts=counts[2], acc_counts=counts[3], sweep_counts=counts[4])
    return state, stats


def rebuild_tables(data: engine.DeviceData, M_a: torch.Tensor,
                   M_p: torch.Tensor, threads: int = MAX_BATCH) -> SpanTables:
    """Both samplers' tables of the state (M_a, M_p) as the span kernel
    builds them, by its rebuild alone (`threads` per chain's block). For
    tensors on the CPU, the plain version (ops/span.rebuild_tables_plain).
    col_nz comes back as bool, as the plain version gives it."""
    if M_a.device.type == "cpu":
        return rebuild_tables_plain(data, M_a, M_p)
    if M_a.device.type != "cuda":
        raise ValueError(f"no table rebuild for tensors on {M_a.device}")
    NCH, G, K = M_a.shape
    S = M_p.shape[1]
    dev = M_a.device
    f32 = torch.float32
    _check_data(data, NCH, G, S, dev)
    cuda_build.check("M_a", M_a, f32, (NCH, G, K), dev)
    cuda_build.check("M_p", M_p, f32, (NCH, S, K), dev)
    out = [torch.empty(shape, dtype=f32, device=dev) for shape in (
        (NCH, G, K), (NCH, G, K), (NCH, G * K, K),
        (NCH, S, K), (NCH, S, K), (NCH, S * K, K))]
    colnz = torch.empty((2, NCH, K), dtype=torch.int32, device=dev)
    R = torch.empty((NCH, G * S), dtype=torch.float64, device=dev)
    lib, _ = build()
    with torch.cuda.device(dev):
        err = lib.cogaps_span_rebuild(
            NCH, G, S, K, threads, data.D.data_ptr(), data.invS2.data_ptr(),
            data.D_t.data_ptr(), data.invS2_t.data_ptr(), M_a.data_ptr(),
            M_p.data_ptr(), R.data_ptr(), *(x.data_ptr() for x in out[:3]),
            colnz[0].data_ptr(), *(x.data_ptr() for x in out[3:]),
            colnz[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span rebuild launch failed: CUDA error {err}")
    rebuild_tables.launches += 1
    return SpanTables(*out[:3], colnz[0] != 0, *out[3:], colnz[1] != 0)


rebuild_tables.launches = 0
