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

Both kernels run one thread-block cluster per chain (``cluster_size``,
up to 16 CTAs). Each sampler's table rebuild runs on the FP64 tensor
cores, its work dealt over the cluster's CTAs as ``rebuild_plan`` says
and its sums in an order of the shape alone (``chunks``;
``rebuild_tables_split`` is the plain model of that order); the sweeps
run on the rank-0 CTA on the state ``sweep_plan`` places in its shared
memory, as K1's ``smem_plan`` does. The kernel is built from
csrc/span.cu (with csrc/sweep_common.cuh and csrc/dense_model.cuh) by
ops/cuda_build.py at first use.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .. import engine
from ..utils import trace
from . import cuda_build
from .span import SpanTables, rebuild_tables_plain, run_span_plain
from .sweep_cuda import (MAX_BATCH, PLACED, SMEM_BLOCK, STATIC_SMEM,
                         KernelState, SmemPlan, pack)

CHUNK = 50
# cluster sizes tried, largest first: powers of two up to 16, past the
# portable 8 (csrc/span.cu allows non-portable sizes)
CLUSTER_SIZES = (16, 8, 4, 2, 1)
NTW = 3  # column tiles of 8 a warp's item holds (csrc/span.cu::kNTW)
# the partner chunks of a sampler's sums: at most MAX_CHUNK partners a
# chunk; below FEW_ROWS rows, up to CHUNK_UNITS chunks of at least
# MIN_CHUNK partners, so that a cluster's CTAs share the work
MAX_CHUNK = 256
MIN_CHUNK = 64
FEW_ROWS = 256
CHUNK_UNITS = 8
TILE_BYTES = 160 * 1024  # shared memory of one sampler's staged tiles


def rebuild_ops(G: int, S: int, k: int) -> int:
    """float64 operations of one chain's two table rebuilds in one
    iteration, as the table sums are written: per data entry and
    sampler, its residual entry (2k + 2), its terms of the row's Y sums
    (2k), SQ sums (3k) and Z sums over the pairs c <= c' (3 k(k+1)/2).
    The fused route's gate (parallel/multichain.py) measures work by it;
    csrc/span.cu does fewer (SQ is Z's diagonal, and a pair's product of
    partner values is formed once a partner)."""
    return 2 * G * S * (7 * k + 2 + 3 * (k * (k + 1) // 2))


def column_groups(k: int) -> tuple:
    """(gy, gz): the groups of four output columns of a table row, Y's k
    columns and the k(k+1)/2 pairs c <= c' of Z."""
    return -(-k // 4), -(-(k * (k + 1) // 2) // 4)


def column_tiles(k: int) -> tuple:
    """(ny, nt): the tiles of eight output columns of a table row as
    csrc/span.cu::Cols lays them out: Y's k columns in [0, ny), then the
    k(k+1)/2 pairs c <= c' of Z, nt in all."""
    ny = -(-k // 8)
    return ny, ny + -(-(k * (k + 1) // 2) // 8)


def block_start(nt: int, ncb: int, b: int) -> int:
    """The first column tile of column block b of ncb (csrc/span.cu)."""
    return b * nt // ncb


def block_threads(B_a: int, B_p: int, k: int) -> int:
    """Threads of each CTA: the wider sampler's proposal lanes, and at
    least one thread per group of four output columns, in whole warps."""
    t = 32 * -(-max(B_a, B_p, sum(column_groups(k))) // 32)
    if t > MAX_BATCH:
        raise ValueError(f"k={k} has more table column groups than "
                         f"{MAX_BATCH} threads")
    return t


def chunks(NR: int, m: int) -> tuple:
    """(cj, n): the partner chunks of one sampler's sums (NR rows, m
    partners): n chunks of cj partners, a multiple of 4, the last shorter.
    Each chunk's float64 sums run over its partners in order, four at a
    time; the kernel adds the chunks' partials in chunk order. They
    follow from the shape alone, so a sum's order never depends on the
    cluster size or the chains beside it: one chunk up to MAX_CHUNK
    partners where rows are many, and below FEW_ROWS rows up to
    CHUNK_UNITS chunks of at least MIN_CHUNK, work for a cluster's CTAs."""
    n = -(-m // MAX_CHUNK)
    if NR < FEW_ROWS:
        n = max(n, min(CHUNK_UNITS, -(-m // MIN_CHUNK)))
    cj = 4 * -(-(-(-m // n)) // 4)
    return cj, -(-m // cj)


class SidePlan(NamedTuple):
    """One sampler's rebuild plan (csrc/span.cu::SidePlan). Units of
    (row tile of tile_rows rows, chunk of cj partners) are dealt to a
    cluster's CTAs in contiguous runs of equal length, chunk-major; a CTA stages a
    unit's partners tile_j at a time, and its warps take items of 16 rows
    by one of the ncb column blocks, cb_wave blocks a pass over the
    partners."""

    cj: int
    nchunk: int
    tile_rows: int
    tile_j: int
    cb_wave: int
    ncb: int


def rebuild_bytes(plan: SidePlan, k: int) -> int:
    """Shared memory of a CTA's rebuild tiles (csrc/span.cu::rebuild), in
    doubles' bytes: factor rows (tile_rows, kstride) and partner values
    (tile_j, kstride), k padded to a multiple of 4; the pass's columns
    (tile_j, bstride); R and W (tile_rows, astride). Each stride is 4 mod
    8 doubles."""
    _, nt = column_tiles(k)
    kstride = 8 * -(-(-(-k // 4) * 4) // 8) + 4
    astride = 8 * -(-plan.tile_j // 8) + 4
    wave_nt = plan.cb_wave * -(-nt // plan.ncb)
    bstride = 8 * wave_nt + 4
    return 8 * ((plan.tile_rows + plan.tile_j) * kstride
                + plan.tile_j * bstride + 2 * plan.tile_rows * astride)


def rebuild_plan(NR: int, m: int, k: int, threads: int, cl: int) -> SidePlan:
    """The rebuild of one sampler (NR table rows, m partners) on a cluster
    of `cl` CTAs of `threads` threads. The chunks, which set the order
    of every sum, come from the shape alone (chunks()); the rest only
    deals the work. Column blocks hold up to NTW column tiles, evened out;
    a pass takes as many blocks as there are warps, and rows in items of
    16 for the warps left, in row tiles of equal size -- at least as many
    units as CTAs where the rows allow, a multiple of cl where there is
    one chunk. Partners go in tiles of a multiple of 8 (the residual's
    products take 8 at a time): the whole chunk where it fits TILE_BYTES,
    else the most that fit (at least 32, or the chunk), rows or column
    blocks a pass given up first."""
    _, nt = column_tiles(k)
    ncb = -(-nt // NTW)
    warps = threads // 32
    cj, nchunk = chunks(NR, m)
    cb_wave = min(ncb, warps)
    subs = -(-NR // 16)
    n_rt = -(-subs // max(1, warps // cb_wave))
    if n_rt * nchunk < cl:
        n_rt = min(subs, -(-cl // nchunk))
    elif nchunk == 1:
        n_rt = min(subs, cl * -(-n_rt // cl))
    nsub = -(-subs // n_rt)
    while True:
        tile_j = 8 * -(-cj // 8)
        while tile_j > 8 and rebuild_bytes(
                SidePlan(cj, nchunk, 16 * nsub, tile_j, cb_wave, ncb),
                k) > TILE_BYTES:
            tile_j -= 8
        plan = SidePlan(cj, nchunk, 16 * nsub, tile_j, cb_wave, ncb)
        fits = rebuild_bytes(plan, k) <= TILE_BYTES
        if fits and (tile_j >= min(8 * -(-cj // 8), 32)
                     or (nsub == 1 and cb_wave == 1)):
            return plan
        if nsub > 1:
            nsub -= 1
        elif cb_wave > 1:
            cb_wave -= 1
        else:
            raise ValueError(f"k={k}: a partner tile does not fit "
                             f"{TILE_BYTES} bytes")


def fixed_bytes(k: int) -> int:
    """The fixed part of a CTA's dynamic shared memory (csrc/span.cu::
    carve): the pair table, col_nz flags and column norms."""
    return (4 * (k * (k + 1) // 2 + 2 * k) + 15) // 16 * 16


def sweep_plan(NR: int, k: int, C: int) -> SmemPlan:
    """Where the sweep stage keeps one sampler's chain state on the
    cluster's rank-0 CTA: sweep_cuda.pack's groups in order, as
    smem_plan places them for K1, in the shared memory past the fixed
    part that the rebuild's tiles take in turn (the same budget beside
    the static part, SweepShared)."""
    return pack(NR, k, C, budget=SMEM_BLOCK - STATIC_SMEM - fixed_bytes(k))


def smem_bytes(plans, k: int, places=()) -> int:
    """Dynamic shared memory of a CTA (csrc/span.cu::carve): the fixed
    part, then the largest of the sides' rebuild tiles and sweep
    placements, which take the region in turn."""
    return fixed_bytes(k) + max([rebuild_bytes(p, k) for p in plans]
                                + [pl.nbytes for pl in places])


def part_stride(G: int, S: int, k: int, plan_a: SidePlan,
                plan_p: SidePlan) -> int:
    """Doubles of a chain's chunk partials (csrc/span.cu::Rebuild.part):
    the larger side's (nchunk, NR, 8 nt), where it has more than one
    chunk."""
    ncols = 8 * column_tiles(k)[1]
    return max([1] + [p.nchunk * NR * ncols for p, NR in
                      ((plan_a, G), (plan_p, S)) if p.nchunk > 1])


def cluster_size(nch: int, sm_count: int,
                 max_active: Callable[[int], int]) -> int:
    """CTAs per chain: the largest of CLUSTER_SIZES whose nch clusters
    take at most one CTA an SM and are all resident at once
    (`max_active(cl)`, the card's cudaOccupancyMaxActiveClusters); 1 when
    none is."""
    for cl in CLUSTER_SIZES[:-1]:
        if nch * cl <= sm_count and max_active(cl) >= nch:
            return cl
    return 1


def span_fits(G: int, S: int, k: int, B_a: int, B_p: int) -> bool:
    """Whether K3 can launch a run of G x S data at k patterns with
    proposal batches B_a and B_p: block_threads' threads for its column
    groups (at most MAX_BATCH; k <= 88 at batches up to 1024) and, at
    every cluster size launch_shape may pick, both samplers' rebuild
    tiles (rebuild_plan). It asks exactly what those raise on, without
    raising."""
    try:
        threads = block_threads(B_a, B_p, k)
        for cl in CLUSTER_SIZES:
            rebuild_plan(G, S, k, threads, cl)
            rebuild_plan(S, G, k, threads, cl)
    except ValueError:
        return False
    return True


class LaunchShape(NamedTuple):
    cl: int
    plan_a: SidePlan
    plan_p: SidePlan
    smem: int
    place_a: Optional[SmemPlan] = None  # the sweeps' (span_kernel only)
    place_p: Optional[SmemPlan] = None

    def plan_ints(self) -> list:
        """Each side's SidePlan, then its sweep's byte offsets (-1:
        global), as csrc/span.cu reads them."""
        out = []
        for plan, place in ((self.plan_a, self.place_a),
                            (self.plan_p, self.place_p)):
            out += [int(x) for x in plan]
            out += [-1 if place is None or off is None else int(off)
                    for off in (place.slots if place is not None
                                else (None,) * len(PLACED))]
        return out


def launch_shape(kernel: int, device, nch: int, G: int, S: int, k: int,
                 threads: int, caps=None) -> LaunchShape:
    """The cluster size, both sides' plans, the sweeps' placements (of
    span_kernel: `caps`, the samplers' atom capacities) and the shared
    memory of a launch of span_kernel (kernel 0) or rebuild_kernel (1) on
    `device`. Its span counts the occupancy queries it made."""
    with trace.span("span.shape", kernel=kernel) as sp:
        lib, _ = build()
        places = (() if caps is None else
                  (sweep_plan(G, k, caps[0]), sweep_plan(S, k, caps[1])))

        def shape(cl):
            plans = (rebuild_plan(G, S, k, threads, cl),
                     rebuild_plan(S, G, k, threads, cl))
            return LaunchShape(cl, *plans, smem_bytes(plans, k, places),
                               *places)

        asked = []

        def max_active(cl):
            asked.append(cl)
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.cogaps_span_max_clusters(kernel, cl, threads,
                                                   shape(cl).smem,
                                                   ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"span cluster occupancy query: CUDA "
                                   f"error {err}")
            return n.value

        sm_count = torch.cuda.get_device_properties(
            device).multi_processor_count
        out = shape(cluster_size(nch, sm_count, max_active))
        sp.add(queries=len(asked), cluster=out.cl)
    return out


def _partials(nch: int, shape: LaunchShape, G: int, S: int, k: int, dev):
    """The chunk partials (csrc/span.cu::Rebuild.part), (nch, stride)."""
    return torch.empty((nch, part_stride(G, S, k, shape.plan_a,
                                         shape.plan_p)),
                       dtype=torch.float64, device=dev)


def build() -> tuple:
    """Compile csrc/span.cu (once per source hash) and load it. Returns
    (ctypes library, compiler report)."""
    lib, report = cuda_build.load("span")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    fn = lib.cogaps_span_launch
    fn.argtypes = ([i] * 16 + [ptr] + [ctypes.c_float] * 4 + [ptr] * 27
                   + [ll] + [ptr] * 16)
    fn.restype = i
    fn = lib.cogaps_span_rebuild
    fn.argtypes = [i] * 7 + [ptr] * 8 + [ll] + [ptr] * 9
    fn.restype = i
    fn = lib.cogaps_span_max_clusters
    fn.argtypes = [i] * 4 + [ptr]
    fn.restype = i
    lib.cogaps_span_static_smem.argtypes = [i]
    lib.cogaps_span_static_smem.restype = i
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
    with trace.span("run_span", iterations=n_it, chains=state.M_a.shape[0]):
        if state.M_a.device.type == "cpu":
            return run_span_plain(cfg, consts_a, consts_p, hist, phase,
                                  data, it0, n_it, state, stats, rand)
        if state.M_a.device.type != "cuda":
            raise ValueError(
                f"no fused span for tensors on {state.M_a.device}")
        if not isinstance(rand, engine.PhiloxRandom):
            raise TypeError(
                "the fused span draws from an engine.PhiloxRandom")
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
    with trace.span("span.prepare"):
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
        st_a = KernelState.make(state.atoms_a, state.M_a, consts_a,
                                data.mass_a, budget[0])
        st_p = KernelState.make(state.atoms_p, state.M_p, consts_p,
                                data.mass_p, budget[1])
        # the kernel adds to copies of what it changes: the sums only while
        # sampling
        sums = [x.clone() if phase == engine.SAMPLING else x
                for x in (stats.a_sum, stats.a_sumsq, stats.p_sum,
                          stats.p_sumsq)]
        counts = [x.clone() for x in (stats.n_stat, stats.upd,
                                      stats.prop_counts, stats.acc_counts,
                                      stats.sweep_counts)]
        scratch = [torch.empty(shape, dtype=f32, device=dev) for shape in (
            (NCH, G, K), (NCH, G, K), (NCH, G * K, K),   # Y, SQ, Z of A
            (NCH, S, K), (NCH, S, K), (NCH, S * K, K))]  # Y, SQ, Z of P
        colnz = torch.empty((2, NCH, K), dtype=i32, device=dev)
        threads = block_threads(consts_a.batch, consts_p.batch, K)
        shape = launch_shape(0, dev, NCH, G, S, K, threads,
                             caps=(consts_a.capacity, consts_p.capacity))
        part = _partials(NCH, shape, G, S, K, dev)
        ints = shape.plan_ints()
        plan = (ctypes.c_int * len(ints))(*ints)
        lib, _ = build()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = [x.data_ptr() for x in (
            data.mass_a.lam, data.mass_a.max_gibbs_mass, data.mass_p.lam,
            data.mass_p.max_gibbs_mass, data.D, data.invS2, data.D_t,
            data.invS2_t)]
    with torch.cuda.device(dev):
        for off in range(0, n_it, CHUNK):
            n = min(CHUNK, n_it - off)
            with trace.span("span.normals") as sp:
                drawn = rand.blocks_drawn
                z = rand.budget_normals(phase, it0 + off, n)
                sp.add(blocks=rand.blocks_drawn - drawn)
            with trace.span("span.launch"):
                err = lib.cogaps_span_launch(
                    NCH, G, S, K, n, phase, it0 + off, cfg.n_iterations,
                    consts_a.batch, consts_a.capacity, consts_p.batch,
                    consts_p.capacity, int(consts_a.local_moves), threads,
                    shape.cl, shape.smem, plan,
                    float(consts_a.alpha * consts_a.n_bins),
                    float(consts_a.domain_length),
                    float(consts_p.alpha * consts_p.n_bins),
                    float(consts_p.domain_length), *ptr, z.data_ptr(),
                    st_a.mass.data_ptr(), st_a.elem.data_ptr(),
                    st_a.n.data_ptr(), st_p.mass.data_ptr(),
                    st_p.elem.data_ptr(), st_p.n.data_ptr(),
                    st_a.M.data_ptr(), st_p.M.data_ptr(),
                    *(x.data_ptr() for x in sums),
                    *(x.data_ptr() for x in counts), part.data_ptr(),
                    part.shape[1], *(x.data_ptr() for x in scratch),
                    colnz[0].data_ptr(), colnz[1].data_ptr(),
                    budget[0].data_ptr(),
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
    builds them, by its rebuild alone (a cluster of CTAs of `threads`
    threads a chain). For tensors on the CPU, the plain version
    (ops/span.rebuild_tables_plain). col_nz comes back as bool, as the
    plain version gives it."""
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
    threads = block_threads(threads, 1, K)
    shape = launch_shape(1, dev, NCH, G, S, K, threads)
    part = _partials(NCH, shape, G, S, K, dev)
    lib, _ = build()
    ints = shape.plan_ints()
    with torch.cuda.device(dev):
        err = lib.cogaps_span_rebuild(
            NCH, G, S, K, threads, shape.cl, shape.smem,
            (ctypes.c_int * len(ints))(*ints), data.D.data_ptr(),
            data.invS2.data_ptr(), data.D_t.data_ptr(),
            data.invS2_t.data_ptr(), M_a.data_ptr(), M_p.data_ptr(),
            part.data_ptr(), part.shape[1],
            *(x.data_ptr() for x in out[:3]),
            colnz[0].data_ptr(), *(x.data_ptr() for x in out[3:]),
            colnz[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span rebuild launch failed: CUDA error {err}")
    rebuild_tables.launches += 1
    return SpanTables(*out[:3], colnz[0] != 0, *out[3:], colnz[1] != 0)


rebuild_tables.launches = 0


def rebuild_tables_split(data: engine.DeviceData, M_a: torch.Tensor,
                         M_p: torch.Tensor, cl: int,
                         threads: int = MAX_BATCH) -> SpanTables:
    """The plain model of the kernel's order of sums (rebuild_plan) on a
    cluster of `cl` CTAs: each chunk's float64 sums over its partners,
    the chunks added in chunk order, then rounded once. The chunks come
    from the shape alone, so `cl` and `threads` change nothing here."""
    K = M_a.shape[-1]
    threads = block_threads(threads, 1, K)

    def side(X, W, M, O):
        NR, m = X.shape[-2:]
        plan = rebuild_plan(NR, m, K, threads, cl)
        X, W, M, O = (x.double() for x in (X, W, M, O))
        OO = (O.unsqueeze(-1) * O.unsqueeze(-2)).flatten(-2)
        R = (X - M @ O.transpose(-1, -2)) * W
        sums = None
        for q in range(plan.nchunk):
            s = slice(q * plan.cj, min(m, (q + 1) * plan.cj))
            part = (R[..., s] @ O[..., s, :], W[..., s] @ (O * O)[..., s, :],
                    W[..., s] @ OO[..., s, :])
            sums = part if sums is None else tuple(
                a + b for a, b in zip(sums, part))
        Y, SQ, Z = sums
        return (Y.float(), SQ.float(),
                Z.float().reshape(*Z.shape[:-2], -1, K), O.amax(dim=-2) > 0.0)

    return SpanTables(*side(data.D, data.invS2, M_a, M_p),
                      *side(data.D_t, data.invS2_t, M_p, M_a))
