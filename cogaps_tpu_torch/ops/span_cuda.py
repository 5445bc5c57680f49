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

Both kernels run one thread-block cluster per chain (``cluster_size``),
and each sampler's table rebuild is split over the cluster's CTAs as
``rebuild_plan`` says; ``rebuild_tables_split`` is the plain model of that
split. The kernel is built from csrc/span.cu (with csrc/sweep_common.cuh
and csrc/dense_model.cuh) by ops/cuda_build.py at first use.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import engine
from . import cuda_build
from .span import SpanTables, rebuild_tables_plain, run_span_plain
from .sweep_cuda import MAX_BATCH, KernelState

CHUNK = 50
# cluster sizes tried, largest first: powers of two up to the portable 8
CLUSTER_SIZES = (8, 4, 2, 1)
MAX_TILE_ROWS = 128  # rows a rebuild pass stages
MAX_TILE_J = 256     # partners a rebuild pass stages
TILE_BYTES = 160 * 1024  # shared memory of one sampler's staged tiles
SYNC_STEPS = 8  # a tile pass's barriers and staging, in partner steps


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
    columns and the k(k+1)/2 pairs c <= c' of Z (csrc/span.cu::Cols)."""
    return -(-k // 4), -(-(k * (k + 1) // 2) // 4)


def block_threads(B_a: int, B_p: int, k: int) -> int:
    """Threads of each CTA: the wider sampler's proposal lanes, and at
    least one thread per output column group, in whole warps."""
    t = 32 * -(-max(B_a, B_p, sum(column_groups(k))) // 32)
    if t > MAX_BATCH:
        raise ValueError(f"k={k} has more table column groups than "
                         f"{MAX_BATCH} threads")
    return t


class SidePlan(NamedTuple):
    """One sampler's rebuild split over a cluster (csrc/span.cu::SidePlan).
    Rank q of the cluster takes rows (split_rows) or partners
    [q * per_rank, (q + 1) * per_rank); it stages tile_rows x tile_j
    tiles, and `lanes` threads split one output's partner sum."""

    split_rows: bool
    per_rank: int
    tile_rows: int
    tile_j: int
    lanes: int


def rebuild_plan(NR: int, m: int, k: int, threads: int, cl: int) -> SidePlan:
    """The split of one sampler's rebuild (NR table rows, m partners) over
    a cluster of `cl` CTAs of `threads` threads. The longer of rows and
    partners is split over the CTAs (rows when cl is 1). Lanes (threads
    splitting one output's partner sum) are used only where a CTA's rows
    are too few to give each thread a column group of a row: elsewhere
    each sum runs over the partners in order, as the plain version's
    product does (a split sum rounded 2 of 32 M float32 entries the
    other way at 20000 x 100, k=10, x16 on an H100). Partners go in one
    tile, staged once, or in balanced tiles of at most MAX_TILE_J, rows
    in balanced tiles: whichever, with the lanes, takes the fewest serial
    partner steps, counting a tile pass as SYNC_STEPS more."""
    gy, gz = column_groups(k)
    ng, npad = gy + gz, 4 * (gy + gz)
    split_rows = cl == 1 or NR >= m
    per_rank = -(-(NR if split_rows else m) // cl)
    rows, parts = (per_rank, m) if split_rows else (NR, per_rank)
    words = TILE_BYTES // 8  # doubles of the staged tiles
    cap = min(MAX_TILE_ROWS, 2 * (threads // ng))

    def fit_rows(tile_j):  # rows whose R, W, M, out tiles fit by tile_j
        left = words - tile_j * (npad + 2)
        return max(left // (2 * (tile_j + 1) + k + npad) // 2 * 2, 0)

    j_cap, tr = 0, min(cap, rows + rows % 2)
    while j_cap < 1 and tr >= 2:  # partners beside tr rows, fewer if need be
        j_cap = min(MAX_TILE_J, (words - tr * (2 + k + npad))
                    // (npad + 2 + 2 * tr))
        tr = tr // 4 * 2
    if j_cap < 1:
        raise ValueError(f"k={k}: a partner tile does not fit {TILE_BYTES} "
                         "bytes")
    tile_js = {-(-parts // -(-parts // j_cap))}
    if parts <= MAX_TILE_J and fit_rows(parts) >= 2:
        tile_js.add(parts)
    best = None
    for tile_j in sorted(tile_js):
        for lanes in ((1, 2, 4, 8, 16, 32) if rows * ng < threads else (1,)):
            tr = min(cap, fit_rows(tile_j), 2 * (threads // (ng * lanes)))
            if tr < 2 or (lanes > 1 and lanes > tile_j):
                break
            n_tiles = -(-rows // tr)
            tile_rows = 2 * -(-(-(-rows // n_tiles)) // 2)
            steps = n_tiles * -(-parts // tile_j) * (-(-tile_j // lanes)
                                                     + SYNC_STEPS)
            if best is None or steps < best[0]:
                best = (steps, tile_rows, tile_j, lanes)
    return SidePlan(split_rows, per_rank, *best[1:])


def smem_bytes(plans, k: int) -> int:
    """Dynamic shared memory of a CTA (csrc/span.cu::carve): the pair
    table, col_nz flags and column norms, then the larger side's tiles:
    partners (tile_j, npad + 2), R and W (tile_rows, tile_j + 1), factor
    rows (tile_rows, k) and sums (tile_rows, npad), in doubles."""
    npad = 4 * sum(column_groups(k))
    fixed = (4 * (k * (k + 1) // 2 + 2 * k) + 15) // 16 * 16
    return fixed + max(8 * (p.tile_j * (npad + 2)
                            + p.tile_rows * (2 * (p.tile_j + 1) + k + npad))
                       for p in plans)


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

    def plan_ints(self) -> list:
        return [int(x) for x in (*self.plan_a, *self.plan_p)]


def launch_shape(kernel: int, device, nch: int, G: int, S: int, k: int,
                 threads: int) -> LaunchShape:
    """The cluster size, both sides' plans and the shared memory of a
    launch of span_kernel (kernel 0) or rebuild_kernel (1) on `device`."""
    lib, _ = build()

    def shape(cl):
        plans = (rebuild_plan(G, S, k, threads, cl),
                 rebuild_plan(S, G, k, threads, cl))
        return LaunchShape(cl, *plans, smem_bytes(plans, k))

    def max_active(cl):
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.cogaps_span_max_clusters(kernel, cl, threads,
                                               shape(cl).smem,
                                               ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"span cluster occupancy query: CUDA error "
                               f"{err}")
        return n.value

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return shape(cluster_size(nch, sm_count, max_active))


def _partials(nch: int, shape: LaunchShape, G: int, S: int, k: int, dev):
    """The partner-split sides' float64 partials (csrc/span.cu::Rebuild)."""
    return torch.empty((nch, shape.cl, min(G, S), 4 * sum(column_groups(k))),
                       dtype=torch.float64, device=dev)


def build() -> tuple:
    """Compile csrc/span.cu (once per source hash) and load it. Returns
    (ctypes library, compiler report)."""
    lib, report = cuda_build.load("span")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.cogaps_span_launch
    fn.argtypes = [i] * 16 + [ptr] + [ctypes.c_float] * 4 + [ptr] * 43
    fn.restype = i
    fn = lib.cogaps_span_rebuild
    fn.argtypes = [i] * 7 + [ptr] * 17
    fn.restype = i
    fn = lib.cogaps_span_max_clusters
    fn.argtypes = [i] * 4 + [ptr]
    fn.restype = i
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
        (NCH, S, K), (NCH, S, K), (NCH, S * K, K))]  # Y, SQ, Z of P
    colnz = torch.empty((2, NCH, K), dtype=i32, device=dev)
    threads = block_threads(consts_a.batch, consts_p.batch, K)
    shape = launch_shape(0, dev, NCH, G, S, K, threads)
    part = _partials(NCH, shape, G, S, K, dev)
    plan = (ctypes.c_int * 10)(*shape.plan_ints())
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
                consts_p.capacity, int(consts_a.local_moves), threads,
                shape.cl, shape.smem, plan,
                float(consts_a.alpha * consts_a.n_bins),
                float(consts_a.domain_length),
                float(consts_p.alpha * consts_p.n_bins),
                float(consts_p.domain_length), *ptr, z.data_ptr(),
                st_a.mass.data_ptr(), st_a.elem.data_ptr(),
                st_a.n.data_ptr(), st_p.mass.data_ptr(),
                st_p.elem.data_ptr(), st_p.n.data_ptr(), st_a.M.data_ptr(),
                st_p.M.data_ptr(), *(x.data_ptr() for x in sums),
                *(x.data_ptr() for x in counts), part.data_ptr(),
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
    with torch.cuda.device(dev):
        err = lib.cogaps_span_rebuild(
            NCH, G, S, K, threads, shape.cl, shape.smem,
            (ctypes.c_int * 10)(*shape.plan_ints()), data.D.data_ptr(),
            data.invS2.data_ptr(), data.D_t.data_ptr(),
            data.invS2_t.data_ptr(), M_a.data_ptr(), M_p.data_ptr(),
            part.data_ptr(), *(x.data_ptr() for x in out[:3]),
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
    """The plain model of the kernel's split (rebuild_plan) over a cluster
    of `cl` CTAs: each rank's float64 sums over its rows or partners; a
    partner split's partials added in rank order, then rounded once."""
    K = M_a.shape[-1]
    threads = block_threads(threads, 1, K)

    def side(X, W, M, O):
        NR, m = X.shape[-2:]
        plan = rebuild_plan(NR, m, K, threads, cl)
        X, W, M, O = (x.double() for x in (X, W, M, O))
        OO = (O.unsqueeze(-1) * O.unsqueeze(-2)).flatten(-2)
        n = NR if plan.split_rows else m
        sums = []
        for q in range(cl):
            s = slice(q * plan.per_rank, min(n, (q + 1) * plan.per_rank))
            if plan.split_rows:
                x, w, mm, o, oo = (X[..., s, :], W[..., s, :], M[..., s, :],
                                   O, OO)
            else:
                x, w, mm, o, oo = (X[..., s], W[..., s], M, O[..., s, :],
                                   OO[..., s, :])
            r = (x - mm @ o.transpose(-1, -2)) * w
            sums.append((r @ o, w @ (o * o), w @ oo))
        if plan.split_rows:
            Y, SQ, Z = (torch.cat(t, dim=-2) for t in zip(*sums))
        else:
            Y, SQ, Z = sums[0]
            for y, sq, z in sums[1:]:
                Y, SQ, Z = Y + y, SQ + sq, Z + z
        return (Y.float(), SQ.float(),
                Z.float().reshape(*Z.shape[:-2], -1, K), O.amax(dim=-2) > 0.0)

    return SpanTables(*side(data.D, data.invS2, M_a, M_p),
                      *side(data.D_t, data.invS2_t, M_p, M_a))
