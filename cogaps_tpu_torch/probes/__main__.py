"""Run every probe function on the card: ``python -m cogaps_tpu_torch.probes``.

The H100 counterpart of running tools/probe_mosaic*.py and
tools/probe_dma*.py. Each case runs one function at one shape — the
probes' own shapes and the port's (F1 at K3's rebuild contraction, F9 at
K4's partner tables, F2-F4 at K1's lane count, F8 at one fast-mode
sweep's block of 16 chains) — and holds the kernel to its plain version:
exact, or within the function's stated tolerance. It first prints the
launch floor: the time of one launch of an empty kernel, timed as the
cases are, and back to back; and the dependent-load floor: one lane's
chain of 16 and of 80 dependent 4-byte loads over the 512 MiB table
(dma.dependent_loads), which gather_passes' 16 and 80 passes are set
against. Then a line per case: kernel ms (median of
20 launches after a warm-up, each between CUDA events recorded behind a
spin of the stream, so the host's enqueueing is not timed; the inputs
stay in L2 between launches, except the DMA probes' tables of 512 MiB)
and its ratio to the floor, plain ms and library ms (the same way,
median of 5 and 20), the bound (probes/__init__.bound_ms of the
function's counts) and its share of the kernel's time, the largest
|difference| from the plain version, and the plan F1 and F9's row gathers
ran by (mosaic.bdot_plan, dma.gather_plan). Then one JSON object per
case. It needs a CUDA device and exits non-zero without one;
chip_smoke.py runs run_suite as its phase 10.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
from typing import Callable, Optional

import numpy as np
import torch

from . import bound_ms, dma, mosaic

SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock ahead of each timed call
NB_DMA = 1 << 20  # tools/probe_dma.py's table: 2^20 rows of 128 (512 MiB)
K_DMA = 128

M1 = "tools/probe_mosaic.py"
M2 = "tools/probe_mosaic2.py"
M3 = "tools/probe_mosaic3.py"
M4 = "tools/probe_mosaic4.py"
M5 = "tools/probe_mosaic5.py"
D1 = "tools/probe_dma.py"
D2 = "tools/probe_dma2.py"
WRAPPERS_OF = {  # the wrappers that launch each function's kernel
    "F1": (mosaic.bdot,), "F2": (mosaic.prefix,),
    "F3": (mosaic.first_wins,), "F4": (mosaic.claim_min,),
    "F5": (mosaic.elem_chain,), "F6": (mosaic.while_sum,),
    "F7": (mosaic.reduce3d,), "F8": (mosaic.uniform,),
    "F9": (dma.gather_rows, dma.gather_block, dma.gather_passes,
           dma.gather_batched),
    "F10": (dma.scatter_slots,), "F11": (dma.strided_sum,),
}


@dataclasses.dataclass
class Case:
    f: str  # F1 .. F11
    shape: str
    sites: list
    make: Callable  # (device) -> the wrapper's arguments
    kernel: Callable
    plain: Callable
    counts: Callable
    # the wrapper's arguments -> one PyTorch call of the same function
    # (its integer index tensors made beforehand), to time
    library: Optional[Callable] = None
    tol: Optional[Callable] = None  # (args, kernel out, plain out) -> bool;
    #                                 None: equal
    headline: bool = False  # the function's row in chip_smoke's kernels line
    passes: Optional[int] = None  # gather_passes' R: set against the
    #                               dependent-load floor of R loads


def within_terms(terms_fn, rtol=1e-5):
    """|kernel - plain| <= rtol * (the plain version on |inputs|): a float32
    sum against a float64 one, bounded by the sum of the absolute terms."""
    def tol(args, k, p):
        terms = terms_fn(*(a.abs() for a in args))
        return bool(((k.double() - p.double()).abs()
                     <= rtol * terms.double()).all())
    return tol


def within_rel(rtol):
    def tol(args, k, p):
        return bool(((k.double() - p.double()).abs()
                     <= rtol * p.double().abs()).all())
    return tol


def _to(device, *arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in arrays)


def _random(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(
        np.float32)


def _mod113(nch, B):
    return np.arange(nch * B, dtype=np.float32).reshape(nch, B) % 113.0


def _probe_table(device, nb=NB_DMA, k=K_DMA):
    """tools/probe_dma.py's _table, made on the device."""
    g = torch.arange(nb, dtype=torch.float32, device=device)[:, None]
    c = torch.arange(k, dtype=torch.float32, device=device)[None, :]
    return g * 0.001 + c


def _probe2_table(device, nb=NB_DMA, k=K_DMA):
    """tools/probe_dma2.py's table: each row holds its row number."""
    g = torch.arange(nb, dtype=torch.float32, device=device)[:, None]
    return g.expand(nb, k).contiguous()


def _probe_idx(B, nb):
    """tools/probe_dma.py's _idx, for a table of nb rows."""
    return np.random.default_rng(0).integers(0, nb, size=(1, B)).astype(
        np.float32)[0]


def cases(tables) -> list:
    """Every case, the probes' shapes first, then the port's. `tables`
    holds the two 512 MiB tables of the DMA probes, made on the device."""
    m, d = mosaic, dma
    out = []

    def bdot(nch, T, K, B, sites, seed, headline=False):
        out.append(Case(
            "F1", f"({nch},{T},{K})x({nch},{T},{B})", sites,
            lambda dev: _to(dev, _random((nch, T, K), seed),
                            _random((nch, T, B), seed + 1)),
            m.bdot, m.bdot_plain, m.bdot_counts,
            lambda a, b: lambda: torch.bmm(a.transpose(1, 2), b),
            within_terms(m.bdot_plain), headline))

    bdot(8, 1363, 7, 256, [f"{M1}:51", f"{M1}:72", f"{M2}:33", f"{M3}:33",
                           f"{M3}:85", f"{M4}:35"], 1)
    bdot(8, 1363, 7, 512, [f"{M2}:33", f"{M3}:85", f"{M4}:35"], 3)
    bdot(8, 1363, 7, 1024, [f"{M2}:33"], 5)
    bdot(1, 1363, 7, 256, [f"{M1}:92", f"{M2}:33", f"{M3}:85", f"{M4}:35"],
         7)
    bdot(8, 1363, 9, 512, [f"{M2}:33", f"{M3}:85", f"{M4}:35"], 9)
    bdot(8, 128, 128, 512, [f"{M2}:33", f"{M3}:85", f"{M4}:35"], 11)
    bdot(8, 128, 128, 256, [f"{M4}:35"], 13)
    bdot(1, 128, 128, 256, [f"{M4}:35"], 15)
    bdot(8, 75, 128, 512, [f"{M3}:85"], 17)

    for nch, B in ((8, 512), (8, 1024)):
        out.append(Case(
            "F2", f"({nch},{B})", [f"{M2}:33"],
            lambda dev, nch=nch, B=B: _to(dev, _random((nch, B), 20 + B)),
            m.prefix, m.prefix_plain, m.prefix_counts,
            lambda x: lambda: torch.cumsum(x, 1),
            within_terms(m.prefix_plain)))

    for nch, B, sites in ((1, 1024, [f"{M1}:213"]),
                          (8, 512, [f"{M2}:33", f"{M3}:85", f"{M4}:35"]),
                          (8, 1024, [f"{M2}:33", f"{M3}:85", f"{M4}:35"])):
        out.append(Case(
            "F3", f"({nch},{B}) arange % 113", sites,
            lambda dev, nch=nch, B=B: _to(dev, _mod113(nch, B)),
            m.first_wins, m.first_wins_plain, m.first_wins_counts))
    out.append(Case(
        "F3", "(4,256) ints in [0,57)", [f"{M5}:27"],
        lambda dev: _to(dev, np.random.default_rng(0).integers(
            0, 57, (4, 256)).astype(np.float32)),
        m.first_wins, m.first_wins_plain, m.first_wins_counts))

    def claim(nch, B, form, sites, headline=False, values=None):
        values = values or (lambda: _mod113(nch, B))

        def library(r, n_rows, form):
            rows = r.long()
            lanes = torch.arange(r.shape[1], dtype=torch.int32,
                                 device=r.device).expand(r.shape).contiguous()
            return lambda: torch.full(
                (r.shape[0], n_rows), r.shape[1], dtype=torch.int32,
                device=r.device).scatter_reduce_(1, rows, lanes, "amin")

        out.append(Case(
            "F4", f"({nch},{B}) NR=1363 {form} form", sites,
            lambda dev: (*_to(dev, values()), 1363, form),
            m.claim_min, m.claim_min_plain, m.claim_min_counts,
            library if form == "row" else None, None, headline))

    claim(8, 512, "row", [f"{M2}:33"])
    claim(8, 512, "lane", [f"{M3}:85", f"{M4}:35"])
    claim(8, 256, "lane", [f"{M3}:85", f"{M4}:35"])
    claim(1, 256, "lane", [f"{M4}:35"])

    for shape, sites in (((1, 256), [f"{M1}:187", f"{M2}:33", f"{M3}:85",
                                     f"{M4}:35"]),
                         ((8, 256), [f"{M1}:187"]),
                         ((8, 512), [f"{M2}:33", f"{M3}:85", f"{M4}:35"]),
                         ((8, 1024), [f"{M1}:187", f"{M2}:33", f"{M3}:85",
                                      f"{M4}:35"])):
        out.append(Case(
            "F5", f"{shape} x 50", sites,
            lambda dev, shape=shape: _to(dev, np.ones(shape, np.float32)),
            m.elem_chain, m.elem_chain_plain, m.elem_chain_counts,
            headline=shape == (8, 1024)))

    out.append(Case(
        "F6", "(8,128) full 3.0, count form", [f"{M1}:116"],
        lambda dev: (*_to(dev, np.full((8, 128), 3.0, np.float32)), "count"),
        m.while_sum, m.while_sum_plain, m.while_sum_counts, headline=True))
    out.append(Case(
        "F6", "(1,128) ones, until form", [f"{M2}:197"],
        lambda dev: (*_to(dev, np.ones((1, 128), np.float32)), "until"),
        m.while_sum, m.while_sum_plain, m.while_sum_counts))

    out.append(Case(
        "F7", "(8,128,256) sum of squares over axis 1", [f"{M1}:131"],
        lambda dev: (*_to(dev, _random((8, 128, 256), 30, 4.0)), "sum"),
        m.reduce3d, m.reduce3d_plain, m.reduce3d_counts,
        lambda x, form: lambda: torch.linalg.vecdot(x, x, dim=1),
        within_rel(1e-6)))
    out.append(Case(
        "F7", "(8,128,256) min over axis 2", [f"{M1}:145"],
        lambda dev: (*_to(dev, _random((8, 128, 256), 31, 4.0)), "min"),
        m.reduce3d, m.reduce3d_plain, m.reduce3d_counts,
        lambda x, form: lambda: torch.amin(x, 2), headline=True))

    def uniform(rows, lanes, seed, sites, headline=False):
        def library(s, rows, lanes):
            gen = torch.Generator(s.device).manual_seed(seed)
            return lambda: torch.rand((rows, lanes), device=s.device,
                                      generator=gen)

        out.append(Case(
            "F8", f"({rows},{lanes}) seed {seed}", sites,
            lambda dev: (*_to(dev, np.int32([seed])), rows, lanes),
            m.uniform, m.uniform_plain, m.uniform_counts, library,
            headline=headline))

    uniform(8, 128, 42, [f"{M1}:163", f"{M2}:214"])
    uniform(8, 128, 43, [f"{M1}:163"])

    tbl, tbl2 = tables
    out.append(Case(
        "F9", "8 rows at offset 12345 of (2^20,128)", [f"{D1}:56"],
        lambda dev: (tbl, *_to(dev, np.int32([12345])), 8),
        d.gather_block, d.gather_block_plain, d.gather_block_counts,
        lambda t, off, n: _index_select(t, off.long() + torch.arange(
            n, device=t.device))))
    for B in (64, 256, 1024):
        out.append(Case(
            "F9", f"{B} rows of (2^20,128)", [f"{D1}:155"],
            lambda dev, B=B: (tbl, *_to(dev, _probe_idx(B, len(tbl)))),
            d.gather_rows, d.gather_rows_plain, d.gather_rows_counts,
            lambda t, i: _index_select(t, i.long())))
    for R in (16, 80):
        out.append(Case(
            "F9", f"256 rows of (2^20,128), {R} dependent passes",
            [f"{D2}:68"],
            lambda dev, R=R: (tbl2, *_to(dev, _probe_idx(256, len(tbl2))), R),
            d.gather_passes, d.gather_passes_plain, d.gather_passes_counts,
            passes=R))
    out.append(Case(
        "F9", "(4,1363,16) rows at (4,256) into (4,16,256)", [f"{M5}:27"],
        lambda dev: _to(dev, (np.random.default_rng(0).standard_normal(
            (4, 1363, 16)) * 100).astype(np.float32),
            np.random.default_rng(1).integers(0, 1363, (4, 256)).astype(
                np.float32)),
        d.gather_batched, d.gather_batched_plain, d.gather_batched_counts))
    out.append(Case(
        "F9", "flat (4,1024) at (4,256)", [f"{M5}:27"],
        lambda dev: _to(dev, _random((4, 1024, 1), 40, 11.0),
                        _slots(4, 256, 1024)),
        d.gather_batched, d.gather_batched_plain, d.gather_batched_counts))

    out.append(Case(
        "F10", "(4,256) into (4,1024)", [f"{M5}:27"],
        lambda dev: (*_to(dev, (np.random.default_rng(2).standard_normal(
            (4, 256)) * 37).astype(np.float32), _slots(4, 256, 1024)), 1024),
        d.scatter_slots, d.scatter_slots_plain, d.scatter_slots_counts,
        _scatter_library,
        headline=True))

    out.append(Case(
        "F11", "p2a: stride 7 of (1,256)", [f"{D1}:85"],
        lambda dev: (*_to(dev, np.arange(256, dtype=np.float32)[None]), 7,
                     1.0, 0.0),
        d.strided_sum, d.strided_sum_plain, d.strided_sum_counts))
    out.append(Case(
        "F11", "p2b: stride 31 of 2x+1, (1,256)", [f"{D1}:112"],
        lambda dev: (*_to(dev, np.arange(256, dtype=np.float32)[None]), 31,
                     2.0, 1.0),
        d.strided_sum, d.strided_sum_plain, d.strided_sum_counts,
        headline=True))

    # ---- the port's shapes
    port = "the port's shape"
    bdot(16, 1363, 7, 9, [port + ": K3's rebuild contraction, GIST x16"],
         50, headline=True)
    bdot(16, 20000, 10, 100, [port + ": 16 chains of 20000x100 k=10"], 52)
    out.append(Case(
        "F2", "(16,1024)", [port + ": K1's lane count"],
        lambda dev: _to(dev, _random((16, 1024), 54)),
        m.prefix, m.prefix_plain, m.prefix_counts,
        lambda x: lambda: torch.cumsum(x, 1), within_terms(m.prefix_plain),
        True))
    rows_1363 = lambda: np.random.default_rng(56).integers(  # noqa: E731
        0, 1363, (16, 1024)).astype(np.float32)
    out.append(Case(
        "F3", "(16,1024) rows in [0,1363)", [port + ": K1's lane count"],
        lambda dev: _to(dev, rows_1363()),
        m.first_wins, m.first_wins_plain, m.first_wins_counts,
        headline=True))
    claim(16, 1024, "row", [port + ": K1's row claims"], True, rows_1363)
    claim(16, 1024, "lane", [port + ": K1's lane count"], False, rows_1363)
    uniform(16, 16 * 1024, 7, [port + ": a fast-mode sweep, 16 chains"],
            True)
    for NB in (50000, 30000):
        out.append(Case(
            "F9", f"512 rows of ({NB},50)",
            [port + ": K4's partner factor"],
            lambda dev, NB=NB: _to(
                dev, np.random.default_rng(NB).gamma(2.0, 1.0, (NB, 50)
                                                     ).astype(np.float32),
                np.random.default_rng(NB + 1).integers(0, NB, 512).astype(
                    np.float32)),
            d.gather_rows, d.gather_rows_plain, d.gather_rows_counts,
            lambda t, i: _index_select(t, i.long()), headline=NB == 50000))
    # the partner rows one K4 sweep reads: 512 lanes x ~1000 nonzeros a
    # row (the atlas A side, 2% of 50000 columns)
    out.append(Case(
        "F9", "512000 rows of (50000,50)",
        [port + ": one K4 sweep's partner rows"],
        lambda dev: _to(
            dev, np.random.default_rng(60).gamma(2.0, 1.0, (50000, 50)
                                                 ).astype(np.float32),
            np.random.default_rng(61).integers(0, 50000, 512000).astype(
                np.float32)),
        d.gather_rows, d.gather_rows_plain, d.gather_rows_counts,
        lambda t, i: _index_select(t, i.long())))
    return out


def _slots(nch, B, C):
    """Slots unique in each chain (tools/probe_mosaic5.py's permutations)."""
    rng = np.random.default_rng(3)
    return np.stack([rng.permutation(C)[:B] for _ in range(nch)]).astype(
        np.float32)


def _index_select(t, rows):
    return lambda: torch.index_select(t, 0, rows)


def _scatter_library(val, slot, n_slots):
    slots = slot.long()
    return lambda: torch.zeros((val.shape[0], n_slots), device=val.device
                               ).scatter_(1, slots, val)


def device_ms(fn, reps):
    """Median ms over `reps` calls of fn after one warm-up call, each call
    between two CUDA events recorded behind a spin of the stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _outputs(x):
    return list(x) if isinstance(x, tuple) else [x]


def max_abs_diff(k, p):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(_outputs(k), _outputs(p)))


def agrees(case, args, k, p):
    ks, ps = _outputs(k), _outputs(p)
    if any(a.shape != b.shape or a.dtype != b.dtype for a, b in zip(ks, ps)):
        return False
    if case.tol is None:
        return all(torch.equal(a, b) for a, b in zip(ks, ps))
    return all(case.tol(args, a, b) for a, b in zip(ks, ps))


def plan_of(case, args) -> Optional[str]:
    """The plan F1 and F9's flat gathers run these arguments by."""
    n_sm = mosaic.sm_count(args[0].device.index or 0)
    if case.kernel is mosaic.bdot:
        (NCH, T, K), B = args[0].shape, args[1].shape[-1]
        p = mosaic.bdot_plan(NCH, T, K, B, n_sm)
        return (f"{p.regime}, tiles {p.tile_k}x{p.tile_b}, {p.splits} "
                f"split(s), grid {p.grid}")
    if case.kernel in (dma.gather_rows, dma.gather_block):
        B = args[1].shape[0] if case.kernel is dma.gather_rows else args[2]
        p = dma.gather_plan(B, args[0].shape[1], n_sm)
        return f"{p.tiles} tiles, grid {p.grid}"
    return None


def run_case(case, device, reps=20):
    args = case.make(device)
    before = case.kernel.launches
    out_k = case.kernel(*args)
    out_p = case.plain(*args)
    torch.cuda.synchronize()
    ok = agrees(case, args, out_k, out_p)
    err = max_abs_diff(out_k, out_p)
    ms = device_ms(lambda: case.kernel(*args), reps)
    plain_ms = device_ms(lambda: case.plain(*args), 5)
    library_ms = None
    if case.library is not None:
        library_ms = device_ms(case.library(*args), reps)
    n_bytes, n_ops = case.counts(*args)
    bound, by = bound_ms(n_bytes, n_ops)
    return {"f": case.f, "name": case.kernel.__name__, "shape": case.shape,
            "sites": case.sites, "ok": ok, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "share": bound / ms,
            "bytes": n_bytes, "ops": n_ops,
            "launches": case.kernel.launches - before,
            "headline": case.headline, "plan": plan_of(case, args)}


def launch_floor(device, reps=20, burst=200) -> dict:
    """The time of one launch of probe_mosaic.cu's empty kernel: "ms" as
    every case's kernel is timed (device_ms: the median of `reps` launches,
    each alone between two events), and "back_to_back_ms", the events
    around `burst` launches in a row over `burst`, enqueued while a spin
    long enough for all of them holds the stream (the device's pace, not
    the host's)."""
    ms = device_ms(lambda: mosaic.empty(device), reps)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(burst * SPIN_CYCLES // 20)  # ~50 us of spin a launch
    start.record()
    for _ in range(burst):
        mosaic.empty(device)
    stop.record()
    stop.synchronize()
    return {"ms": ms, "back_to_back_ms": start.elapsed_time(stop) / burst}


def dependent_floor(device, tbl, n_loads, reps=20) -> dict:
    """One lane's chain of n_loads dependent 4-byte loads over the 512 MiB
    table `tbl` (dma.dependent_loads, gather_passes' index rule), timed as
    every case's kernel is: the least a chain of n_loads dependent passes
    can take. Raises AssertionError if the kernel and its plain version
    disagree."""
    (idx,) = _to(device, _probe_idx(1, len(tbl)))
    got = dma.dependent_loads(tbl, idx, n_loads)
    want = dma.dependent_loads_plain(tbl, idx, n_loads)
    if not torch.equal(got, want):
        raise AssertionError(f"dependent_loads({n_loads}) disagrees with its"
                             f" plain version: {got} against {want}")
    return {"ms": device_ms(lambda: dma.dependent_loads(tbl, idx, n_loads),
                            reps), "loads": n_loads}


def run_suite(device, log=print, reps=20) -> list:
    """The launch floor and the dependent-load floor, then every case on
    `device` (a CUDA device); a line each through `log`, a case's time
    also over the floor's ("over_floor"; gather_passes' over the
    dependent-load floor of as many loads, "dependent_floor_ms"). Raises AssertionError, after the last case, if any
    kernel disagreed with its plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    records = []
    floor = launch_floor(device, reps)
    log(f"  empty kernel (the launch floor): {floor['ms']:.4f} ms a launch "
        f"alone between events, {floor['back_to_back_ms']:.4f} ms a launch "
        f"back to back")
    tables = (_probe_table(device), _probe2_table(device))
    chains = {n: dependent_floor(device, tables[1], n, reps)
              for n in (16, 80)}
    log("  dependent-load floor (one lane's chain of 4-byte loads over the "
        "512 MiB table): " + ", ".join(
            f"{n} loads {c['ms']:.4f} ms ({c['ms'] / n * 1e3:.3f} us a load)"
            for n, c in chains.items()))
    for case in cases(tables):
        r = run_case(case, device, reps)
        r["floor_ms"] = floor["ms"]
        r["over_floor"] = r["ms"] / floor["ms"]
        if case.passes:
            r["dependent_floor_ms"] = chains[case.passes]["ms"]
            r["over_floor"] = r["ms"] / r["dependent_floor_ms"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {r['f']} {r['name']} {r['shape']} [{', '.join(r['sites'])}]:"
            f" kernel {r['ms']:.4f} ms ({r['over_floor']:.2f}x the "
            f"{'dependent-load ' if case.passes else ''}floor), "
            f"plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}),"
            f" bound/kernel {r['share']:.4f}, max|diff| {r['max_abs_err']:.3g}"
            + (f"; plan: {r['plan']}" if r["plan"] else "")
            + ("" if r["ok"] else "  MISMATCH"))
        records.append(r)
    bad = [(r["f"], r["shape"]) for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"probe kernels disagree with their plain "
                             f"versions: {bad}")
    return records


def kernel_entries(records, launches) -> list:
    """One entry a function for chip_smoke.py's kernels line: the numbers
    of its headline case (the port's shape where it has one), the TPU
    sites of all its cases, the largest |difference| over them, and
    `launches` ({F: count})."""
    entries = []
    for f, wrappers in WRAPPERS_OF.items():
        recs = [r for r in records if r["f"] == f]
        head = next(r for r in recs if r["headline"])
        module = wrappers[0].__module__.rsplit(".", 1)[1]  # mosaic, dma
        entries.append({
            "name": f"probe_{wrappers[0].__name__}", "route": "cuda",
            "source": f"cogaps_tpu_torch/csrc/probe_{module}.cu",
            "replaces": sorted({s for r in recs for s in r["sites"]
                                if s.startswith("tools/")}),
            "launches": launches[f],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"]})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    records = run_suite(device, log=lambda s: print(s, flush=True))
    for r in records:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
