"""The dense model's per-call tables in one hand-written kernel
(csrc/tables.cu) and its wrapper.

``dense_tables(D, invS2, M, other)`` builds one update call's tables of
the sampler of M for every chain of the call: Y, SQ, Z (in the (R k, k)
layout K1 reads) and col_nz, what models/dense.tables_plain forms with
batched cuBLAS products, and in float32 as they do. It is the port's
counterpart of the XLA dots of cogaps_tpu/models/dense.py:108-150, which
have no Pallas kernel; on the fused route K3 builds the same tables in
float64 (csrc/span.cu::rebuild_kernel). models/dense.tables dispatches
here for float32 CUDA tensors and to the plain version for CPU tensors.

Five kernels, as ``tables_plan`` says, from (R, m, k) and the SM count:
mma_kernel<k> (k <= 12, m >= MMA_MIN_M, R >= MMA_MIN_R) forms (X W) O
and Z = W Q on the tensor cores in TF32 with the 3xTF32 split, and Y =
(X W) O - M Z, four warps a block: 64 rows on wgmma where R > 32 (the
tensor-core form, "mma"), and for fewer rows 16 or 32 of them on
mma.sync with the contraction split over the warps (the short-row form,
"short"); above k = 12 the same forms run as mma_tiles_kernel<NCT, NS>
(the short-row form up to TILE_MAX_K), [O | Q]'s columns cut into
column tiles (``TablesPlan.column_tiles``) of 64, or in the tensor-core
form 128 above TILE_WIDE_K, a block's, the tiles holding Y's columns
(the first ceil(ceil(k/8) / NCT)) staging X as well and the last tile of
a row tile forming Y, on a ring of ``stages`` stages; rows_kernel<k> (k
<= 12 below those), a thread a row with all its accumulators in
registers; simt_tiles_kernel (12 < k <= SIMT_MAX_K where m <
MMA_MIN_M, at any R: bulk data of few samples), on the CUDA cores with
the same bits as quads_kernel, each thread 8 rows x 8 columns of [O |
Q] in registers over every partner, the residual once a (row, partner),
a block's sums written in address order by ``simt_table``'s lists, whole
rows of Z where they fit a block and bands of Z's rows (``simt_bands``)
above; quads_kernel<PQ> (k > 12 below those: R = 1 from MMA_MIN_M
partners, the short-row form above TILE_MAX_K, past the k whose column
tile fits a block, ~614, and below MMA_MIN_M partners past SIMT_MAX_K),
each thread PQ quads of a row's accumulators, G threads a row.
quads_kernel computes every k on the CUDA cores: it took 2.76 ms at 4 x
5000 x 2000 A k=20 and 39 ms at k=50, where cuBLAS's tables took 1.52
and 4.90, and the column tiles ~0.72 and ~3.95 (NVIDIA H100 80GB HBM3,
700 W; kernel_times.py --tables); their bound there is the tensor
cores' (``tables_tc_counts``): 0.112 and 0.642 ms. ``cuda_core_plan``
is rows_kernel's or quads_kernel's plan at any shape, which
``dense_tables(..., plan=...)`` runs in place of tables_plan's.
``tables_tf32`` is the plain
emulation of mma_kernel's arithmetic (the TF32 halves by cvt.rna's
rounding, the three products a partner and the float32 sums in the
kernel's order), for the CPU tests; ``tables_plain`` stays the plain
version. Every float32 entry of a chain is summed in an order that
``tables_plan`` fixes from (R, m, k) and the card's SM count alone,
never from the number of chains in the call or a chain's index: a
chain's tables are the same bits alone and beside any number of other
chains, which batched cuBLAS products do not give (cuBLAS picks its
kernel by the batch count). A contraction split into chunks is added in
split order by the last block to finish; there are no float atomics.
``tables_counts`` gives the bytes and float32 operations the float32
bound counts, ``tables_tc_counts`` the same bytes and the 3xTF32
products the tensor-core bound counts. The kernel is built from
csrc/tables.cu by ops/cuda_build.py at first use.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import cuda_build

THREADS = 128  # csrc/tables.cu's kThreads
# quads_kernel's PQ; it takes k > 12 only at MMA_MIN_R - 1 rows from
# MMA_MIN_M partners, in the short-row form above TILE_MAX_K, past the k
# whose column tile fits a block and below MMA_MIN_M partners past
# SIMT_MAX_K (simt_tiles_kernel takes GIST A, 1363 x 9, and 20000 x 40)
QUADS = (1, 2, 3, 4, 6, 8, 9, 11, 15, 17, 20)
ROWS_MAX_K = 12  # rows_kernel's and mma_kernel's K: 1 .. 12
# mma_kernel from 64 partners and 2 rows: below, 3xTF32's products (up to
# 2^-21 of each, two bits short of float32) are not averaged down against
# the accuracy gate (chip_smoke phase 3: at most twice cuBLAS's worst
# error), which mma_kernel met only at 1.2-1.5x at 16-25 partners; at
# one row of 4000 partners it reached 2.05x (3.65e-7 against 1.78e-7,
# rows_kernel 2.0x on those inputs), and one row is rows_kernel's as
# before (NVIDIA H100 80GB HBM3, 700 W). Below MMA_MIN_M partners: up to
# k = 12 rows_kernel, above simt_tiles_kernel to SIMT_MAX_K
MMA_MIN_M, MMA_MIN_R = 64, 2
MMA_WARPS = THREADS // 32  # csrc/tables.cu's kMmaWarps
STAGES = 3  # csrc/tables.cu's kStages: mma_kernel's ring
CORE = 36  # csrc/tables.cu's kCM: floats a core matrix of [O | Q] takes
# mma_kernel's shortest chunk: 12 R partners (fewer rows, shorter chunks:
# a block's partners run in sequence, and a split's partials are 16 RW
# rows wide) up to MMA_CHUNK partners (a split's partials, NT8 floats a
# row, against 8 bytes a partner of X and W): 512 took 0.045 ms at the
# 2500 x 2000 block and 0.176 at 4 x 5000 x 2000 A where 1024 took 0.065
# and 0.185, and 768 0.052 and 0.173 (NVIDIA H100 80GB HBM3, 700 W;
# kernel_times.py --tables --plan MMA_CHUNK=...)
MMA_CHUNK_ROWS, MMA_CHUNK = 12, 512
# mma_kernel's form above k = 12 (csrc/tables.cu's mma_tiles_kernel): [O |
# Q]'s columns in tiles of TILE_NT n-tiles of 8, each a block's, or twice
# that above TILE_WIDE_K in the tensor-core form. 64 columns keep a
# thread's sums and a group's products (32 registers each) and both A
# fragments under the 170 registers of three blocks an SM; 128 columns
# take two blocks an SM and stage W and split its fragments half as
# often a column: 64 are faster at k=20, 128 at k=50 (PERF.md §6;
# kernel_times.py --tables --plan TILE_WIDE_K=12 and =64, every tile of
# 128 and of 64); TILE_WIDE_K lies between. The tensor-core form takes
# every k above 12 (Y's ceil(k / 8) n-tiles over as many tiles as they
# fill); the short-row form (R <= 32) stops at TILE_MAX_K = 64, since a
# legal run has k < R there, and quads_kernel takes what a direct call
# asks beyond.
TILE_NT, TILE_WIDE_K, TILE_MAX_K = 8, 28, 64
MAX_G = 32  # threads sharing a row
SMEM_TARGET = 56 * 1024  # shared memory a block aims under: four an SM
SMEM_MAX = 232_448  # an H100 block's most (227 KB)
# a block's most with two an SM: the SM's 228 KB less 1 KB a block,
# halved. The column tiles' ring of STAGES stages grows with k by its O
# rows (3 x 32 x 4k bytes) and passes this above k = 74; there it keeps
# two stages, which fit two blocks an SM up to k = 172 (NVIDIA H100 80GB
# HBM3: 228 KB of shared memory an SM)
SMEM_TWO = (233_472 - 2 * 1024) // 2
MAX_L = 128  # partners a sub-tile stages
# rows_kernel's and quads_kernel's shortest chunk: 4 R partners, from 64
# to 256 (a block's sums run in sequence; fewer rows, shorter chunks, more
# splits to add at the end: the best of 64, 128 and 256 at R = 9, 32, 64
# and 100 on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke's
# tables_inputs)
MIN_CHUNK = (64, 256)
FILL = 2  # blocks an SM that one chain's call aims at
REG_BASE = 48  # registers a thread holds besides its accumulators
# csrc/tables.cu's form of each plan form
FORMS = {"rows": 0, "quads": 1, "mma": 2, "short": 2, "simt": 3}
# simt_tiles_kernel (k > 12 below MMA_MIN_M partners, up to SIMT_MAX_K):
# a thread's 8 columns (a segment) for SIMT_TR rows, 64 float
# accumulators; a block's shared memory under SIMT_SMEM, three blocks an
# SM (its 228 KB less 1 KB a block): whole rows of Z (k x k) where they
# fit (to k = 41 at 63 partners, 8 rows), else bands of Z's rows
SIMT_TR, SIMT_MAX_K = 8, 128
SIMT_SMEM = (233_472 - 3 * 1024) // 3


class TablesPlan(NamedTuple):
    """How one sampler's tables are built, per chain: blocks of THREADS
    threads. form "mma" or "short": mma_kernel, warps of RW row warps
    (RT = 16 RW rows) and KW = MMA_WARPS / RW partner warps ("short" where
    KW > 1), stages of L partners (_mma_stage), a ring of `stages` of
    them, in column tiles of 8 NCT above k = 12. form "rows": rows_kernel, a
    thread a row (G 1, RT = THREADS) and its k + k(k+1)/2 float
    accumulators. form "quads": quads_kernel, G threads a row (RT =
    THREADS / G), each keeping PQ quads (float4 accumulators) of its row's
    nq = qy + qz (Y's k columns, then Z's k(k+1)/2 pairs c <= c', four a
    quad), a block TQ of them, in acc_tiles tiles, with M's rows staged
    smq quads apart. form "simt": simt_tiles_kernel, RT = SIMT_TR RG
    rows a block in RG row groups of G threads, each thread SIMT_TR rows
    of 8 columns (a segment) at a time, PQ segments at most; acc_tiles
    bands of Z's rows (``bands``), at most smq rows each, whose tables
    (simt_table) are TQ ints each; every partner at once (L = CH = m, S =
    1). The contraction of m partners runs in S chunks of CH (the last
    shorter), staged L at a time; smem bytes of dynamic shared memory."""
    R: int
    m: int
    k: int
    qy: int
    nq: int
    G: int
    PQ: int
    RT: int
    TQ: int
    acc_tiles: int
    row_tiles: int
    L: int
    CH: int
    S: int
    smq: int
    smem: int
    form: str = "rows"
    RW: int = 0
    NCT: int = 0
    stages: int = STAGES

    @property
    def KW(self) -> int:
        """mma_kernel's warps sharing a row tile's partners."""
        return MMA_WARPS // self.RW if self.RW else 0

    @property
    def NT8(self) -> int:
        """mma_kernel's columns: Y's and Z's n-tiles of 8."""
        kp = self.k * (self.k + 1) // 2
        return 8 * (-(-self.k // 8) + -(-kp // 8))

    @property
    def NC(self) -> int:
        """mma_kernel's columns a block: all NT8, or a column tile's."""
        return 8 * self.NCT if self.NCT else self.NT8

    def bands(self) -> tuple:
        """simt_tiles_kernel's bands [c0, c1) of Z's rows, in the order
        of the grid's accumulator tiles (Y's columns in the first)."""
        return simt_bands(self.k, self.G, self.smq)

    def column_tiles(self) -> list:
        """mma_kernel's column tiles [n0, n1) of the NT8 columns, in the
        order of the grid's accumulator tiles (one where k <= 12)."""
        return [(t * self.NC, min((t + 1) * self.NC, self.NT8))
                for t in range(self.acc_tiles)]

    @property
    def blocks(self) -> int:
        """Blocks a chain."""
        return self.row_tiles * self.acc_tiles * self.S

    @property
    def accumulators(self) -> int:
        """float32 accumulators a thread keeps: its partials a split."""
        if self.form in ("mma", "short"):
            return self.NC // 2  # a warp's 16 rows x NC over 32 lanes
        if self.form == "simt":
            return 8 * SIMT_TR  # a segment's
        if self.PQ == 0:
            return self.k + self.k * (self.k + 1) // 2
        return 4 * self.PQ

    @property
    def partial(self) -> int:
        """float32 partials a block writes a split (S > 1)."""
        if self.form in ("mma", "short"):
            return self.RT * self.NC
        return self.accumulators * THREADS

    @property
    def registers(self) -> int:
        """Registers a thread needs: its accumulators, in rows_kernel and
        mma_kernel M's rows and the partner's (or its A fragments) too,
        or with column tiles a group's products and both fragments, and the
        rest."""
        if self.NCT:
            return 2 * self.accumulators + 32 + REG_BASE
        if self.form == "simt":  # and a partner's 8 products and 8 rows
            return self.accumulators + 16 + REG_BASE
        if self.form in ("mma", "short"):
            return self.accumulators + 2 * self.k + 32 + REG_BASE
        extra = 2 * self.k if self.PQ == 0 else 0
        return self.accumulators + extra + REG_BASE

    def splits(self) -> list:
        """The contraction's chunks [lo, hi), in the order they are added."""
        return [(s * self.CH, min((s + 1) * self.CH, self.m))
                for s in range(self.S)]


def _smem(RT, L, TQ, qy, smq, k) -> tuple:
    """(bytes that scale with L, all bytes) of csrc/tables.cu's layout.
    Both kernels stage O's rows (two buffers of quads) and X and W (two
    buffers each, rows L + 4 apart); quads_kernel (TQ > 0) adds its
    columns and M's rows in quads, then the column codes; rows_kernel
    (TQ 0) reuses the space to stage its rows' Z and Y for the writes.
    Then the flags and one int."""
    stage = 16 * 2 * L * qy + 4 * 4 * RT * (L + 4)
    ints = 4 * (2 * k + 1)
    if TQ == 0:
        return stage, max(stage, 4 * RT * (k * k + k + 1)) + ints
    stage += 16 * L * TQ
    return stage, stage + 16 * RT * smq + 4 * 4 * TQ + ints


def _mma_stage(RW: int) -> int:
    """mma_kernel's partners a stage: 16 a partner warp, two groups of 16
    a warp where the warps split the rows (RW = MMA_WARPS)."""
    KW = MMA_WARPS // RW
    return 16 * KW * (2 if KW == 1 else 1)


def _mma_floats(k: int, RW: int) -> int:
    """mma_kernel's shared memory in floats (csrc/tables.cu's
    mma_layout): STAGES slots of X and W (RT rows of L) and of O's rows
    (L x k), the stage's [O | Q] in TF32 halves (2 x NT8 / 8 n-blocks x
    L / 4 core matrices, CORE floats apart); after the loop the block's
    partials (KW RT rows, NT8 + 1 apart) and M's rows in the same space;
    the flags, one int, the ring's mbarriers. Three blocks an SM at k=10
    (its 228 KB, less 1 KB a block): a larger ring or layout took
    4 x 5000 x 2000 A from 0.176 to 0.20 ms (NVIDIA H100 80GB HBM3, 700
    W; kernel_times.py --tables)."""
    kp = k * (k + 1) // 2
    nt8 = 8 * (-(-k // 8) + -(-kp // 8))
    KW = MMA_WARPS // RW
    RT, L = 16 * RW, _mma_stage(RW)
    staging = (2 * STAGES * RT * L + STAGES * L * k
               + 2 * (nt8 // 8) * (L // 4) * CORE)
    flags = max(staging, KW * RT * (nt8 + 1) + RT * k)  # and M's rows
    return (flags + 2 * k + 2) // 2 * 2 + 2 * STAGES  # and the mbarriers


def _tile_floats(k: int, RW: int, nct: int, stages: int = STAGES) -> int:
    """mma_tiles_kernel's shared memory in floats (csrc/tables.cu's
    tile_layout): _mma_floats' ring at `stages` stages, one column tile's
    [O | Q] (2 x nct n-blocks x L / 4 core matrices) and its 8 nct column
    codes; after the loop the block's partials (KW RT rows, 8 nct + 1
    apart) in the same space; the flags, two ints, the mbarriers."""
    KW = MMA_WARPS // RW
    RT, L = 16 * RW, _mma_stage(RW)
    staging = (2 * stages * RT * L + stages * L * k
               + 2 * nct * (L // 4) * CORE + 8 * nct)
    flags = max(staging, KW * RT * (8 * nct + 1))
    return (flags + 2 * k + 2) // 2 * 2 + 2 * stages


@functools.lru_cache(maxsize=64)
def tile_list(k: int, nct: int) -> tuple:
    """Each column tile's Z entries in a row, in the order of their
    addresses in the row's k x k: per tile 2 * 8 nct ints (column of
    the tile | 0x80 on the diagonal (c, c), which is SQ's c too |
    address << 8), -1 past the tile's last; the tiles of tables_plan's
    column tiles in order. Tiles of Y's columns alone have none."""
    nc, ny8 = 8 * nct, 8 * -(-k // 8)
    nt8 = ny8 + 8 * -(-(k * (k + 1) // 2) // 8)
    out = []
    for n0 in range(0, nt8, nc):
        ent = []
        for c in range(k):
            for c2 in range(k):
                lo, hi = min(c, c2), max(c, c2)
                n = ny8 + lo * k - lo * (lo - 1) // 2 + hi - lo - n0
                if 0 <= n < nc:
                    ent.append(n | (0x80 if c == c2 else 0)
                               | (c * k + c2) << 8)
        out.append(ent + [-1] * (2 * nc - len(ent)))
    return tuple(out)


def _simt_floats(k: int, m: int, RT: int, band: int) -> int:
    """simt_tiles_kernel's shared memory in floats (csrc/tables.cu's
    simt_layout): O's m rows 8 ceil(k/8) apart; two buffers (a row tile's
    and the next one's) of W's and T's rows transposed (m x (RT + 4)) and
    M's (k x (RT + 4)); Y's RT x k sums, a band's Z sums (RT x band x k,
    4 floats more) and the flags (2k)."""
    RTP, KP = RT + 4, 8 * -(-k // 8)
    return (m * KP + 2 * (2 * m * RTP + k * RTP) + RT * k + RT * band * k
            + 4 + 2 * k)


def _simt_segments(k: int, c0: int, c1: int) -> list:
    """A band's segments, codes in order: Y's 8-column blocks b (code b)
    in the band at c0 = 0, then for each of its Z rows c the blocks b >=
    c / 8 ((c + 1) << 8 | b), which hold each pair c <= c' once."""
    nb = -(-k // 8)
    out = list(range(nb)) if c0 == 0 else []
    for c in range(c0, c1):
        out += [(c + 1) << 8 | b for b in range(c // 8, nb)]
    return out


@functools.lru_cache(maxsize=64)
def simt_bands(k: int, G: int, band: int) -> tuple:
    """The bands [c0, c1) of Z's rows: all k where `band` rows fit, else
    each the most rows, up to `band`, whose segments (Y's in the first)
    a pass of G threads takes."""
    if band >= k:
        return ((0, k),)
    nb = -(-k // 8)
    out, c0, n = [], 0, nb
    for c in range(k):
        seg = nb - c // 8
        if c > c0 and (n + seg > G or c - c0 >= band):
            out.append((c0, c))
            c0, n = c, 0
        n += seg
    out.append((c0, k))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def simt_table(k: int, G: int, band: int) -> tuple:
    """Each band's table for simt_tiles_kernel, one row of ints a band
    (padded with -1 to the longest): c0, c1, its segments' count, its Z
    entries' count and where they start in the row; the segments' codes
    (_simt_segments); the entries, every address of a row's k x k whose
    pair (lo, hi) = (min, max) has lo in the band, in address order, as
    address << 16 | (lo - c0) k + hi, the pair's place in the band's
    sums (its mirror takes the same). A band of all k has none: the
    kernel mirrors its sums into rows of Z in shared memory and copies
    them out."""
    bands = simt_bands(k, G, band)
    segs = [_simt_segments(k, c0, c1) for c0, c1 in bands]
    lists = []
    for c0, c1 in bands:
        ent = []
        for e in range(k * k if len(bands) > 1 else 0):
            lo, hi = sorted(divmod(e, k))
            if c0 <= lo < c1:
                ent.append(e << 16 | (lo - c0) * k + hi)
        lists.append(ent)
    start = 5 + max(map(len, segs))
    width = start + max(map(len, lists))
    rows = []
    for (c0, c1), sg, ent in zip(bands, segs, lists):
        row = [c0, c1, len(sg), len(ent), start] + sg
        row += [-1] * (start - len(row)) + ent
        rows.append(tuple(row + [-1] * (width - len(row))))
    return tuple(rows)


def _simt_plan(R: int, m: int, k: int, n_sm: int):
    """simt_tiles_kernel's plan, or None where no block fits: for RG = 1,
    2, 4, 8 row groups the bands that fit SIMT_SMEM, taking the fewest
    bands, then the fewest idle segment places, then the fewest rows; then
    fewer rows where the blocks do not fill the card FILL times over."""
    qy = -(-k // 4)
    nq = qy + -(-(k * (k + 1) // 2) // 4)
    cands = {}
    for RG in (1, 2, 4, 8):
        RT, G = SIMT_TR * RG, THREADS // RG
        band = (SIMT_SMEM // 4 - _simt_floats(k, m, RT, 0)) // (RT * k)
        if band < 1:
            continue
        bands = simt_bands(k, G, band)
        band = max(c1 - c0 for c0, c1 in bands)
        nseg = [len(_simt_segments(k, c0, c1)) for c0, c1 in bands]
        passes = [-(-n // G) for n in nseg]
        idle = 1.0 - sum(nseg) / (G * sum(passes))
        cands[RG] = ((len(bands), idle, RG), RT, G, band, max(passes),
                     len(bands))
    if not cands:
        return None
    RG = min(cands, key=lambda g: cands[g][0])
    while (RG // 2 in cands and cands[RG // 2][5] == cands[RG][5]
           and -(-R // cands[RG][1]) * cands[RG][5] < FILL * n_sm):
        RG //= 2
    _, RT, G, band, passes, tiles = cands[RG]
    L = max(m, 1)
    return TablesPlan(R=R, m=m, k=k, qy=qy, nq=nq, G=G, PQ=passes, RT=RT,
                      TQ=len(simt_table(k, G, band)[0]), acc_tiles=tiles,
                      row_tiles=-(-R // RT), L=L, CH=L, S=1, smq=band,
                      smem=4 * _simt_floats(k, m, RT, band), form="simt")


@functools.lru_cache(maxsize=256)
def tables_plan(R: int, m: int, k: int, n_sm: int) -> TablesPlan:
    """The plan of one sampler's call at rows R, partners m, k patterns
    on a card of n_sm SMs. It takes no chain count: every chain of every
    call at this shape is summed the same way."""
    if R < 1 or m < 0 or k < 1 or n_sm < 1:
        raise ValueError(f"no tables plan for R={R}, m={m}, k={k}, "
                         f"n_sm={n_sm}")
    qy = -(-k // 4)
    nq = qy + -(-(k * (k + 1) // 2) // 4)
    RW = 1 if R <= 16 else 2 if R <= 32 else MMA_WARPS
    if (m >= MMA_MIN_M and R >= MMA_MIN_R
            and (k <= TILE_MAX_K or RW == MMA_WARPS)):  # mma_kernel
        RT, L = 16 * RW, _mma_stage(RW)
        row_tiles = -(-R // RT)
        # column tiles above 12, wider above TILE_WIDE_K in the
        # tensor-core form (the short form's ring of 64 partners leaves
        # no room for them), on a ring of two stages where three would
        # cost the SM its second block
        wide = k > TILE_WIDE_K and RW == MMA_WARPS
        nct = 0 if k <= ROWS_MAX_K else 2 * TILE_NT if wide else TILE_NT
        stages = STAGES
        if wide and 4 * _tile_floats(k, RW, nct) > SMEM_TWO:
            stages = 2
        floats = (_tile_floats(k, RW, nct, stages) if nct
                  else _mma_floats(k, RW))
        if 4 * floats <= SMEM_MAX:
            nt = -(-k // 8) + -(-(k * (k + 1) // 2) // 8)
            acc_tiles = -(-nt // nct) if nct else 1
            want = -(-FILL * n_sm // (row_tiles * acc_tiles))
            CH = L * -(-m // (want * L))
            min_chunk = min(MMA_CHUNK, max(2 * L, MMA_CHUNK_ROWS * R))
            CH = max(CH, L * -(-min_chunk // L))
            CH = min(CH, L * -(-m // L))
            S = -(-m // CH)
            form = "short" if RW < MMA_WARPS else "mma"
            return TablesPlan(R=R, m=m, k=k, qy=qy, nq=nq, G=1, PQ=0,
                              RT=RT, TQ=0, acc_tiles=acc_tiles,
                              row_tiles=row_tiles, L=L, CH=CH, S=S, smq=0,
                              smem=4 * floats, form=form, RW=RW, NCT=nct,
                              stages=stages)
    if ROWS_MAX_K < k <= SIMT_MAX_K and m < MMA_MIN_M:
        plan = _simt_plan(R, m, k, n_sm)
        if plan is not None:
            return plan
    return cuda_core_plan(R, m, k, n_sm)


@functools.lru_cache(maxsize=256)
def cuda_core_plan(R: int, m: int, k: int, n_sm: int) -> TablesPlan:
    """rows_kernel's plan (k <= 12) or quads_kernel's (above): what
    tables_plan takes where neither mma_kernel nor simt_tiles_kernel
    does, and what a caller may force on any shape (card tests and
    kernel_times.py, to hold the other forms to it)."""
    if R < 1 or m < 0 or k < 1 or n_sm < 1:
        raise ValueError(f"no tables plan for R={R}, m={m}, k={k}, "
                         f"n_sm={n_sm}")
    qy = -(-k // 4)
    nq = qy + -(-(k * (k + 1) // 2) // 4)
    if k <= ROWS_MAX_K:  # rows_kernel
        G, PQ, TQ, acc_tiles, smq = 1, 0, 0, 1, 0
    else:
        G = 1
        while -(-nq // G) > QUADS[-1] and G < MAX_G:
            G *= 2
        # few rows: a row's quads over more threads, while a block's rows
        # still cover R
        while G < MAX_G and 2 * G <= nq and R <= THREADS // (2 * G):
            G *= 2
        acc_tiles = -(-nq // (G * QUADS[-1]))
        need = -(-nq // (G * acc_tiles))
        PQ = next(q for q in QUADS if q >= need)
        TQ = G * PQ
        smq = qy if qy % 2 else qy + 1  # odd: 16-byte row loads conflict-free
    RT = THREADS // G
    row_tiles = -(-R // RT)
    L = min(MAX_L, 1 << max(2, (max(m, 1) - 1).bit_length()))
    while L > 4 and _smem(RT, L, TQ, qy, smq, k)[0] > SMEM_TARGET:
        L //= 2
    smem = _smem(RT, L, TQ, qy, smq, k)[1]
    if smem > SMEM_MAX:
        raise ValueError(f"k={k}: a tables block needs {smem} bytes of "
                         f"shared memory, over {SMEM_MAX}")
    want = -(-FILL * n_sm // (row_tiles * acc_tiles))
    CH = L * -(-max(m, 1) // (want * L))
    min_chunk = min(MIN_CHUNK[1], max(MIN_CHUNK[0], 4 * R))
    CH = max(CH, L * -(-min_chunk // L))
    CH = min(CH, L * -(-max(m, 1) // L))
    S = max(1, -(-m // CH))
    return TablesPlan(R=R, m=m, k=k, qy=qy, nq=nq, G=G, PQ=PQ, RT=RT, TQ=TQ,
                      acc_tiles=acc_tiles, row_tiles=row_tiles, L=L, CH=CH,
                      S=S, smq=smq, smem=smem,
                      form="rows" if PQ == 0 else "quads")


def tables_counts(R: int, m: int, k: int, nch: int) -> tuple:
    """(bytes, float32 operations) of one call for the bound: D and invS2
    read once, M and the partner factor read once, Y, SQ, Z and col_nz
    written once; per data element the residual (2k + 2), Y (2k) and Z's
    upper triangle (2 a pair), and each partner's pair products once."""
    kp = k * (k + 1) // 2
    n_bytes = nch * (4 * (2 * R * m + R * k + m * k + 2 * R * k + R * k * k)
                     + k)
    n_ops = nch * (R * m * (4 * k + 2 + 2 * kp) + m * kp)
    return n_bytes, n_ops


def tables_tc_counts(R: int, m: int, k: int, nch: int) -> tuple:
    """(bytes, TF32 tensor-core operations) of one call for the
    tensor-core bound: tables_counts' bytes, and the 3xTF32 products of
    the k + k(k+1)/2 columns of [O | Q] over every (row, partner), three
    products of two operations each."""
    kp = k * (k + 1) // 2
    return tables_counts(R, m, k, nch)[0], nch * 6 * R * m * (k + kp)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 fraction bits) as cvt.rna.tf32.f32
    does: to nearest, ties away from zero; what is not finite stays."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tf32_split(x: torch.Tensor) -> tuple:
    """x = big + small, both TF32 (mma_kernel's 3xTF32 split)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _mma_products(a, b):
    """One n-tile's six tensor-core products over a group of 16 partners
    (..., rows, 16) x (..., 16, cols), as mma_kernel chains them: for each
    k-step of 8 partners small.big, big.small, big.big, each a float64 sum
    rounded to float32 as one mma.sync's float32 result, from zero."""
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    d = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in (0, 8):
        s = slice(k0, k0 + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            d = (x[..., s].double() @ y[..., s, :].double()
                 + d.double()).float()
    return d


def tables_tf32(D: torch.Tensor, invS2: torch.Tensor, M: torch.Tensor,
                other: torch.Tensor, n_sm: int = 132) -> tuple:
    """(Y, SQ, Z, col_nz) as mma_kernel forms them, emulated on float32
    CPU tensors (..., R, m), (..., R, m), (..., R, k), (..., m, k) of one
    leading shape: [O | Q] with Q[i, (c, c')] = O_c O_c' in its NT8
    columns (Y's k padded to n-tiles of 8, then the pairs), cut into the
    plan's column tiles (one where k <= 12); per tile the 3xTF32 products
    of each group of 16 partners (_mma_products, whose float32 rounding
    inside a product stands for the tensor core's) of X W with its Y
    columns and of W with the rest, added in float32 to a warp's sums,
    the warps of a block in warp order and the splits in split order, as
    tables_plan(R, m, k, n_sm) says; then, from every tile's sums, Y = (X
    W) O - M Z, M Z by an fmaf chain over c'. The CPU tests hold it to
    the JAX package; no path runs it."""
    R, m = D.shape[-2:]
    k = M.shape[-1]
    plan = tables_plan(R, m, k, n_sm)
    if plan.form not in ("mma", "short"):
        raise ValueError(f"no tensor-core form at R={R}, m={m}, k={k}")
    f32 = torch.float32
    XW = D * invS2
    pairs = [(c, c2) for c in range(k) for c2 in range(c, k)]
    ny8 = 8 * -(-k // 8)
    B = torch.zeros(other.shape[:-1] + (plan.NT8,), dtype=f32)
    B[..., :k] = other
    for p, (c, c2) in enumerate(pairs):
        B[..., ny8 + p] = other[..., c] * other[..., c2]
    sums = []
    for n0, n1 in plan.column_tiles():
        is_y = torch.arange(n0, n1) < ny8
        parts = []
        for lo, hi in plan.splits():
            warps = [None] * plan.KW
            for q, g0 in enumerate(range(lo, hi, 16)):
                g1 = min(g0 + 16, hi)
                pad = (0, 16 - (g1 - g0))

                def rows(x):
                    return torch.nn.functional.pad(x[..., g0:g1], pad)

                b = torch.nn.functional.pad(B[..., g0:g1, n0:n1],
                                            (0, 0) + pad)
                d = _mma_products(rows(invS2), b)
                if is_y.any():  # the tile holding Y
                    d = torch.where(is_y, _mma_products(rows(XW), b), d)
                w = q % plan.KW
                warps[w] = d if warps[w] is None else warps[w] + d
            block = None
            for w in warps:
                if w is not None:
                    block = w if block is None else block + w
            if block is None:
                block = torch.zeros(D.shape[:-1] + (n1 - n0,), dtype=f32)
            parts.append(block)
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        sums.append(total)
    total = torch.cat(sums, -1)
    Z = torch.empty(D.shape[:-1] + (k, k), dtype=f32)
    for p, (c, c2) in enumerate(pairs):
        Z[..., c, c2] = total[..., ny8 + p]
        Z[..., c2, c] = total[..., ny8 + p]
    mz = torch.zeros(D.shape[:-1] + (k,), dtype=f32)
    for c2 in range(k):  # fmaf: the product exact, one rounding
        mz = (M[..., c2:c2 + 1].double() * Z[..., c2, :].double()
              + mz.double()).to(f32)
    Y = total[..., :k] - mz
    SQ = torch.diagonal(Z, dim1=-2, dim2=-1).contiguous()
    col_nz = (other > 0).any(-2) & ~torch.isnan(other).any(-2)
    return Y, SQ, Z.reshape(D.shape[:-2] + (R * k, k)), col_nz


def build() -> tuple:
    """Compile csrc/tables.cu and load it: (library, report)."""
    lib, report = cuda_build.load("tables")
    fn = lib.cogaps_tables_launch
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i] * 17 + [p, ll] * 4 + [p] * 9
    fn.restype = i
    return lib, report


_COUNTERS: dict = {}  # device -> int32 counters, zero between launches
# (device, k, NCT, G, smq) -> tile_list(k, NCT) or simt_table(k, G, smq)
# on the device
_LISTS: dict = {}


def _counters(device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _lead_stride(name, t, lead, inner) -> int:
    """The chain stride of `t` in floats: its inner size where its
    leading shape is the call's, 0 where it has one chain for all."""
    if tuple(t.shape[:-2]) == tuple(lead):
        return inner
    if math.prod(t.shape[:-2]) == 1:
        return 0
    raise ValueError(f"{name} has leading shape {tuple(t.shape[:-2])}, "
                     f"not {tuple(lead)} or one chain")


def dense_tables(D: torch.Tensor, invS2: torch.Tensor, M: torch.Tensor,
                 other: torch.Tensor, plan: TablesPlan | None = None
                 ) -> tuple:
    """(Y, SQ, Z, col_nz) of one update call of the sampler of M, for
    float32 CUDA tensors D, invS2 (..., R, m), M (..., R, k), other (...,
    m, k), with any leading (chain) shape, each tensor's either the
    call's or one chain for all. One kernel launch, as tables_plan says,
    or as `plan` says (one of this shape's, such as cuda_core_plan's)."""
    R, m = D.shape[-2:]
    k = M.shape[-1]
    dev = M.device
    if dev.type != "cuda":
        raise ValueError(f"no tables kernel for tensors on {dev}")
    if R < 1:
        raise ValueError("the tables kernel takes at least one row")
    lead = max((x.shape[:-2] for x in (D, invS2, M, other)),
               key=math.prod)
    f32 = torch.float32
    strides = []
    for name, t, shape in (("D", D, (R, m)), ("invS2", invS2, (R, m)),
                           ("M", M, (R, k)), ("other", other, (m, k))):
        cuda_build.check(name, t, f32, t.shape[:-2] + shape, dev)
        strides.append(_lead_stride(name, t, lead, shape[0] * shape[1]))
    nch = math.prod(lead)
    Y = torch.empty(lead + (R, k), dtype=f32, device=dev)
    SQ = torch.empty(lead + (R, k), dtype=f32, device=dev)
    Z = torch.empty(lead + (R * k, k), dtype=f32, device=dev)
    col_nz = torch.empty(lead + (k,), dtype=torch.bool, device=dev)
    if nch == 0:
        return Y, SQ, Z, col_nz
    if plan is None:
        plan = tables_plan(R, m, k, cuda_build.sm_count(dev.index or 0))
    elif (plan.R, plan.m, plan.k) != (R, m, k):
        raise ValueError(f"a plan of R={plan.R}, m={plan.m}, k={plan.k} "
                         f"for a call of R={R}, m={m}, k={k}")
    tiles = plan.row_tiles * plan.acc_tiles
    part = flags = counters = zlist = None
    if plan.S > 1:
        part = torch.empty(nch * tiles * plan.S * plan.partial,
                           dtype=f32, device=dev)
        flags = torch.empty(nch * plan.S * 2 * k, dtype=torch.int32,
                            device=dev)
    if plan.form != "simt" and (plan.S > 1 or plan.acc_tiles > 1):
        # splits', then row tiles' counts
        counters = _counters(dev, nch * (tiles + plan.row_tiles))
    if plan.NCT or plan.form == "simt":
        key = (dev, k, plan.NCT, plan.G, plan.smq)
        zlist = _LISTS.get(key)
        if zlist is None:
            zlist = torch.tensor(
                tile_list(k, plan.NCT) if plan.NCT
                else simt_table(k, plan.G, plan.smq), dtype=torch.int32,
                device=dev)
            _LISTS[key] = zlist
    lib, _ = build()
    with torch.cuda.device(dev):
        err = lib.cogaps_tables_launch(
            nch, R, m, k, FORMS[plan.form], plan.G, plan.PQ,
            plan.TQ, plan.acc_tiles, plan.S, plan.CH, plan.L, plan.smq,
            plan.RW, plan.NCT, plan.stages, plan.smem,
            D.data_ptr(), strides[0], invS2.data_ptr(), strides[1],
            M.data_ptr(), strides[2], other.data_ptr(), strides[3],
            Y.data_ptr(), SQ.data_ptr(), Z.data_ptr(), col_nz.data_ptr(),
            None if part is None else part.data_ptr(),
            None if flags is None else flags.data_ptr(),
            None if counters is None else counters.data_ptr(),
            None if zlist is None else zlist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tables kernel launch failed: CUDA error {err} "
                           f"({plan})")
    dense_tables.launches += 1
    dense_tables.by_form[plan.form] = dense_tables.by_form.get(plan.form,
                                                               0) + 1
    return Y, SQ, Z, col_nz


dense_tables.launches = 0
dense_tables.by_form = {}  # the launches of each plan form
