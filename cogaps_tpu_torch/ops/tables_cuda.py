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

Two kernels, as ``tables_plan`` says: rows_kernel<k> for k <= 12, a
thread a row with all its accumulators in registers, and quads_kernel<PQ>
beyond, each thread PQ quads of a row's accumulators, G threads a row.
quads_kernel computes every k, but forced at k=10 it took 2.0-3.6x
rows_kernel's time at 4 x 5000 x 2000 and 16 x 20000 x 100 (NVIDIA H100
80GB HBM3, 700 W; kernel_times.py --quads): it reads M's row and the
partner's products from shared memory where rows_kernel keeps them in
registers. Every float32 entry of a chain is summed in an order that ``tables_plan``
fixes from (R, m, k) and the card's SM count alone, never from the number
of chains in the call or a chain's index: a chain's tables are the same
bits alone and beside any number of other chains, which batched cuBLAS
products do not give (cuBLAS picks its kernel by the batch count). A
contraction split into chunks is added in split order by the last block
to finish; there are no float atomics. ``tables_counts`` gives the bytes
and float32 operations the bound counts. The kernel is built from
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
QUADS = (1, 2, 3, 4, 6, 8, 9, 11, 15, 17, 20)  # quads_kernel's PQ
ROWS_MAX_K = 12  # rows_kernel's K: 1 .. 12
MAX_G = 32  # threads sharing a row
SMEM_TARGET = 56 * 1024  # shared memory a block aims under: four an SM
SMEM_MAX = 232_448  # an H100 block's most (227 KB)
MAX_L = 128  # partners a sub-tile stages
# the shortest contraction chunk a split takes: 4 R partners, from 64 to
# 256 (a block's sums run in sequence; fewer rows, shorter chunks, more
# splits to add at the end: the best of 64, 128 and 256 at R = 9, 32, 64
# and 100 on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke's
# tables_inputs)
MIN_CHUNK = (64, 256)
FILL = 2  # blocks an SM that one chain's call aims at
REG_BASE = 48  # registers a thread holds besides its accumulators


class TablesPlan(NamedTuple):
    """How one sampler's tables are built, per chain: blocks of THREADS
    threads, G a row, so RT rows a block. PQ 0: rows_kernel, a thread a
    row and its k + k(k+1)/2 float accumulators. Else quads_kernel: each
    thread keeps PQ quads (float4 accumulators) of its row's nq = qy + qz
    (Y's k columns, then Z's k(k+1)/2 pairs c <= c', four a quad), a
    block TQ of them, in acc_tiles tiles, with M's rows staged smq quads
    apart. The contraction of m partners runs in S chunks of CH (the last
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

    @property
    def blocks(self) -> int:
        """Blocks a chain."""
        return self.row_tiles * self.acc_tiles * self.S

    @property
    def accumulators(self) -> int:
        """float32 accumulators a thread keeps: its partials a split."""
        if self.PQ == 0:
            return self.k + self.k * (self.k + 1) // 2
        return 4 * self.PQ

    @property
    def registers(self) -> int:
        """Registers a thread needs: its accumulators, in rows_kernel M's
        row and the partner's too, and the rest."""
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
                      S=S, smq=smq, smem=smem)


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


def build() -> tuple:
    """Compile csrc/tables.cu and load it: (library, report)."""
    lib, report = cuda_build.load("tables")
    fn = lib.cogaps_tables_launch
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i] * 13 + [p, ll] * 4 + [p] * 8
    fn.restype = i
    return lib, report


_COUNTERS: dict = {}  # device -> int32 counters, zero between launches


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
                 other: torch.Tensor) -> tuple:
    """(Y, SQ, Z, col_nz) of one update call of the sampler of M, for
    float32 CUDA tensors D, invS2 (..., R, m), M (..., R, k), other (...,
    m, k), with any leading (chain) shape, each tensor's either the
    call's or one chain for all. One kernel launch."""
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
    plan = tables_plan(R, m, k, cuda_build.sm_count(dev.index or 0))
    tiles = plan.row_tiles * plan.acc_tiles
    part = flags = counters = None
    if plan.S > 1:
        part = torch.empty(nch * tiles * plan.S * plan.accumulators
                           * THREADS, dtype=f32, device=dev)
        flags = torch.empty(nch * plan.S * 2 * k, dtype=torch.int32,
                            device=dev)
        counters = _counters(dev, nch * tiles)
    lib, _ = build()
    with torch.cuda.device(dev):
        err = lib.cogaps_tables_launch(
            nch, R, m, k, plan.G, plan.PQ, plan.TQ, plan.acc_tiles, plan.S,
            plan.CH, plan.L, plan.smq, plan.smem,
            D.data_ptr(), strides[0], invS2.data_ptr(), strides[1],
            M.data_ptr(), strides[2], other.data_ptr(), strides[3],
            Y.data_ptr(), SQ.data_ptr(), Z.data_ptr(), col_nz.data_ptr(),
            None if part is None else part.data_ptr(),
            None if flags is None else flags.data_ptr(),
            None if counters is None else counters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tables kernel launch failed: CUDA error {err} "
                           f"({plan})")
    dense_tables.launches += 1
    return Y, SQ, Z, col_nz


dense_tables.launches = 0
