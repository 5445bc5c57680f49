"""The sparse model's per-call tables in one hand-written kernel
(csrc/sparse_tables.cu) and its wrapper.

``sparse_tables(csr, other, M)`` builds one update call's (SQ, Y0, G)
tables of the sampler of M for every chain of the call, from the chains'
data rows in CSR order (models/sparse.CsrMatrix) and the frozen partner
factor: what cogaps_tpu/models/sparse.py:246 (kernel_tables) and :269
(kernel_tables_ell) form, in the layout K2 reads (SQ and Y0 (NCH, NR, k),
G (NCH, NR k, k)). Those are XLA dots over dense (NR x m) weights, or
gathers of the (m x k^2) Gram rows, with no Pallas kernel; the port's
engines ran them as cuBLAS products (models/sparse.kernel_tables), which
spend their operations on the zeros. The kernel gathers each row's partner
rows instead: per nonzero k(k+1)/2 + k fmaf on the CUDA cores, in 4 x 4
register tiles of U's upper triangle, a row a block at a time, the
block's groups of threads over a segment of its nonzeros, or above
k = 172, where a row's items outnumber a block's threads, the block's
threads over a slab of the items at a time (csrc/sparse_tables.cu's
header).

For CUDA tensors it launches the kernel or raises; for CPU tensors it
runs ``sparse_tables_plain``, the same function of the same CSR inputs in
plain PyTorch (a gather and an index_add_ of the nonzeros' terms a chunk
at a time). The engines keep models/sparse.kernel_tables and
kernel_tables_ell as their CPU path.

Every entry of a chain's tables is summed in an order fixed by k and its
row's nonzeros alone (``segments``): a row's nonzeros in segments of
``sparse_plan(k).SEG``, each cut into G ranges of SUB summed as fmaf
chains from zero in CSR order and added in order, the segments added in
order; Z2 = O^T O in chunks of ZSEG partners alike, added in chunk
order. The plan takes neither the chain count nor the SM count, so
a chain's tables are the same bits alone and beside any others.
``sparse_tables_counts`` gives the bytes and float32 operations the bound
counts. The kernel is built from csrc/sparse_tables.cu by
ops/cuda_build.py at first use.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models import sparse
from . import cuda_build

THREADS = 128  # a block's threads where a row's items fit in 128
TILE = 4  # csrc/sparse_tables.cu: a thread's 4 x 4 entries of U, 4 of T4
MAX_THREADS = 1024  # a block's threads at most: past them, slabs
ZCHUNK = 1024  # Z2's partners a chunk at least, where a row has slabs
# shared memory a segment's staging aims under: its partner rows, their
# indices and coefficients
SMEM_TARGET = 24 * 1024
_PLAIN_CHUNK = 1 << 24  # float32 elements of the plain version's terms


class SparsePlan(NamedTuple):
    """How one call's tables are built, from k alone: k padded to KP =
    TILE nt; P items a row (the nt (nt + 1) / 2 tiles of U's upper
    triangle and nt strips of T4), a block of `threads` threads taking
    one row at a time as G groups of P, or, where P is past
    MAX_THREADS, as S slabs of `threads` items in turn (G = 1); a row's
    nonzeros (and Z2's partners) staged SEG = G SUB at a time, group g
    summing [g SUB, (g + 1) SUB) of them; Z2's partners in chunks of
    ZSEG (SEG, or with slabs a multiple of SEG of ZCHUNK at least);
    smem bytes of dynamic shared memory."""
    k: int
    KP: int
    nt: int
    P: int
    G: int
    SUB: int
    SEG: int
    S: int
    ZSEG: int
    threads: int
    smem: int


def sparse_plan(k: int) -> SparsePlan:
    """The kernel's plan at k patterns (and nothing else)."""
    if k < 1:
        raise ValueError(f"the sparse tables kernel takes k >= 1, not "
                         f"k={k}")
    KP = TILE * -(-k // TILE)
    nt = KP // TILE
    P = nt * (nt + 1) // 2 + nt
    S = -(-P // MAX_THREADS)
    if P <= THREADS:
        threads, G = THREADS, THREADS // P
    else:
        per_slab = -(-P // S)
        threads, G = 32 * -(-per_slab // 32), 1
    # a segment's partner rows (KP floats), index, w and 1/d; without
    # slabs, room for the row's G (k^2 floats) where the rows were staged
    sub = max(1, (SMEM_TARGET // 4) // (G * (KP + 3)))
    if S == 1:
        sub = max(sub, -(-k * k // (G * KP)))
    seg = G * sub
    zseg = seg if S == 1 else seg * -(-ZCHUNK // seg)
    smem = 4 * (seg * (KP + 3) + KP + (G * P * 16 if G > 1 else 0))
    return SparsePlan(k=k, KP=KP, nt=nt, P=P, G=G, SUB=sub, SEG=seg, S=S,
                      ZSEG=zseg, threads=threads, smem=smem)


def segments(k: int, n: int) -> tuple:
    """The order of a row's sums at k patterns: its n nonzeros in
    segments of SEG, each a tuple of its groups' nonempty ranges [lo, hi)
    of SUB (each summed in order from zero, then added in group order),
    the segments added in order (Z2's chunks of ZSEG partners alike)."""
    p = sparse_plan(k)
    return tuple(tuple((a, min(hi, a + p.SUB))
                       for a in range(lo, hi, p.SUB))
                 for lo, hi in ((s, min(n, s + p.SEG))
                                for s in range(0, n, p.SEG)))


def sparse_tables_counts(nnz: int, NR: int, m: int, k: int, nch: int,
                         o_chains: int = None, m_chains: int = None
                         ) -> tuple:
    """(bytes, float32 operations) of one call for the bound: indptr, idx
    and val read once, the partner factor and M once a chain that has
    its own (o_chains, m_chains: nch or 1), G, SQ and Y0 written once; per
    nonzero w and 1/d (3), U's upper triangle (2 a pair) and T4 (2k); per
    chain Z2's upper triangle over m partners; per row G's pairs (2 a
    pair: a subtraction, a product), beta T4 (k) and Y0 (2k^2 + k)."""
    o_chains = nch if o_chains is None else o_chains
    m_chains = nch if m_chains is None else m_chains
    kp = k * (k + 1) // 2
    n_bytes = (8 * nch * (NR + 1) + 8 * nnz + 4 * o_chains * m * k
               + 4 * m_chains * NR * k + 4 * nch * NR * (k * k + 2 * k))
    n_ops = (nnz * (3 + 2 * kp + 2 * k) + nch * m * 2 * kp
             + nch * NR * (2 * kp + 2 * k * k + 2 * k))
    return n_bytes, n_ops


def _chain_rows(x: torch.Tensor, nch: int) -> list:
    return [x[0 if x.shape[0] == 1 else c] for c in range(nch)]


def sparse_tables_plain(csr: sparse.CsrMatrix, other: torch.Tensor,
                        M: torch.Tensor) -> tuple:
    """The kernel's function in plain PyTorch, chain by chain: U and T4
    by index_add_ of each nonzero's w o o^T and (1/d) o over its row (a
    chunk of nonzeros at a time), then Z2 = O^T O, G, SQ and Y0 as
    models/sparse.kernel_tables forms them. csr holds NCH chains; other
    (NCH or 1, m, k) and M (NCH or 1, NR, k). Returns (SQ, Y0, G) of
    shapes (NCH, NR, k), (NCH, NR, k), (NCH, NR k, k)."""
    nch, NR = csr.n_chains, csr.n_rows
    k = other.shape[-1]
    _lead("other", other, nch)
    _lead("M", M, nch)
    outs = []
    for c, (O, Mc) in enumerate(zip(_chain_rows(other, nch),
                                    _chain_rows(M, nch))):
        one = csr.chain(c)
        rows = one.row_ids()
        idx = one.idx.to(torch.int64)
        d = one.val
        w = 1.0 - torch.reciprocal(d * d)
        dr = torch.reciprocal(d)
        U = torch.zeros((NR, k, k), dtype=O.dtype, device=O.device)
        T4 = torch.zeros((NR, k), dtype=O.dtype, device=O.device)
        step = max(1, _PLAIN_CHUNK // (k * k))
        for lo in range(0, idx.numel(), step):
            hi = lo + step
            o = torch.index_select(O, 0, idx[lo:hi])
            wo = w[lo:hi, None] * o
            U.index_add_(0, rows[lo:hi], wo[:, :, None] * o[:, None, :])
            T4.index_add_(0, rows[lo:hi], dr[lo:hi, None] * o)
        outs.append(sparse._tables_from(U.reshape(NR, k * k), T4, O, Mc))
    return tuple(torch.stack(x) for x in zip(*outs))


def build() -> tuple:
    """Compile csrc/sparse_tables.cu and load it: (library, report)."""
    lib, report = cuda_build.load("sparse_tables")
    fn = lib.cogaps_sparse_tables_launch
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i] * 13 + [p] * 4 + [ll, p, ll] + [p] * 6
    fn.restype = i
    return lib, report


def _lead(name, t, nch) -> int:
    """The chain stride of `t` in floats: its inner size where it has
    nch chains, 0 where it has one for all."""
    if t.dim() == 3 and t.shape[0] == nch:
        return t.shape[1] * t.shape[2]
    if t.dim() == 3 and t.shape[0] == 1:
        return 0
    raise ValueError(f"{name} has shape {tuple(t.shape)}, not (chains or "
                     f"1, rows, k) with {nch} chains")


def _launch(csr, other, M, plan, outs, scratch) -> int:
    lib, _ = build()
    nch, NR = csr.n_chains, csr.n_rows
    m, k = other.shape[-2:]
    dev = M.device
    SQ, Y0, G = outs
    zpart, Z2 = scratch
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        return lib.cogaps_sparse_tables_launch(
            nch, NR, m, k, plan.KP, plan.nt, plan.P, plan.G, plan.SUB,
            plan.S, plan.ZSEG, plan.threads, plan.smem,
            csr.indptr.data_ptr(),
            ptr(csr.idx) if csr.idx.numel() else None,
            ptr(csr.val) if csr.val.numel() else None, other.data_ptr(),
            _lead("other", other, nch), M.data_ptr(), _lead("M", M, nch),
            ptr(SQ), ptr(Y0), ptr(G), ptr(zpart), ptr(Z2),
            torch.cuda.current_stream(dev).cuda_stream)


def sparse_tables(csr: sparse.CsrMatrix, other: torch.Tensor,
                  M: torch.Tensor) -> tuple:
    """(SQ, Y0, G) of one update call of the sampler of M for every chain
    of csr: other (NCH or 1, m, k) the frozen partner factor, M (NCH or 1,
    NR, k) the sampled factor at call start, float32 and contiguous. One
    kernel launch on CUDA tensors; the plain version on CPU tensors."""
    if M.device.type == "cpu" and other.device.type == "cpu":
        return sparse_tables_plain(csr, other, M)
    dev = M.device
    if dev.type != "cuda":
        raise ValueError(f"no sparse tables kernel for tensors on {dev}")
    nch, NR = csr.n_chains, csr.n_rows
    m, k = other.shape[-2:]
    f32 = torch.float32
    for name, t, shape in (("other", other, (m, k)), ("M", M, (NR, k))):
        _lead(name, t, nch)
        cuda_build.check(name, t, f32, t.shape[:1] + shape, dev)
    nnz = csr.idx.numel()
    cuda_build.check("csr.indptr", csr.indptr, torch.int64, (nch, NR + 1),
                     dev)
    cuda_build.check("csr.idx", csr.idx, torch.int32, (nnz,), dev)
    cuda_build.check("csr.val", csr.val, f32, (nnz,), dev)
    plan = sparse_plan(k)
    outs = (torch.empty((nch, NR, k), dtype=f32, device=dev),
            torch.empty((nch, NR, k), dtype=f32, device=dev),
            torch.empty((nch, NR * k, k), dtype=f32, device=dev))
    if nch == 0 or NR == 0:
        return outs
    nzc = -(-m // plan.ZSEG)
    scratch = (torch.empty(max(1, nch * nzc * k * k), dtype=f32, device=dev),
               torch.empty(nch * k * k, dtype=f32, device=dev))
    err = _launch(csr, other, M, plan, outs, scratch)
    if err != 0:
        raise RuntimeError(f"sparse tables kernel launch failed: CUDA error "
                           f"{err} ({plan})")
    sparse_tables.launches += 1
    return outs


sparse_tables.launches = 0

