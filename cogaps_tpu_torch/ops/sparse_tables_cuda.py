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
rows instead, per nonzero k(k+1)/2 + k fmaf on the CUDA cores, in one of
three forms that ``sparse_plan(k)`` picks from k alone
(csrc/sparse_tables.cu's header):

- "lanes", k <= 16 (the main path's k = 10): a warp a row, a lane a
  nonzero with every entry in its registers; the partner rows by 16-byte
  cp.async from a padded copy of O into a ring of LANE_STAGES stages ahead
  of the sums, the rows in flight without block barriers; the lanes' sums
  added by a butterfly of shuffles. At k = 10 the bound is bytes and a
  few microseconds: what it fights is latency and fixed costs.
- "tiles", 16 < k <= 172: a block a row, 8 x 8 tiles of U's upper
  triangle a thread (64 + 8 fmaf for 4 16-byte loads), one warp at k = 50
  (two of groups up to 16 tiles, as many as the tiles fill above), the
  next segment staged behind the sums; bound by the FP32 pipe, the
  instructions issued for each fmaf and shared memory's bandwidth.
- "slabs", k > 172: 4 x 4 tiles over S slabs of up to 1024 threads, the
  first design of this kernel.

For CUDA tensors it launches the kernel or raises; for CPU tensors it
runs ``sparse_tables_plain``, the same function of the same CSR inputs in
plain PyTorch (a gather and an index_add_ of the nonzeros' terms a chunk
at a time). The engines keep models/sparse.kernel_tables and
kernel_tables_ell as their CPU path.

Every entry of a chain's tables is summed in an order fixed by k and its
row's nonzeros alone (``segments``), and Z2 = O^T O in chunks fixed by k
and m alone (``z2_chunks``), added in chunk order. Neither takes the chain
count or the SM count, so a chain's tables are the same bits alone and
beside any others. ``sparse_tables_counts`` gives the bytes and float32
operations the bound counts. The kernel is built from
csrc/sparse_tables.cu by ops/cuda_build.py at first use.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models import sparse
from . import cuda_build

LANES_MAX_K = 16  # the lanes form up to here (csrc: lanes_kernel<K>)
TILES_MAX_K = 172  # the tiles form up to here: a row's tiles in 256 threads
LANES = 32  # the lanes form's nonzeros a stage: a warp's lanes
LANE_THREADS = 128  # csrc: kLaneThreads, 4 warps a block
LANE_STAGES = 4  # csrc: kLaneStages, the lanes form's ring
TILE = 8  # the tiles form's 8 x 8 tiles
TILE_SMALL = 16  # tiles a row up to which a block is 64 threads of groups
TILE_AHEAD = 1  # csrc: kTileAhead, the tiles form's rows staged ahead
TILE_RING = 24 * 1024  # bytes the tiles form's ring aims under
CHAIN = 32  # the tiles form's nonzeros an fmaf chain at least
MAX_CHUNKS = 32  # csrc: kMaxChunks, Z2's chunks a chain (lanes, tiles)
SLAB_TILE = 4  # the slabs form's 4 x 4 tiles and strips of T4
MAX_THREADS = 1024  # the slabs form's block at most
ZCHUNK = 1024  # the slabs form's Z2 partners a chunk at least
# shared memory the slabs form's segment staging aims under: its partner
# rows, their indices and coefficients
SMEM_TARGET = 24 * 1024
FORMS = ("lanes", "tiles", "slabs")  # csrc: form 0, 1, 2
_PLAIN_CHUNK = 1 << 24  # float32 elements of the plain version's terms


class SparsePlan(NamedTuple):
    """How one call's tables are built, from k alone.

    form: "lanes", "tiles" or "slabs". KP: k padded (4 ceil(k/4), or 8
    ceil(k/8) for 8 x 8 tiles), the width of a staged partner row and of
    the padded copy of O; RS its stride in shared memory. P: the entries a
    lane holds (lanes: k(k+1)/2 + k), the tiles of U's upper triangle
    (tiles: nt(nt+1)/2), or the items of a row (slabs: nt(nt+1)/2 pair
    tiles and nt strips of T4). A block of `threads` threads; G groups of
    P threads split each segment of SEG = G SUB nonzeros, group g taking
    [g SUB, (g + 1) SUB) of it (lanes: G = 1, SUB = 1, SEG = 32, a lane a
    nonzero); a tiles thread's fmaf chain runs over FL segments; S slabs
    of a row's items (slabs only). smem: bytes of dynamic shared memory."""
    k: int
    form: str
    KP: int
    RS: int
    P: int
    G: int
    SUB: int
    SEG: int
    FL: int
    S: int
    threads: int
    smem: int


def _lane_warp_floats(k: int, KP: int, RS: int) -> int:
    """A lanes-form warp's shared floats (csrc: Lane<K>::WARP): the ring's
    rows, idx and val, U and T4, G."""
    E = k * (k + 1) // 2 + k
    n = LANE_STAGES * LANES * RS + 4 * LANE_STAGES * LANES + E + k * k
    return 4 * -(-n // 4)


def sparse_plan(k: int) -> SparsePlan:
    """The kernel's plan at k patterns (and nothing else)."""
    if k < 1:
        raise ValueError(f"the sparse tables kernel takes k >= 1, not "
                         f"k={k}")
    if k <= LANES_MAX_K:
        KP = 4 * -(-k // 4)
        RS = KP if KP % 8 == 4 else KP + 4
        warps = LANE_THREADS // LANES
        return SparsePlan(k=k, form="lanes", KP=KP, RS=RS,
                          P=k * (k + 1) // 2 + k, G=1, SUB=1, SEG=LANES,
                          FL=1, S=1, threads=LANE_THREADS,
                          smem=4 * warps * _lane_warp_floats(k, KP, RS))
    if k <= TILES_MAX_K:
        nt = -(-k // TILE)
        KP, P = TILE * nt, nt * (nt + 1) // 2
        RS = KP + 4
        # a row a block: two warps of G groups up to 16 tiles, else one
        # group of as many warps as the tiles fill (k = 50: one warp)
        threads = 64 if P <= TILE_SMALL else 32 * -(-P // 32)
        G = threads // P
        # a staged nonzero: its row (RS floats), (w, 1/d), idx and val;
        # TILE_AHEAD + 1 segments of rows, 2 TILE_AHEAD of idx and val
        slots = TILE_AHEAD + 1
        sub = max(1, min(CHAIN, TILE_RING // (slots * G * (RS + 4) * 4)))
        seg = G * sub
        return SparsePlan(k=k, form="tiles", KP=KP, RS=RS, P=P, G=G,
                          SUB=sub, SEG=seg, FL=-(-CHAIN // sub), S=1,
                          threads=threads,
                          smem=4 * (72 * threads + slots * seg * (RS + 2)
                                    + 4 * TILE_AHEAD * seg + KP * nt
                                    + 16))
    KP = SLAB_TILE * -(-k // SLAB_TILE)
    nt = KP // SLAB_TILE
    P = nt * (nt + 1) // 2 + nt
    S = -(-P // MAX_THREADS)
    per_slab = -(-P // S)
    threads = 32 * -(-per_slab // 32)
    sub = max(1, (SMEM_TARGET // 4) // (KP + 3))
    return SparsePlan(k=k, form="slabs", KP=KP, RS=KP, P=P, G=1, SUB=sub,
                      SEG=sub, FL=1, S=S, threads=threads,
                      smem=4 * (sub * (KP + 3) + KP))


def z2_chunks(k: int, m: int) -> tuple:
    """(ZSEG, nzc): Z2 = O^T O over m partners in nzc chunks of ZSEG
    partners (the last shorter), from k and m alone: whole stages of the
    lanes and tiles forms, at most MAX_CHUNKS of them; in the slabs form
    whole segments of ZCHUNK partners at least. A chunk is summed as a
    row of its partners is (w = 1), the chunks' sums added in order."""
    p = sparse_plan(k)
    if p.form == "slabs":
        zseg = p.SEG * -(-ZCHUNK // p.SEG)
    else:
        steps = -(-m // p.SEG)
        zseg = p.SEG * max(1, -(-steps // MAX_CHUNKS))
    return zseg, -(-m // zseg)


def segments(k: int, n: int) -> tuple:
    """The order of a row's sums at k patterns over its n nonzeros
    (positions 0 .. n - 1 in CSR order): a tuple of groups, each a tuple
    of fmaf chains, each the tuple of the positions it sums from zero in
    that order; a group's chains are added in order, and the groups by
    ``sparse_plan(k).form``: "lanes", lane l's group (l < 32) summing
    positions l, l + 32, ..., the lanes' sums added by a butterfly of the
    pairs 16, 8, 4, 2 and 1 lanes apart; "tiles", group g's chains each
    its ranges [s SEG + g SUB, s SEG + (g + 1) SUB) of FL segments s in
    turn, the groups added in group order; "slabs", one group whose
    chains are the segments of SEG. Empty chains and groups (zeros) are
    left out."""
    p = sparse_plan(k)
    if p.form == "lanes":
        return tuple((tuple(range(lane, n, LANES)),)
                     for lane in range(min(LANES, n)))
    if p.form == "slabs":
        return (tuple(tuple(range(lo, min(n, lo + p.SEG)))
                      for lo in range(0, n, p.SEG)),) if n else ()
    nst = -(-n // p.SEG)
    groups = []
    for g in range(p.G):
        chains = []
        for c0 in range(0, nst, p.FL):
            chain = tuple(i for s in range(c0, min(nst, c0 + p.FL))
                          for i in range(s * p.SEG + g * p.SUB,
                                         min(n, s * p.SEG + (g + 1) * p.SUB)))
            if chain:
                chains.append(chain)
        if chains:
            groups.append(tuple(chains))
    return tuple(groups)


def scratch_floats(plan: SparsePlan, nch: int, n_other: int, m: int) -> int:
    """Floats of the kernel's one scratch buffer for nch chains and
    n_other partner factors of m rows (csrc: cogaps_sparse_tables_launch):
    Z2's chunk partials and Z2; for lanes and tiles Z2 from a multiple of
    32 floats, each chain's k^2 rounded up to 32 (a 128-byte line of its
    own), then the padded copy of O and 2 nch counters and flags."""
    kk = plan.k * plan.k
    _, nzc = z2_chunks(plan.k, m)
    if plan.form == "slabs":
        return nch * (nzc + 1) * kk
    nz4 = 4 * -(-nzc // 4)
    z2_at = 32 * -(-(nch * kk * nz4) // 32)
    opad_at = z2_at + nch * 32 * -(-kk // 32)
    return opad_at + n_other * m * plan.KP + 2 * nch


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
    fn.argtypes = [i] * 17 + [p] * 4 + [ll, p, ll] + [p] * 4 + [ll, p]
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
    zseg, nzc = z2_chunks(k, m)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        return lib.cogaps_sparse_tables_launch(
            FORMS.index(plan.form), nch, NR, m, k, plan.KP, plan.RS, plan.P,
            plan.G, plan.SUB, plan.SEG, plan.FL, plan.S, zseg, nzc,
            plan.threads, plan.smem, csr.indptr.data_ptr(),
            ptr(csr.idx) if csr.idx.numel() else None,
            ptr(csr.val) if csr.val.numel() else None, other.data_ptr(),
            _lead("other", other, nch), M.data_ptr(), _lead("M", M, nch),
            ptr(SQ), ptr(Y0), ptr(G), ptr(scratch), scratch.numel(),
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
    scratch = torch.empty(scratch_floats(plan, nch, other.shape[0], m),
                          dtype=f32, device=dev)
    err = _launch(csr, other, M, plan, outs, scratch)
    if err != 0:
        raise RuntimeError(f"sparse tables kernel launch failed: CUDA error "
                           f"{err} ({plan})")
    sparse_tables.launches += 1
    return outs


sparse_tables.launches = 0

