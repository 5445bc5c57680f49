"""One sparse-model update call for NCH chains: the CUDA CSR sweep kernel
(csrc/atlas.cu) and its wrapper.

``run_updates_atlas_multi`` runs every chain's ``update(nSteps)`` of the
sparse normal model in one cooperative launch, reading each proposal's
data row through the CSR layout (models/sparse.CsrMatrix) and the frozen
partner factor: no per-row tables. Each sweep's proposals and accepts
run on one block per chain, and its alphaParameters' sums over the kept
rows' nonzeros on every SM: each kept row pass is cut into work items of
at most ``CHUNK`` nonzeros, whose partial sums each chain's block adds
in chunk order (csrc/atlas.cu's header). It replaces
cogaps_tpu/ops/pallas_atlas.py::_kernel_atlas and its wrapper
run_updates_atlas. For tensors on the CPU it runs the plain version,
ops/sweep.run_updates with models/sparse.make_model chain by chain; for
CUDA tensors it launches the kernel or raises. The random modes are
those of ops/sweep_cuda.py (exact: a UniformSource; fast: a PhiloxKey).

Beside it, plain versions of the kernel's decomposition: its work
schedule (``work_items_plain``) and its chunked alphaParameters
(``alpha_chunked_plain``, as a sweep model ``chunked_model``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ..models import dense, sparse
from . import cuda_build
from .atoms import AtomTable, stack_atoms
from .sweep import (AddrBatch, MassParams, SamplerConsts, UniformSource,
                    run_updates)
from .sweep_cuda import (KernelState, PhiloxKey, drive, plain_chains,
                         stack_counts)


MAX_K = 64  # csrc/atlas.cu holds a factor row in two registers a thread
CHUNK = 128  # nonzeros of a work item: a warp's four partner rows a thread


def build() -> tuple:
    """Compile csrc/atlas.cu (once per source hash) and load it. Returns
    (ctypes library, compiler report)."""
    lib, report = cuda_build.load("atlas")
    fn = lib.cogaps_atlas_launch
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * 16 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_uint32]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    lib.cogaps_atlas_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cogaps_atlas_workspace.restype = ctypes.c_longlong
    lib.cogaps_atlas_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cogaps_atlas_grid.restype = ctypes.c_int
    return lib, report


def grid_blocks(device) -> int:
    """The kernel's grid on `device`: its resident blocks (the occupancy
    query times the SM count). NCH may not exceed it."""
    lib, _ = build()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.cogaps_atlas_grid(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"atlas kernel occupancy query: CUDA error {err}")
    return blocks.value


def run_updates_atlas_multi(atoms: AtomTable, M: torch.Tensor,
                            csr: sparse.CsrMatrix, other: torch.Tensor,
                            temp: float, n_steps: torch.Tensor,
                            consts: SamplerConsts, mass: MassParams,
                            rand: Union[PhiloxKey, UniformSource], *,
                            s_max: int = 32,
                            max_sweeps: Optional[int] = None):
    """Sparse-model update calls of NCH chains. atoms: (NCH, C) tables
    with n (NCH,); M: (NCH, n_rows, k) the sampled factor; csr: the data
    rows of every chain in this orientation; other: (NCH, m, k) the
    frozen partner factor; n_steps (NCH,) int32 budgets; mass fields
    (NCH,). The inputs are left untouched.

    Returns (atoms, M, done, n_sweeps, counts), chain-stacked."""
    if max_sweeps is not None and isinstance(rand, PhiloxKey):
        raise ValueError("max_sweeps needs a UniformSource (exact mode)")
    if M.device.type == "cpu":
        return run_updates_atlas_multi_plain(
            atoms, M, csr, other, temp, n_steps, consts, mass, rand,
            max_sweeps=max_sweeps)
    if M.device.type != "cuda":
        raise ValueError(f"no sweep for tensors on {M.device}")
    return _run_kernel(atoms, M, csr, other, temp, n_steps, consts, mass,
                       rand, s_max, max_sweeps)


run_updates_atlas_multi.launches = 0


@torch.inference_mode()
def run_updates_atlas_multi_plain(atoms, M, csr, other, temp, n_steps,
                                  consts, mass, rand, max_sweeps=None):
    """The plain version of run_updates_atlas_multi: ops/sweep.run_updates
    with models/sparse.make_model over each chain's rows as ELL (built
    from the CSR once and kept), on whatever device the tensors are."""

    def one(c, blocks, budget, chain_mass):
        model = sparse.make_model(csr.ell(c),
                                  sparse.make_sparse_phase(other[c]))
        return run_updates(blocks, atoms.chain(c), M[c], (), temp, budget,
                           consts, chain_mass, model=model,
                           max_sweeps=max_sweeps)

    outs = plain_chains(one, rand, n_steps, consts.batch, mass, M.device)
    return (stack_atoms([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]), *stack_counts(outs, M.device))


# ----------------------------------------------------------------------
# the kernel's per-part time (csrc/atlas.cu: block 0 reads %globaltimer
# at the grid barriers), summed over launches on each device
# ----------------------------------------------------------------------
_PART_NS: dict = {}


def _part_ns(device) -> torch.Tensor:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = str(device)
    if key not in _PART_NS:
        _PART_NS[key] = torch.zeros(4, dtype=torch.int64, device=device)
    return _PART_NS[key]


def part_times(device) -> dict:
    """Nanoseconds in parts (a), (b) and (c) (each up to the end of the
    barrier that follows it), and the sweeps, of every launch on
    `device` since the last reset_part_times."""
    a, b, c, sweeps = _part_ns(device).tolist()
    return {"a_ns": a, "b_ns": b, "c_ns": c, "sweeps": sweeps}


def reset_part_times(device) -> None:
    _part_ns(device).zero_()


def _run_kernel(atoms, M, csr, other, temp, n_steps, consts, mass, rand,
                s_max, max_sweeps):
    NCH, NR, K = M.shape
    m = other.shape[1]
    dev = M.device
    if K > MAX_K:
        raise ValueError(f"the CSR sweep kernel takes k <= {MAX_K}, not {K}")
    st = KernelState.make(atoms, M, consts, mass, n_steps)
    cuda_build.check("other", other, torch.float32, (NCH, m, K), dev)
    cuda_build.check("csr.indptr", csr.indptr, torch.int64, (NCH, NR + 1),
                     dev)
    nnz = csr.idx.shape[0]
    cuda_build.check("csr.idx", csr.idx, torch.int32, (nnz,), dev)
    cuda_build.check("csr.val", csr.val, torch.float32, (nnz,), dev)
    # Z2 and canUseGibbs from the frozen partner factor, as the plain
    # version's make_sparse_phase forms them
    phase = sparse.make_sparse_phase(other)
    Z2 = phase.Z2.contiguous()
    colnz = phase.col_nz.to(torch.int32)
    lib, _ = build()
    # item slots a chain: two row passes a lane, each of at most
    # ceil(longest row / CHUNK) items
    cap = 2 * consts.batch * max(1, -(-csr.max_row_len() // CHUNK))
    work = torch.empty(int(lib.cogaps_atlas_workspace(NCH, cap)),
                       dtype=torch.uint8, device=dev)
    timing = _part_ns(dev)

    def launch(budget_t, uni, s_lim, key0, key1, stream):
        err = lib.cogaps_atlas_launch(
            NCH, consts.batch, consts.capacity, NR, K, m,
            int(consts.local_moves), float(consts.alpha * consts.n_bins),
            float(consts.domain_length), float(temp),
            mass.lam.data_ptr(), mass.max_gibbs_mass.data_ptr(),
            budget_t.data_ptr(), st.mass.data_ptr(), st.elem.data_ptr(),
            st.n.data_ptr(), st.M.data_ptr(), other.data_ptr(),
            Z2.data_ptr(), csr.indptr.data_ptr(), csr.idx.data_ptr(),
            csr.val.data_ptr(), colnz.data_ptr(), st.scratch.data_ptr(),
            st.out.data_ptr(), uni.data_ptr() if uni is not None else None,
            s_lim, key0.data_ptr() if key0 is not None else None, key1,
            CHUNK, cap, work.data_ptr(), timing.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"atlas kernel launch failed: CUDA error {err}")
        run_updates_atlas_multi.launches += 1

    done, n_sweeps, counts = drive(launch, st, n_steps, consts.batch, rand,
                                   s_max, max_sweeps)
    return st.atoms(), st.M, done, n_sweeps, counts


# ----------------------------------------------------------------------
# plain versions of the kernel's decomposition
# ----------------------------------------------------------------------
def work_items_plain(indptr: torch.Tensor, r1: torch.Tensor,
                     r2: torch.Tensor, chunk: int = CHUNK):
    """The kernel's work schedule (part (a) of csrc/atlas.cu). indptr:
    (NCH, NR + 1) CSR offsets; r1: (NCH, B) each lane's row, -1 for a
    lane not kept; r2: (NCH, B) a pair's second row, -1 for none. A
    kept lane passes over row r1, then over r2 when that differs; a pass
    is cut into chunks of at most `chunk` nonzeros, at least one (empty
    for an empty row).

    Returns (items, first, count): items (n, 5) int64 rows (chain, lane,
    row, start, end) in the kernel's order (chain by chain, lane by
    lane, r1's chunks before r2's), and (NCH, B) each lane's first item
    within its chain and its number of items."""
    NCH, B = r1.shape
    rows = torch.stack([r1, r2], -1).to(torch.int64)  # (NCH, B, 2)
    used = torch.stack([r1 >= 0, (r1 >= 0) & (r2 >= 0) & (r2 != r1)], -1)
    chain = torch.arange(NCH)[:, None, None].expand_as(rows)
    lane = torch.arange(B)[None, :, None].expand_as(rows)
    safe = torch.where(used, rows, 0)
    indptr = indptr.to(torch.int64)
    start = indptr[chain, safe]
    end = indptr[chain, safe + 1]
    n = torch.where(used, torch.clamp((end - start + chunk - 1) // chunk,
                                      min=1), 0)
    count = n.sum(-1)
    first = torch.cumsum(count, -1) - count
    n = n.reshape(-1)
    pas = torch.repeat_interleave(torch.arange(n.numel()), n)
    j = torch.arange(pas.numel()) - (torch.cumsum(n, 0) - n)[pas]
    s = start.reshape(-1)[pas] + j * chunk
    e = torch.minimum(s + chunk, end.reshape(-1)[pas])
    items = torch.stack([chain.reshape(-1)[pas], lane.reshape(-1)[pas],
                         rows.reshape(-1)[pas], s, e], 1)
    return items, first, count


def alpha_chunked_plain(csr: sparse.CsrMatrix, c: int,
                        phase: sparse.SparsePhase, M: torch.Tensor,
                        addr: AddrBatch,
                        chunk: int = CHUNK) -> dense.AlphaBatch:
    """alphaParameters of every lane by the kernel's decomposition, on
    chain c's rows: each lane a pair (rows r1 and r2; a same-row pair
    when they are equal), its passes cut into work_items_plain's chunks;
    each chunk's eight sums over its nonzeros (csrc/atlas.cu::item_pass;
    a pass over r2 gives a[4:8]), the chunks of a lane added in chunk
    order, then the Z2-side dots and the closed forms as part (c) forms
    them."""
    r1, c1, r2, c2 = (x.to(torch.int64) for x in addr)
    one = csr.chain(c) if csr.n_chains > 1 or c else csr
    B = r1.shape[0]
    other = phase.other
    items, first, count = work_items_plain(one.indptr.cpu(), r1[None].cpu(),
                                           r2[None].cpu(), chunk)
    items, first, count = (x.to(M.device) for x in (items, first[0],
                                                    count[0]))
    lane, row, st, en = items[:, 1], items[:, 2], items[:, 3], items[:, 4]
    second = row != r1[lane]
    same = (r2 == r1)[lane] & ~second
    # every nonzero of every item, with its item
    n_nz = en - st
    it = torch.repeat_interleave(torch.arange(len(items), device=M.device),
                                 n_nz)
    pos = st[it] + torch.arange(len(it), device=M.device) - (
        torch.cumsum(n_nz, 0) - n_nz)[it]
    o = other[one.idx[pos].to(torch.int64)]  # (N, k)
    d = one.val[pos]
    ap = (o * M[row[it]]).sum(dim=-1)
    col = torch.where(second, c2[lane], c1[lane])[it]
    ar = torch.arange(len(it), device=M.device)
    v = o[ar, col]
    t1 = v / d
    terms = [v * v, t1 * t1, t1 + (v - t1 / d) * ap, t1 + (v + t1 / d) * ap]
    v12 = o[ar, c2[lane][it]]
    dr = torch.reciprocal(d)
    w = 1.0 - dr * dr
    vdiff = v - v12
    vdr = vdiff * dr
    pair_terms = [vdiff * vdiff, vdr * vdr, vdiff * (ap * w + dr),
                  (v + v12) * (ap * (1.0 + dr * dr) + dr)]
    zero = torch.zeros_like(v)
    sm = same[it]
    terms = torch.stack(terms + [torch.where(sm, x, zero)
                                 for x in pair_terms], 1)  # (N, 8)
    sums = torch.zeros((len(items), 8), dtype=M.dtype, device=M.device)
    sums.index_add_(0, it, terms)
    sums = torch.where(second[:, None], torch.cat(
        [torch.zeros_like(sums[:, :4]), sums[:, :4]], 1), sums)
    acc = torch.zeros((B, 8), dtype=M.dtype, device=M.device)
    for t in range(int(count.max()) if B else 0):  # chunk order
        k_t = torch.clamp(first + t, max=len(items) - 1)
        acc = acc + torch.where((t < count)[:, None], sums[k_t],
                                torch.zeros_like(acc))
    a = acc.T
    Z2 = phase.Z2
    zc1, zc2 = Z2[:, c1].T, Z2[:, c2].T  # (B, k)
    z0 = (M[r1] * zc1).sum(dim=-1)
    pair_same = r1 == r2
    z1 = torch.where(pair_same, (M[r1] * (zc1 - zc2)).sum(dim=-1),
                     (M[r2] * zc2).sum(dim=-1))
    z2 = (M[r1] * (zc1 + zc2)).sum(dim=-1)
    z1c1, z1c2 = Z2[c1, c1], Z2[c2, c2]
    eps = sparse.NOISE_EPS
    s1 = torch.clamp(z1c1 - a[0], min=0.0) + a[1]
    smu1 = -z0 + a[2]
    err1 = eps * (z0 + a[3])
    s_zero = z1c1 - 2.0 * Z2[c1, c2] + z1c2 - a[4]
    s_same = torch.clamp(s_zero, min=0.0) + a[5]
    smu_same = -z1 + a[6]
    err_same = eps * (z2 + a[7])
    s2 = torch.clamp(z1c2 - a[4], min=0.0) + a[5]
    smu2 = -z1 + a[6]
    err2 = eps * (z1 + a[7])
    s_pair = torch.where(pair_same, s_same, s1 + s2)
    smu_pair = torch.where(pair_same, smu_same, smu1 - smu2)
    err_pair = torch.where(pair_same, err_same, err1 + err2)
    beta = sparse.BETA
    return dense.AlphaBatch(s1=beta * s1, smu1=beta * smu1,
                            s_pair=beta * s_pair, smu_pair=beta * smu_pair,
                            err1=beta * err1, err_pair=beta * err_pair)


def chunked_model(csr: sparse.CsrMatrix, c: int, phase: sparse.SparsePhase,
                  chunk: int = CHUNK) -> sparse.SparseModel:
    """models/sparse.make_model's sweep adapter with alphaParameters by
    alpha_chunked_plain."""

    def alpha(mstate, M, addr):
        del mstate
        return alpha_chunked_plain(csr, c, phase, M, addr, chunk)

    return sparse.SparseModel(col_nz=phase.col_nz.to(torch.float32),
                              alpha=alpha, apply=lambda mstate, upd: mstate)
