"""Sparse normal data model — the PyTorch counterpart of
cogaps_tpu/models/sparse.py (reference: src/gibbs_sampler/
SparseNormalModel.{h,cpp}).

The sparse sampler assumes the implied uncertainty S = 0.1*d on the
nonzeros and S = 0.1 on the zeros (beta = 1/0.1^2), so every likelihood
reduction splits into all-element terms over the frozen partner factor
(Z1[c] = sum other[:, c]^2, Z2 = other^T other) plus corrections over
the nonzeros of the data row (the module docstring of
cogaps_tpu/models/sparse.py derives them):

    s    = beta * ( [Z1[c] - sum_nz v^2]_+ + sum_nz (v/d)^2 )
    s_mu = beta * ( -M[r] . Z2[:, c] + sum_nz (v/d + (v - (v/d)/d) ap) )

with v = other[j, c], d the nonzero and ap = other[j] . M[r]. The
regroupings that keep these stable in float32, and the noise floors
that refuse a Gibbs draw whose s_mu is rounding noise, are kept exactly.

Three ways to run the model (sparse_engine.py):

* make_model — the plain sparse sweep over padded ELL rows, the plain
  version of the CSR sweep kernel (csrc/atlas.cu);
* kernel_tables / kernel_tables_ell — (SQ, Y0, G) tables that let the
  dense sweep kernel (csrc/sweep.cu) evaluate the same closed forms, with
  G in the Z table's place (zero noise floors, as the JAX tables path);
* CsrMatrix — the nonzeros of each row in CSR order, the layout the CSR
  sweep kernel and the closed-form chi^2 read.

Matrix products go through torch.matmul in full float32 (the package
turns TF32 off at import).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .dense import AlphaBatch

BETA = 100.0  # 1/0.1^2 (reference: SparseNormalModel.h:77)
# float32 noise floor per unit of absolute-value accumulation
# (cogaps_tpu/models/sparse.NOISE_EPS)
NOISE_EPS = 1.0e-6


class EllMatrix(NamedTuple):
    """Padded row-major sparse layout: idx[r, :] are the column indices
    of row r's nonzeros (-1 padded), val[r, :] their values (0 padded)."""

    idx: torch.Tensor  # (n_rows, L) int32
    val: torch.Tensor  # (n_rows, L) float32


def to_ell(D: np.ndarray) -> EllMatrix:
    """Dense (rows, cols) -> ELL through the COO path."""
    D = np.asarray(D, np.float32)
    rows, cols = np.nonzero(D)
    return coo_to_ell(rows.astype(np.int32), cols.astype(np.int32),
                      D[rows, cols], D.shape[0])


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_rows: int) -> EllMatrix:
    """COO -> ELL without densifying (cogaps_tpu/models/sparse.coo_to_ell)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    L = max(int(counts.max()) if len(counts) else 0, 1)
    idx = np.full((n_rows, L), -1, np.int32)
    val = np.zeros((n_rows, L), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offsets = np.arange(len(rows)) - starts[rows]
    idx[rows, offsets] = cols
    val[rows, offsets] = vals
    return EllMatrix(idx=torch.from_numpy(idx), val=torch.from_numpy(val))


@dataclasses.dataclass
class CsrMatrix:
    """The nonzeros of NCH chains' data rows in CSR order (sorted by row,
    then column): chain c's row r holds idx/val[indptr[c, r]:
    indptr[c, r + 1]]. idx is the partner row (the column of the data
    matrix in this orientation), val the nonzero d > 0."""

    indptr: torch.Tensor  # (NCH, n_rows + 1) int64, offsets into idx/val
    idx: torch.Tensor  # (nnz,) int32
    val: torch.Tensor  # (nnz,) float32
    _ells: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)
    _max_len: Optional[int] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def n_chains(self) -> int:
        return self.indptr.shape[0]

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[1] - 1

    def to(self, device) -> "CsrMatrix":
        return CsrMatrix(indptr=self.indptr.to(device),
                         idx=self.idx.to(device), val=self.val.to(device))

    def chain(self, c: int) -> "CsrMatrix":
        """Chain c alone, its offsets rebased to 0."""
        lo, hi = (int(x) for x in self.indptr[c, [0, -1]])
        return CsrMatrix(indptr=(self.indptr[c] - lo)[None],
                         idx=self.idx[lo:hi], val=self.val[lo:hi])

    def max_row_len(self) -> int:
        """The most nonzeros of any row of any chain (read from the device
        once, then kept)."""
        if self._max_len is None:
            lengths = self.indptr[:, 1:] - self.indptr[:, :-1]
            self._max_len = int(lengths.max()) if lengths.numel() else 0
        return self._max_len

    def row_ids(self, c: int = 0) -> torch.Tensor:
        """The data row of each of chain c's nonzeros, (nnz_c,) int64."""
        lengths = self.indptr[c, 1:] - self.indptr[c, :-1]
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.idx.device), lengths)

    def ell(self, c: int = 0) -> EllMatrix:
        """Chain c as an EllMatrix of width max row length (the layout
        coo_to_ell gives), built once per chain and kept."""
        if c not in self._ells:
            ptr = self.indptr[c]
            lengths = ptr[1:] - ptr[:-1]
            L = max(int(lengths.max()) if self.n_rows else 0, 1)
            pos = torch.arange(L, device=ptr.device)
            mask = pos < lengths[:, None]
            offs = torch.where(mask, ptr[:-1, None] + pos, 0)
            if self.idx.numel() == 0:
                idx = torch.full(mask.shape, -1, dtype=torch.int32,
                                 device=ptr.device)
                val = torch.zeros(mask.shape, device=ptr.device)
            else:
                idx = torch.where(mask, self.idx[offs], -1)
                val = torch.where(mask, self.val[offs], 0.0)
            self._ells[c] = EllMatrix(idx=idx.to(torch.int32).contiguous(),
                                      val=val.contiguous())
        return self._ells[c]


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_rows: int) -> CsrMatrix:
    """COO -> one chain's CsrMatrix without densifying."""
    return stack_csr([(rows, cols, vals)], n_rows)


def stack_csr(coos, n_rows: int) -> CsrMatrix:
    """Per-chain COO triples -> one CsrMatrix of len(coos) chains, each
    with n_rows rows (a chain with fewer rows has empty tail rows)."""
    indptr = np.zeros((len(coos), n_rows + 1), np.int64)
    idx_parts, val_parts = [], []
    base = 0
    for c, (rows, cols, vals) in enumerate(coos):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        # row-major order (a stable sort is fast on sorted input)
        order = np.argsort(rows * (int(cols.max(initial=0)) + 1) + cols,
                           kind="stable")
        counts = np.bincount(rows, minlength=n_rows)
        indptr[c, 1:] = base + np.cumsum(counts)
        indptr[c, 0] = base
        idx_parts.append(cols[order].astype(np.int32))
        val_parts.append(np.asarray(vals, np.float32)[order])
        base += len(rows)
    cat = (lambda parts, dt: np.concatenate(parts) if parts
           else np.zeros(0, dt))
    return CsrMatrix(indptr=torch.from_numpy(indptr),
                     idx=torch.from_numpy(cat(idx_parts, np.int32)),
                     val=torch.from_numpy(cat(val_parts, np.float32)))


class SparsePhase(NamedTuple):
    """Per-update-call constants from the frozen partner factor
    (reference: SparseNormalModel.cpp:294-311)."""

    Z1: torch.Tensor  # (k,)
    Z2: torch.Tensor  # (k, k)
    other: torch.Tensor  # (m, k) the partner factor
    col_nz: torch.Tensor  # (k,) bool


def make_sparse_phase(other_M: torch.Tensor) -> SparsePhase:
    z2 = torch.matmul(other_M.transpose(-1, -2), other_M)
    return SparsePhase(Z1=torch.diagonal(z2, dim1=-2, dim2=-1), Z2=z2,
                       other=other_M, col_nz=other_M.amax(dim=-2) > 0.0)


def _take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] for a 2-D x and an int64 index of any shape, through
    index_select (advanced indexing with a 2-D index is slow on the
    CPU)."""
    return torch.index_select(x, 0, index.reshape(-1)).reshape(
        index.shape + x.shape[1:])


def _masked_sum(mask, x):
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1)


def _row_terms(ell: EllMatrix, phase: SparsePhase, M: torch.Tensor, r, c):
    """Per-(proposal, nonzero) ingredients for data rows r: the partner
    rows at the nonzeros, the values 1/d-safe, the reconstruction dots
    ap, v = other[j, c], and the single-element (s, s_mu, err) with the
    stable regrouping s = [Z1[c] - sum v^2]_+ + sum (v/d)^2
    (cogaps_tpu/models/sparse._row_terms)."""
    gi = _take_rows(ell.idx, r).to(torch.int64)  # (B, L)
    d = _take_rows(ell.val, r)
    mask = gi >= 0
    o_rows = _take_rows(phase.other, torch.clamp(gi, min=0))  # (B, L, k)
    Mr = M[r]  # (B, k)
    ap = torch.matmul(o_rows, Mr.unsqueeze(-1)).squeeze(-1)  # (B, L)
    v = torch.gather(o_rows, 2, c.view(-1, 1, 1).expand(
        o_rows.shape[0], o_rows.shape[1], 1)).squeeze(-1)
    d_safe = torch.where(mask, d, torch.ones_like(d))
    t1 = v / d_safe
    s_zero = phase.Z1[c] - _masked_sum(mask, v * v)
    s = torch.clamp(s_zero, min=0.0) + _masked_sum(mask, t1 * t1)
    z2_terms = Mr * phase.Z2[:, c].T  # (B, k)
    nnz_terms = t1 + (v - t1 / d_safe) * ap
    smu = -z2_terms.sum(dim=-1) + _masked_sum(mask, nnz_terms)
    # noise floor from the pre-cancellation magnitudes
    nnz_abs = t1 + (v + t1 / d_safe) * ap
    err = NOISE_EPS * (z2_terms.sum(dim=-1) + _masked_sum(mask, nnz_abs))
    return o_rows, d_safe, mask, ap, v, s, smu, err


class SparseModel(NamedTuple):
    """Adapter handed to the plain sweep (ops/sweep.py)."""

    col_nz: torch.Tensor  # (k,) float32 in {0, 1}
    alpha: Callable  # fn(mstate, M, addr) -> AlphaBatch
    apply: Callable  # fn(mstate, upd) -> mstate


def make_model(ell: EllMatrix, phase: SparsePhase) -> SparseModel:
    """The sparse model's sweep adapter (cogaps_tpu/models/sparse.
    make_model): alphaParameters by the closed forms, with the same-row
    pair terms (reference: SparseNormalModel.cpp:242-292) and the noise
    floors; no cache (M is the only mutable state)."""

    def alpha(mstate, M, addr) -> AlphaBatch:
        del mstate
        r1, c1, r2, c2 = addr.r1, addr.c1, addr.r2, addr.c2
        o1, d1, mask1, ap1, v11, s1, smu1, err1 = _row_terms(
            ell, phase, M, r1, c1)
        _, _, _, _, _, s2, smu2, err2 = _row_terms(ell, phase, M, r2, c2)

        # same-row pair: the zero-element part ||col1 - col2||^2 -
        # sum_nz vdiff^2 is >= 0, so it is clamped like _row_terms'
        v12 = torch.gather(o1, 2, c2.view(-1, 1, 1).expand(
            o1.shape[0], o1.shape[1], 1)).squeeze(-1)
        dr = torch.reciprocal(d1)
        w = 1.0 - dr * dr
        vdiff = v11 - v12
        Z2 = phase.Z2
        z2d = Z2[:, c1].T - Z2[:, c2].T  # (B, k)
        s_same_zero = (phase.Z1[c1] - 2.0 * Z2[c1, c2] + phase.Z1[c2]
                       - _masked_sum(mask1, vdiff * vdiff))
        vdr = vdiff * dr
        s_same = torch.clamp(s_same_zero, min=0.0) + _masked_sum(
            mask1, vdr * vdr)
        z2d_terms = M[r1] * z2d
        same_nnz = vdiff * (ap1 * w + dr)
        smu_same = -z2d_terms.sum(dim=-1) + _masked_sum(mask1, same_nnz)
        # pre-cancellation magnitudes of z2d, w and vdiff
        z2d_abs = M[r1] * (Z2[:, c1].T + Z2[:, c2].T)
        same_abs = (v11 + v12) * (ap1 * (1.0 + dr * dr) + dr)
        err_same = NOISE_EPS * (z2d_abs.sum(dim=-1)
                                + _masked_sum(mask1, same_abs))
        same = r1 == r2
        s_pair = torch.where(same, s_same, s1 + s2)
        smu_pair = torch.where(same, smu_same, smu1 - smu2)
        err_pair = torch.where(same, err_same, err1 + err2)
        return AlphaBatch(s1=BETA * s1, smu1=BETA * smu1,
                          s_pair=BETA * s_pair, smu_pair=BETA * smu_pair,
                          err1=BETA * err1, err_pair=BETA * err_pair)

    def apply(mstate, upd):
        return mstate  # no cache (reference: extraInitialization is a nop)

    return SparseModel(col_nz=phase.col_nz.to(torch.float32), alpha=alpha,
                       apply=apply)


# ----------------------------------------------------------------------
# tables that make the dense sweep kernel evaluate the sparse closed
# forms (cogaps_tpu/models/sparse.py:209-224):
#   G[r, c, c'] = beta * ( Z2[c, c'] - sum_nz v_c v_c' (1 - 1/d^2) )
#   s(r, c)     = G[r, c, c]
#   s_mu(r, c)  = beta * sum_nz v_c/d  -  sum_c' M[r, c'] G[r, c, c']
# G plays the dense model's Z role: an accepted change (r, c0, delta)
# shifts s_mu(r, c) by -delta * G[r, c, c0], the kernel's Y update.
# ----------------------------------------------------------------------
def dense_weights(csr: CsrMatrix, n_cols: int):
    """Dense weight matrices of every chain for kernel_tables:
    Wd[r, i] = 1 - 1/d^2 at the nonzeros (0 elsewhere), D1[r, i] = 1/d;
    (NCH, n_rows, n_cols) each, built on the host as
    cogaps_tpu/models/sparse.dense_weights builds them."""
    NCH, NR = csr.n_chains, csr.n_rows
    Wd = np.zeros((NCH, NR, n_cols), np.float32)
    D1 = np.zeros((NCH, NR, n_cols), np.float32)
    for c in range(NCH):
        one = csr.chain(c)
        rows = one.row_ids().cpu().numpy()
        cols = one.idx.cpu().numpy()
        vals = one.val.cpu().numpy()
        Wd[c, rows, cols] = 1.0 - 1.0 / (vals * vals)
        D1[c, rows, cols] = 1.0 / vals
    return torch.from_numpy(Wd), torch.from_numpy(D1)


def _gram(other: torch.Tensor) -> torch.Tensor:
    """other[i, c] * other[i, c'] as (..., m, k*k)."""
    m, k = other.shape[-2:]
    return (other.unsqueeze(-1) * other.unsqueeze(-2)).reshape(
        other.shape[:-2] + (m, k * k))


def _tables_from(U: torch.Tensor, T4: torch.Tensor, other: torch.Tensor,
                 M: torch.Tensor):
    k = other.shape[-1]
    NR = U.shape[-2]
    Z2 = torch.matmul(other.transpose(-1, -2), other)
    G = BETA * (Z2.unsqueeze(-3) - U.reshape(U.shape[:-1] + (k, k)))
    SQ = torch.diagonal(G, dim1=-2, dim2=-1).contiguous()
    Y0 = BETA * T4 - (M.unsqueeze(-2) * G).sum(dim=-1)
    return SQ, Y0, G.reshape(G.shape[:-3] + (NR * k, k))


def kernel_tables(Wd: torch.Tensor, D1: torch.Tensor, other: torch.Tensor,
                  M: torch.Tensor):
    """(SQ, Y0, G_flat) of one update call from the dense weights, with
    any leading chain shape (other = the frozen partner factor, M = the
    sampled factor at call start)."""
    U = torch.matmul(Wd, _gram(other))  # (..., NR, k*k)
    T4 = torch.matmul(D1, other)
    return _tables_from(U, T4, other, M)


# float32 elements of the (rows, L, k*k) gather transient of one chunk
_ELL_CHUNK_ELEMS = 1 << 26


def kernel_tables_ell(ell: EllMatrix, other: torch.Tensor, M: torch.Tensor,
                      row_chunk: int = 0):
    """The same tables from the ELL rows of one chain, without dense
    weights (cogaps_tpu/models/sparse.kernel_tables_ell): U[r] = sum_nz
    (1 - 1/d^2) oo[idx], T4[r] = sum_nz (1/d) other[idx], gathered in
    row chunks so the (chunk, L, k^2) transient stays bounded
    (`row_chunk` 0 sizes it to _ELL_CHUNK_ELEMS)."""
    NR, L = ell.idx.shape
    k = other.shape[-1]
    oo = _gram(other)
    if row_chunk <= 0:
        row_chunk = max(1, _ELL_CHUNK_ELEMS // max(L * k * k, 1))
    U_parts, T4_parts = [], []
    for lo in range(0, NR, row_chunk):
        idx_c = ell.idx[lo:lo + row_chunk].to(torch.int64)
        val_c = ell.val[lo:lo + row_chunk]
        mask = idx_c >= 0
        d = torch.where(mask, val_c, torch.ones_like(val_c))
        zero = torch.zeros_like(d)
        w = torch.where(mask, 1.0 - torch.reciprocal(d * d), zero)
        dr = torch.where(mask, torch.reciprocal(d), zero)
        gi = torch.clamp(idx_c, min=0)
        U_parts.append(torch.matmul(w.unsqueeze(-2),
                                    _take_rows(oo, gi)).squeeze(-2))
        T4_parts.append(torch.matmul(dr.unsqueeze(-2),
                                     _take_rows(other, gi)).squeeze(-2))
    return _tables_from(torch.cat(U_parts), torch.cat(T4_parts), other, M)


# nonzeros per chunk of the closed-form chi^2 (a (chunk, k) gather each
# side)
_CHISQ_CHUNK = 1 << 21


def sparse_chisq(csr: CsrMatrix, M_a: torch.Tensor, M_p: torch.Tensor,
                 chain: int = 0) -> torch.Tensor:
    """Closed-form chi^2 of one chain from its gene-major CSR rows
    (reference: SparseNormalModel.cpp:39-60), regrouped for float32
    stability as cogaps_tpu/models/sparse.sparse_chisq:
        chi^2/beta = [<Z2a, Z2p> - sum_nz dot^2]_+ + sum_nz (1 - dot/d)^2
    with dot = M_a[gene] . M_p[sample]. Never densifies: the nonzeros go
    in chunks of _CHISQ_CHUNK."""
    one = csr.chain(chain) if csr.n_chains > 1 or chain else csr
    all_term = (torch.matmul(M_a.T, M_a) * torch.matmul(M_p.T, M_p)).sum()
    rows = one.row_ids()
    sq = torch.zeros((), dtype=M_a.dtype, device=M_a.device)
    nnz_part = torch.zeros_like(sq)
    for lo in range(0, one.idx.numel(), _CHISQ_CHUNK):
        hi = lo + _CHISQ_CHUNK
        dot = (_take_rows(M_a, rows[lo:hi])
               * _take_rows(M_p, one.idx[lo:hi].to(torch.int64))).sum(dim=-1)
        sq = sq + (dot * dot).sum()
        r = 1.0 - dot / one.val[lo:hi]
        nnz_part = nnz_part + (r * r).sum()
    return BETA * (torch.clamp(all_term - sq, min=0.0) + nnz_part)


def sparsity(D: np.ndarray) -> float:
    return float((np.asarray(D) == 0).mean())
