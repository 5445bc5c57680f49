"""Dense normal data model — the PyTorch counterpart of
cogaps_tpu/models/dense.py (reference: src/gibbs_sampler/
DenseNormalModel.{h,cpp}).

Within one update call the partner factor is frozen, so every reduction
over the data dimension collapses into small tables gathered per
proposal (the module docstring of cogaps_tpu/models/dense.py derives
them):

  * s      = SQ[r, c]          SQ = invS2 @ other^2
  * s_mu   = Y[r, c]           Y  = ((D - M other^T) * invS2) @ other
  * pair x = Z[r*k + c, c']    Z[r,c,c'] = sum_i o_ic o_ic' invS2[r,i]

Y is kept up to date across sweeps by Y[r, :] -= delta * Z[r*k + c, :].
Every function takes tensors with any leading (chain) shape. On the card
`tables` builds an update call's tables in one launch of the tables
kernel (ops/tables_cuda.py, csrc/tables.cu); the plain version and
exact_tables run through torch.matmul in full float32 or float64 (the
package turns TF32 off at import: Y is formed with heavy cancellation).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..ops import tables_cuda


@dataclasses.dataclass
class DenseCache:
    """The conditional-mean table Y = R @ other of one update call (the
    analog of the reference's AP cache, DenseNormalModel.h:60)."""

    Y: torch.Tensor  # (..., n_rows, k) float32


class DensePhase(NamedTuple):
    """Per-update-call tables from the frozen partner factor
    (DenseNormalModel.cpp:20-36)."""

    SQ: torch.Tensor  # (..., n_rows, k)
    Z: torch.Tensor  # (..., n_rows * k, k)
    col_nz: torch.Tensor  # (..., k) bool — canUseGibbs per column


class AlphaBatch(NamedTuple):
    """Batched alphaParameters with their float32 noise floors: a Gibbs
    draw whose |s_mu| is not above its floor is refused
    (cogaps_tpu/models/dense.AlphaBatch). The dense model's floors are
    0; the sparse model's are not (models/sparse.py)."""

    s1: torch.Tensor
    smu1: torch.Tensor
    s_pair: torch.Tensor
    smu_pair: torch.Tensor
    err1: torch.Tensor | float = 0.0
    err_pair: torch.Tensor | float = 0.0


def default_uncertainty(D: np.ndarray) -> np.ndarray:
    """S = pmax(0.1*D, 0.1) (reference: DenseNormalModel.h:73) — a copy
    of cogaps_tpu/models/dense.default_uncertainty."""
    return np.maximum(0.1 * D, 0.1).astype(np.float32)


def compute_lambda(D: np.ndarray, alpha: float, n_patterns: int) -> float:
    """lambda = alpha*sqrt(k/meanNonZero(D)) (reference: DenseNormalModel.h:
    79-80) — a copy of cogaps_tpu/models/dense.compute_lambda."""
    nz = D[D != 0]
    mean_nz = float(nz.mean()) if nz.size else 1.0
    return float(alpha) * float(np.sqrt(n_patterns / mean_nz))


def make_phase(invS2: torch.Tensor, other_M: torch.Tensor) -> DensePhase:
    k = other_M.shape[-1]
    m = other_M.shape[-2]
    sq = torch.matmul(invS2, other_M * other_M)
    oo = (other_M.unsqueeze(-1) * other_M.unsqueeze(-2)).reshape(
        other_M.shape[:-2] + (m, k * k))
    z = torch.matmul(invS2, oo)
    return DensePhase(
        SQ=sq,
        Z=z.reshape(invS2.shape[:-2] + (invS2.shape[-2] * k, k)),
        col_nz=other_M.amax(dim=-2) > 0.0)


def residual(D, invS2, M, other_M):
    """Weighted residual R = (D - M other^T) * invS2 (the analog of
    extraInitialization's AP rebuild, DenseNormalModel.cpp:38-54)."""
    return (D - torch.matmul(M, other_M.transpose(-1, -2))) * invS2


def rebuild_cache(D, invS2, M, other_M) -> DenseCache:
    """Y = R @ other at the start of an update call."""
    return DenseCache(Y=torch.matmul(residual(D, invS2, M, other_M), other_M))


def tables_plain(D, invS2, M, other_M) -> Tuple[DenseCache, DensePhase]:
    """The tables of one update call of the sampler of M by matrix
    products: the plain version of the tables kernel (ops/tables_cuda.py),
    and the body of exact_tables."""
    return rebuild_cache(D, invS2, M, other_M), make_phase(invS2, other_M)


def tables(D, invS2, M, other_M) -> Tuple[DenseCache, DensePhase]:
    """The tables of one update call of the sampler of M, in float32:
    float32 CUDA tensors go to the tables kernel (ops/tables_cuda.
    dense_tables: one launch, each chain's sums in an order of its own
    shape alone), CPU tensors to tables_plain; anything else raises."""
    args = (D, invS2, M, other_M)
    devices = {x.device for x in args}
    if all(x.device.type == "cpu" for x in args):
        return tables_plain(*args)
    if (len(devices) == 1 and D.device.type == "cuda"
            and all(x.dtype == torch.float32 for x in args)):
        Y, SQ, Z, col_nz = tables_cuda.dense_tables(*args)
        return DenseCache(Y=Y), DensePhase(SQ=SQ, Z=Z, col_nz=col_nz)
    raise ValueError(
        "no tables for tensors on " + ", ".join(sorted(map(str, devices)))
        + " of " + ", ".join(sorted({str(x.dtype) for x in args}))
        + ": the kernel takes float32 on one CUDA device, the plain "
        "version CPU tensors")


def exact_tables(D, invS2, M, other_M) -> Tuple[DenseCache, DensePhase]:
    """The same tables under the rule of the fused-span kernel
    (csrc/span.cu): every entry is a float64 sum over the float32
    operands, rounded once to float32. Products of two floats are exact
    in float64, so the kernel's summation order and this one's meet the
    same float32 value unless a sum lies within a few float64 ulps of a
    float32 rounding boundary. The per-call route keeps `tables`: on an
    H100 this rule made its 5000x2000 iteration 36% slower
    (profile_iter), where the fused span does not apply."""
    cache, phase = tables_plain(*(x.double()
                                  for x in (D, invS2, M, other_M)))
    return (DenseCache(Y=cache.Y.float()),
            DensePhase(SQ=phase.SQ.float(), Z=phase.Z.float(),
                       col_nz=phase.col_nz))


def alpha_batch(cache: DenseCache, phase: DensePhase, addr) -> AlphaBatch:
    """alphaParameters for B proposals of one chain: flat gathers from
    the SQ/Y/Z tables (cogaps_tpu/models/dense.alpha_batch)."""
    k = phase.SQ.shape[-1]
    SQ_flat = phase.SQ.reshape(-1)
    Y_flat = cache.Y.reshape(-1)
    e1 = addr.r1 * k + addr.c1
    e2 = addr.r2 * k + addr.c2
    s1 = SQ_flat[e1]
    s2 = SQ_flat[e2]
    smu1 = Y_flat[e1]
    smu2 = Y_flat[e2]
    same_row = (addr.r1 == addr.r2).to(torch.float32)
    x = phase.Z.reshape(-1)[e1 * k + addr.c2]
    return AlphaBatch(s1=s1, smu1=smu1, s_pair=s1 + s2 - 2.0 * x * same_row,
                      smu_pair=smu1 - smu2)


def apply_updates(cache: DenseCache, phase: DensePhase, upd) -> DenseCache:
    """Y[r, :] -= delta * Z[r, c, :] for each applied matrix change — the
    conditional-mean form of updateAPMatrix (DenseNormalModel.cpp:
    243-258). `upd` holds the two streams of one sweep, (rows, cols,
    deltas) each of shape (2B,): stream 1 in [0, B), stream 2 in
    [B, 2B). Each stream is added on its own, stream 1 first, so that a
    lane touching one row twice adds in the order the kernel does; rows
    are disjoint across lanes, and lanes that apply nothing add 0."""
    k = phase.SQ.shape[-1]
    Y = cache.Y.clone()
    B = upd.rows.shape[0] // 2
    for lo in (0, B):
        rows = upd.rows[lo:lo + B]
        zrows = phase.Z[rows * k + upd.cols[lo:lo + B]]
        Y.index_add_(0, rows, -upd.deltas[lo:lo + B, None] * zrows)
    return DenseCache(Y=Y)


class DenseModel(NamedTuple):
    """Adapter handed to the plain sweep (ops/sweep.py)."""

    col_nz: torch.Tensor  # (k,) float32 in {0, 1}
    alpha: Callable  # fn(mstate, M, addr) -> AlphaBatch
    apply: Callable  # fn(mstate, upd) -> mstate


def make_model(phase: DensePhase) -> DenseModel:
    def alpha(mstate: DenseCache, M, addr):
        del M  # the dense model reads the Y table, not M
        return alpha_batch(mstate, phase, addr)

    def apply(mstate: DenseCache, upd):
        return apply_updates(mstate, phase, upd)

    return DenseModel(col_nz=phase.col_nz.to(torch.float32), alpha=alpha,
                      apply=apply)


def _slabs(like, lead, shape, x=None) -> tuple:
    """A (chains, P) buffer of like's type and device, P the size of
    `shape` rounded up to 64 entries, whose row c starts with chain c of
    x broadcast to lead + shape (unset where x is None) and ends in
    zeros: each chain starts on a 256-byte boundary, as a tensor of its
    own does, so a library call on one chain takes the path it takes
    alone. Returns (the buffer, its per-chain (shape) views)."""
    size = math.prod(shape)
    buf = torch.empty((math.prod(lead), -(-max(size, 1) // 64) * 64),
                      dtype=like.dtype, device=like.device)
    buf[:, size:].zero_()
    if x is not None:
        buf[:, :size].view(lead + tuple(shape)).copy_(x)
    return buf, [row[:size].view(shape) for row in buf]


def chisq_from_state(D, invS2, M_a, M_p) -> torch.Tensor:
    """chi^2 = sum ((D-AP)/S)^2 = sum R^2 / invS2 over the last two dims
    (reference: DenseNormalModel.cpp:56-68), for any leading (chain)
    shape. The two sums, A P^T and the total, run a chain at a time on
    the chain's own aligned slab (_slabs), so a chain's chi^2 is the same
    bits alone and beside other chains: a batched product or reduction
    sums in an order the library picks by the chain count, and a chain's
    slice of a batch in one it picks by the slice's alignment. The
    elementwise work, which has no order, runs batched."""
    lead = torch.broadcast_shapes(D.shape[:-2], invS2.shape[:-2],
                                  M_a.shape[:-2], M_p.shape[:-2])
    (n_rows, m), k = D.shape[-2:], M_a.shape[-1]
    _, a = _slabs(M_a, lead, (n_rows, k), M_a)
    _, p = _slabs(M_a, lead, (m, k), M_p)
    ap, AP = _slabs(M_a, lead, (n_rows, m))
    for c in range(len(AP)):
        torch.matmul(a[c], p[c].transpose(0, 1), out=AP[c])
    R = (D - ap[:, :n_rows * m].view(lead + (n_rows, m))) * invS2
    w, _ = _slabs(M_a, lead, (n_rows, m))
    torch.where(invS2 > 0, R * R / invS2, torch.zeros((), dtype=R.dtype,
                                                      device=R.device),
                out=w[:, :n_rows * m].view(lead + (n_rows, m)))
    return torch.stack([row.sum() for row in w]).reshape(lead)
