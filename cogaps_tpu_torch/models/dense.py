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
Every function takes tensors with any leading (chain) shape; the
matrix products run through torch.matmul in full float32 (the package
turns TF32 off at import: Y is formed with heavy cancellation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch


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
    """Batched alphaParameters. The dense model's noise floors are 0
    (cogaps_tpu/models/dense.AlphaBatch)."""

    s1: torch.Tensor
    smu1: torch.Tensor
    s_pair: torch.Tensor
    smu_pair: torch.Tensor


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


def chisq_from_state(D, invS2, M_a, M_p) -> torch.Tensor:
    """chi^2 = sum ((D-AP)/S)^2 = sum R^2 / invS2 over the last two dims
    (reference: DenseNormalModel.cpp:56-68)."""
    R = residual(D, invS2, M_a, M_p)
    return torch.where(invS2 > 0, R * R / invS2,
                       torch.zeros_like(R)).sum(dim=(-2, -1))
