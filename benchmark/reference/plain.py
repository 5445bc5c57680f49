"""The plain reference of the CoGAPS sampler's deterministic quantities,
in float64 PyTorch (or in the control's precision), from the inputs the
benchmark made. It imports nothing of cogaps_tpu_torch or JAX.

- subsets: the uniform partition of R/SubsetData.R:63-75 as the port
  draws it (numpy's default_rng(seed): nSets - 1 draws without
  replacement of n // nSets indices, the rest last), worked out again;
- the dense model (src/gibbs_sampler/DenseNormalModel.{h,cpp}): S =
  max(0.1 D, 0.1), chi^2 = sum ((D - A P^T) / S)^2 and an update call's
  tables Y = ((D - M O^T) / S^2) O, SQ = (1 / S^2) O^2,
  Z[r, c, c'] = sum_i O[i, c] O[i, c'] / S[r, i]^2;
- a factor from its atoms: M[row, col] = the sum of the masses of the
  live atoms at element row * k + col;
- the posterior statistics' terms of one iteration (GapsStatistics.h:
  130-185): norm = each pattern's maximum over P's rows (1 where it is
  0), P / norm and A * norm.

Precision: "float64" is the reference. "tf32" is the control, the same
arithmetic one precision below the configuration's float32 with TF32
off: every operand of a product or a sum rounded to TF32 (10 fraction
bits, to nearest), the products and sums in float32, as the tensor
cores' TF32 mode computes them.
"""

from __future__ import annotations

import numpy as np
import torch


def subsets(n_total: int, n_sets: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    size = n_total // n_sets
    remaining = np.arange(n_total)
    sets = []
    for _ in range(n_sets - 1):
        sel = rng.choice(remaining, size=size, replace=False)
        sets.append(np.sort(sel))
        remaining = np.setdiff1d(remaining, sel)
    sets.append(np.sort(remaining))
    return sets


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 fraction bits, to nearest."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


class Arith:
    """The reference's arithmetic: float64, or the control's TF32."""

    def __init__(self, precision: str, device):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.control = precision == "tf32"
        self.dtype = torch.float32 if self.control else torch.float64
        self.device = torch.device(device)

    def t(self, x) -> torch.Tensor:
        """An operand: to the device in the arithmetic's type."""
        x = (x.to(self.device) if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x), device=self.device))
        return tf32(x) if self.control else x.to(torch.float64)

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An intermediate result entering a product or a sum."""
        return tf32(x) if self.control else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))


def chain_matrix(D: np.ndarray, idx: np.ndarray, genome_wide: bool,
                 shape: tuple) -> np.ndarray:
    """Chain data: the subset's rows (genome-wide) or columns of D, zero
    padded to the stacked chains' (genes, samples)."""
    sub = D[idx, :] if genome_wide else D[:, idx]
    out = np.zeros(shape, np.float32)
    out[:sub.shape[0], :sub.shape[1]] = sub
    return out


def dense_weights(D: np.ndarray, true_shape: tuple) -> np.ndarray:
    """1/S^2 with S = max(0.1 D, 0.1) on the subset, 0 on the padding."""
    S = np.maximum(0.1 * D, 0.1)
    W = 1.0 / (S.astype(np.float64) ** 2)
    W[true_shape[0]:, :] = 0.0
    W[:, true_shape[1]:] = 0.0
    return W


def dense_chisq(ar: Arith, D, W, A, P) -> float:
    R = ar.t(D) - ar.mm(ar.t(A), ar.t(P).T)
    w = ar.t(W)
    return float(torch.sum(ar.r(R * R) * w))


def dense_tables(ar: Arith, D, W, M, O) -> tuple:
    """(Y, SQ, Z) and the scale of each entry's terms, sum |term|."""
    D, W, M, O = ar.t(D), ar.t(W), ar.t(M), ar.t(O)
    k = O.shape[1]
    oo = (O[:, :, None] * O[:, None, :]).reshape(O.shape[0], k * k)
    R = (D - ar.mm(M, O.T)) * W
    Y = ar.mm(R, O)
    SQ = ar.mm(W, ar.r(O * O))
    Z = ar.mm(W, ar.r(oo)).reshape(-1, k)
    f = torch.float64
    scale_Y = ((D.to(f).abs() + M.to(f) @ O.to(f).T) * W.to(f)) @ O.to(f)
    return (Y, SQ, Z), (scale_Y, SQ.to(f).abs(), Z.to(f).abs())


def factor_from_atoms(ar: Arith, mass, elem, n_rows: int, k: int):
    """The factor of one chain's atom table (live atoms: elem >= 0)."""
    elem = torch.as_tensor(np.asarray(elem), device=ar.device)
    live = elem >= 0
    out = torch.zeros(n_rows * k, dtype=ar.dtype, device=ar.device)
    out.index_add_(0, elem[live].to(torch.int64), ar.t(mass)[live])
    return out.reshape(n_rows, k)


def normalized(A, P) -> tuple:
    """(A * norm, P / norm) in float64, norm each pattern's maximum over
    P's rows, 1 where that is 0."""
    A = torch.as_tensor(np.asarray(A), dtype=torch.float64)
    P = torch.as_tensor(np.asarray(P), dtype=torch.float64)
    norm = P.amax(dim=0, keepdim=True)
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return A * norm, P / norm
