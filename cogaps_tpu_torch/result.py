"""Result container — a slimmed copy of cogaps_tpu/result.py: the
CogapsResult fields, finalize_statistics and mean_chi_sq (reference:
src/GapsResult.{h,cpp}, R/class-CogapsResult.R:9-71). The analysis
methods and the csv/npz round trips wait for a later slice."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class CogapsResult:
    Amean: np.ndarray  # (nGenes, k) — featureLoadings
    Asd: np.ndarray
    Pmean: np.ndarray  # (nSamples, k) — sampleFactors
    Psd: np.ndarray
    mean_chi_sq: float
    gene_names: List[str]
    sample_names: List[str]
    pattern_names: List[str]
    diagnostics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def feature_loadings(self) -> np.ndarray:
        return self.Amean

    @property
    def sample_factors(self) -> np.ndarray:
        return self.Pmean

    @property
    def n_patterns(self) -> int:
        return self.Amean.shape[1]

    def __repr__(self) -> str:  # reference: methods-CogapsResult.R show()
        return (f"CogapsResult object with {self.Amean.shape[0]} features and "
                f"{self.Pmean.shape[0]} samples\n"
                f"{self.n_patterns} patterns were learned")


def finalize_statistics(a_sum, a_sumsq, p_sum, p_sumsq, n_stat):
    """Posterior mean/sd from running sums (reference:
    src/GapsStatistics.cpp:13-61): mean = sum/n;
    sd = sqrt(max(0, sumsq - sum^2/n) / (n - 1))."""
    n = float(max(int(n_stat), 1))
    amean = np.asarray(a_sum) / n
    pmean = np.asarray(p_sum) / n
    denom = max(n - 1.0, 1.0)
    asd = np.sqrt(np.maximum(0.0, np.asarray(a_sumsq)
                             - np.asarray(a_sum) ** 2 / n) / denom)
    psd = np.sqrt(np.maximum(0.0, np.asarray(p_sumsq)
                             - np.asarray(p_sum) ** 2 / n) / denom)
    return amean, asd, pmean, psd


def mean_chi_sq(amean: np.ndarray, pmean: np.ndarray, D: np.ndarray,
                S: np.ndarray) -> float:
    """meanChiSq recomputed from the mean matrices (reference:
    src/GapsStatistics.cpp:63-86): sum ((D - Amean @ Pmean^T) / S)^2."""
    m = amean.astype(np.float64) @ pmean.astype(np.float64).T
    return float(np.sum(((D - m) / S) ** 2))
