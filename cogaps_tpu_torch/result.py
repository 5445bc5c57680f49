"""Result container — the port's copy of cogaps_tpu/result.py, the
analog of GapsResult + the R CogapsResult class (reference:
src/GapsResult.{h,cpp}, R/class-CogapsResult.R:9-71,
R/methods-CogapsResult.R:8-50). Holds posterior means/sds (Amean named
``feature_loadings``, Pmean named ``sample_factors``), meanChiSq and
diagnostics; writes and reads the JAX package's npz and CSV files, which
either package loads from the other.

One departure: get_param on a loaded result rebuilds the CogapsParams from
the dict the file holds (cogaps_tpu's calls ``get_param`` on that dict and
raises AttributeError).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

import numpy as np
import torch


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

    # ---- analysis conveniences (delegate to analysis.py) ----
    def pattern_markers(self, **kw):
        from . import analysis
        return analysis.pattern_markers(self, **kw)

    def calc_z(self, which_matrix: str = "featureLoadings"):
        from . import analysis
        return analysis.calc_z(self, which_matrix)

    def reconstruct_gene(self, genes=None):
        from . import analysis
        return analysis.reconstruct_gene(self, genes)

    def binary_a(self, threshold: float):
        from . import analysis
        return analysis.binary_a(self, threshold)

    def calc_cogaps_stat(self, sets, **kw):
        from . import analysis
        return analysis.calc_cogaps_stat(self, sets, **kw)

    def get_pattern_gene_set(self, gene_sets, **kw):
        from . import analysis
        return analysis.get_pattern_gene_set(self, gene_sets, **kw)

    def manova(self, interested_variables):
        from . import analysis
        return analysis.manova(interested_variables, self)

    # distributed diagnostics getters (reference: methods:176-216)
    def get_unmatched_patterns(self):
        return self.diagnostics.get("unmatchedPatterns")

    def get_clustered_patterns(self):
        return self.diagnostics.get("clusteredPatterns")

    def get_correlation_to_mean_pattern(self):
        return self.diagnostics.get("CorrToMeanPattern")

    def get_subsets(self):
        return self.diagnostics.get("subsets")

    def get_mean_chi_sq(self) -> float:
        return self.mean_chi_sq

    def get_version(self) -> str:
        from . import __version__
        return __version__

    def get_original_parameters(self):
        return self.diagnostics.get("params")

    def get_param(self, name: str):
        params = self.diagnostics.get("params")
        if params is None:
            raise ValueError("result does not carry its parameters")
        if isinstance(params, dict):  # a loaded result holds the json dict
            from .params import CogapsParams
            params = CogapsParams(**{
                f.name: params[f.name]
                for f in dataclasses.fields(CogapsParams) if f.name in params})
        return params.get_param(name)

    # ------------------------------------------------------------------
    def to_csv(self, prefix: str) -> None:
        """Write Amean/Pmean/Asd/Psd as CSV (reference:
        R/methods-CogapsResult.R:624-655 toCSV)."""
        for name, mat, rows in (
                ("Amean", self.Amean, self.gene_names),
                ("Asd", self.Asd, self.gene_names),
                ("Pmean", self.Pmean, self.sample_names),
                ("Psd", self.Psd, self.sample_names)):
            path = f"{prefix}_{name}.csv"
            with open(path, "w") as f:
                f.write("," + ",".join(self.pattern_names) + "\n")
                for i, rn in enumerate(rows):
                    f.write(f"\"{rn}\"," +
                            ",".join(f"{v:.10g}" for v in mat[i]) + "\n")
        meta = {"meanChiSq": self.mean_chi_sq, "diagnostics": self.diagnostics}
        with open(f"{prefix}_meta.json", "w") as f:
            json.dump(_jsonable(meta), f)

    @staticmethod
    def from_csv(prefix: str) -> "CogapsResult":
        """Round-trip loader (reference: R/methods-CogapsResult.R:658-682)."""
        def load(name):
            with open(f"{prefix}_{name}.csv") as f:
                header = f.readline().strip().split(",")[1:]
                rows, vals = [], []
                for line in f:
                    parts = line.rstrip("\n").split(",")
                    rows.append(parts[0].strip('"'))
                    vals.append([float(x) for x in parts[1:]])
            return header, rows, np.asarray(vals, np.float32)

        pats, genes, amean = load("Amean")
        _, _, asd = load("Asd")
        _, samples, pmean = load("Pmean")
        _, _, psd = load("Psd")
        try:
            with open(f"{prefix}_meta.json") as f:
                meta = json.load(f)
            mcs = float(meta.get("meanChiSq", float("nan")))
            diag = meta.get("diagnostics", {})
        except FileNotFoundError:
            mcs, diag = float("nan"), {}
        return CogapsResult(Amean=amean, Asd=asd, Pmean=pmean, Psd=psd,
                            mean_chi_sq=mcs, gene_names=genes,
                            sample_names=samples, pattern_names=pats,
                            diagnostics=diag)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, Amean=self.Amean, Asd=self.Asd, Pmean=self.Pmean,
            Psd=self.Psd, mean_chi_sq=self.mean_chi_sq,
            gene_names=np.asarray(self.gene_names, dtype=object),
            sample_names=np.asarray(self.sample_names, dtype=object),
            pattern_names=np.asarray(self.pattern_names, dtype=object),
            diagnostics=np.asarray([json.dumps(_jsonable(self.diagnostics))],
                                   dtype=object))

    @staticmethod
    def load(path: str) -> "CogapsResult":
        z = np.load(path, allow_pickle=True)
        return CogapsResult(
            Amean=z["Amean"], Asd=z["Asd"], Pmean=z["Pmean"], Psd=z["Psd"],
            mean_chi_sq=float(z["mean_chi_sq"]),
            gene_names=list(z["gene_names"]),
            sample_names=list(z["sample_names"]),
            pattern_names=list(z["pattern_names"]),
            diagnostics=json.loads(str(z["diagnostics"][0])))


def _jsonable(obj):
    """A json-ready copy of obj: arrays and tensors become lists,
    dataclasses (the CogapsParams) dicts, anything else unknown its repr."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)  # last resort: readable, never raises


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
