"""Downstream pattern-analysis toolkit — parity with the reference's
CogapsResult analysis generics (reference: R/methods-CogapsResult.R):
patternMarkers (:395-494), calcZ (:218-231), reconstructGene (:233-244),
binaryA (:246-263), calcCoGAPSStat permutation gene-set test (:497-531),
calcGeneGSStat / computeGeneGSProb (:533-594), getPatternGeneSet
(:300-344, fgsea enrichment + fora overrepresentation), MANOVA (:597-619).

Pure-numpy statistics (deterministic given a seed); the gene-set
enrichment is a self-contained preranked-GSEA implementation equivalent
to fgsea's scoreType="pos" mode, and the overrepresentation test is the
hypergeometric tail fgsea::fora computes.

The port's copy of cogaps_tpu/analysis.py: numpy, with scipy imported
inside get_pattern_gene_set and manova.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .result import CogapsResult


# ----------------------------------------------------------------------
# core matrix statistics
# ----------------------------------------------------------------------
def calc_z(result: CogapsResult, which_matrix: str = "featureLoadings"
           ) -> np.ndarray:
    """mean/sd z-matrix (reference: methods-CogapsResult.R:218-231)."""
    if which_matrix not in ("featureLoadings", "sampleFactors"):
        raise ValueError(
            "whichMatrix must be either 'featureLoadings' or 'sampleFactors'")
    if which_matrix == "sampleFactors":
        mean, sd = result.Pmean, result.Psd.copy()
    else:
        mean, sd = result.Amean, result.Asd.copy()
    sd[sd == 0] = 1e-6
    return mean / sd


def reconstruct_gene(result: CogapsResult,
                     genes: Optional[Sequence] = None) -> np.ndarray:
    """D_hat = Amean @ Pmean^T (reference: methods:233-244)."""
    D = result.Amean @ result.Pmean.T
    if genes is not None:
        ix = _gene_indices(result, genes)
        D = D[ix]
    return D


def binary_a(result: CogapsResult, threshold: float) -> np.ndarray:
    """Binarized standardized feature matrix (reference: methods:246-263;
    the data behind the reference's heatmap)."""
    return (calc_z(result, "featureLoadings") > threshold).astype(np.int32)


def residuals(result: CogapsResult, data: np.ndarray,
              uncertainty: Optional[np.ndarray] = None) -> np.ndarray:
    """(D - Amean @ Pmean^T) / S (reference: methods:268-286; the data
    behind plotResiduals)."""
    data = np.asarray(data, np.float32)
    if uncertainty is None:
        uncertainty = np.maximum(0.1 * data, 0.1)
    return (data - result.Amean @ result.Pmean.T) / uncertainty


def _gene_indices(result: CogapsResult, genes: Sequence) -> np.ndarray:
    if all(isinstance(g, (int, np.integer)) for g in genes):
        return np.asarray(genes, np.int64)
    name_ix = {n: i for i, n in enumerate(result.gene_names)}
    missing = [g for g in genes if g not in name_ix]
    if missing:
        raise ValueError(f"genes not found: {missing[:5]}")
    return np.asarray([name_ix[g] for g in genes], np.int64)


# ----------------------------------------------------------------------
# patternMarkers (reference: methods-CogapsResult.R:395-494)
# ----------------------------------------------------------------------
def pattern_markers(result: CogapsResult, threshold: str = "all",
                    lp: Optional[Mapping[str, np.ndarray]] = None,
                    axis: int = 1) -> Dict[str, object]:
    """Feature (axis=1) or sample (axis=2) markers of each pattern."""
    if threshold not in ("all", "cut"):
        raise ValueError("threshold must be 'all' or 'cut'")
    if axis == 1:
        Amatrix = result.Amean.copy()
        Pmatrix = result.Pmean.T
        row_names = list(result.gene_names)
    elif axis == 2:
        Amatrix = result.Pmean.copy()
        Pmatrix = result.Amean.T
        row_names = list(result.sample_names)
    else:
        raise ValueError("axis must be 1 or 2")
    pattern_names = list(result.pattern_names)
    nP = Amatrix.shape[1]

    # rescale A as if P had max 1 (methods:413-416)
    pscale = Pmatrix.max(axis=1)
    Amatrix = Amatrix * pscale[None, :]

    # row-normalize to max 1 (methods:419)
    rowmax = Amatrix.max(axis=1)
    rowmax[rowmax == 0] = 1.0
    Arowmax = Amatrix / rowmax[:, None]

    if lp is not None:
        lp_list = [np.asarray(v, np.float64) for v in lp.values()]
        lp_names = list(lp.keys())
        if any(v.max() > 1 for v in lp_list):
            raise ValueError("lp should be a list of vectors with max value of 1")
        if any(len(v) != nP for v in lp_list):
            raise ValueError("lp length must equal the number of patterns")
    else:
        lp_list = [np.eye(nP)[i] for i in range(nP)]
        lp_names = pattern_names

    n_rows = Amatrix.shape[0]
    ssscores = np.zeros((n_rows, len(lp_list)))
    ssranks = np.zeros((n_rows, len(lp_list)), np.int64)
    for i, v in enumerate(lp_list):
        sstat = np.sqrt(((Arowmax - v[None, :]) ** 2).sum(axis=1))
        ssscores[:, i] = sstat
        # R rank(ties.method="first"): 1-based, stable
        order = np.argsort(sstat, kind="stable")
        ranks = np.empty(n_rows, np.int64)
        ranks[order] = np.arange(1, n_rows + 1)
        ssranks[:, i] = ranks

    if threshold == "all":
        # argmin assignment (methods:468-479)
        p_idx = np.argmin(ssranks, axis=1)
        markers = {}
        for i, name in enumerate(lp_names):
            members = np.where(p_idx == i)[0]
            members = members[np.argsort(ssranks[members, i], kind="stable")]
            markers[name] = [row_names[j] for j in members]
    else:
        # "cut": first intra-pattern rank worse than the best inter-pattern
        # rank (methods:482-494)
        markers = {}
        row_min = ssranks.min(axis=1)
        for i, name in enumerate(lp_names):
            order = np.argsort(ssranks[:, i], kind="stable")
            worse = ssranks[order, i] > row_min[order]
            cut_at = int(np.argmax(worse)) if worse.any() else len(order)
            markers[name] = [row_names[j] for j in order[:cut_at]]

    return {"PatternMarkers": markers,
            "PatternRanks": ssranks,
            "PatternScores": ssscores,
            "rowNames": row_names,
            "patternNames": lp_names}


# ----------------------------------------------------------------------
# permutation gene-set statistics (reference: methods:497-594)
# ----------------------------------------------------------------------
def calc_cogaps_stat(result: CogapsResult, sets: Mapping[str, Sequence],
                     which_matrix: str = "featureLoadings",
                     num_perm: int = 1000,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Permutation test for gene-set association with each pattern
    (reference: methods:497-531). Returns per-set x per-pattern arrays."""
    z = calc_z(result, which_matrix)
    names = (result.gene_names if which_matrix == "featureLoadings"
             else result.sample_names)
    name_ix = {n: i for i, n in enumerate(names)}
    rng = np.random.default_rng(seed)

    set_names = list(sets.keys())
    pval_up = np.zeros((len(set_names), z.shape[1]))
    for si, sname in enumerate(set_names):
        members = [name_ix[g] for g in sets[sname] if g in name_ix]
        if not members:
            pval_up[si] = 0.5
            continue
        actual = z[members].mean(axis=0)
        count = np.zeros(z.shape[1])
        for _ in range(num_perm):
            perm = rng.choice(z.shape[0], size=len(members), replace=False)
            count += actual < z[perm].mean(axis=0)
        pval_up[si] = count / num_perm
    pval_down = 1.0 - pval_up
    return {
        "twoSidedPValue": np.maximum(np.minimum(pval_down, pval_up),
                                     1.0 / num_perm),
        "GSUpreg": pval_up,
        "GSDownreg": pval_down,
        "GSActEst": 1.0 - 2.0 * pval_up,
        "setNames": set_names,
    }


def calc_gene_gs_stat(result: CogapsResult, gs_to_genes: Sequence[str],
                      num_perm: int = 500, pw: Optional[np.ndarray] = None,
                      null_genes: bool = False, seed: int = 0) -> dict:
    """Per-gene membership statistic within a gene set
    (reference: methods:533-569)."""
    gs = list(gs_to_genes)
    stat = calc_cogaps_stat(result, {"set": gs}, num_perm=num_perm,
                            seed=seed)["GSUpreg"][0]
    gs_stat = -np.log(np.maximum(stat, 1e-12))
    if pw is not None:
        pw = np.asarray(pw, np.float64)
        if len(pw) != len(gs_stat):
            raise ValueError("Invalid weighting")
        gs_stat = gs_stat * pw

    sd = result.Asd.copy()
    sd[sd == 0] = 1e-6
    z = result.Amean / sd
    name_ix = {n: i for i, n in enumerate(result.gene_names)}
    if null_genes:
        rows = [i for n, i in name_ix.items() if n not in set(gs)]
        row_names = [result.gene_names[i] for i in rows]
    else:
        rows = [name_ix[g] for g in gs if g in name_ix]
        row_names = [g for g in gs if g in name_ix]
    ZD = z[rows]
    denom = gs_stat.sum()
    if denom < 1e-6:
        # degenerate weights: empty mapping (consistent dict return type;
        # compute_gene_gs_prob iterates .values())
        return {}
    out = (ZD * gs_stat[None, :]).sum(axis=1) / denom
    row_sum = ZD.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(row_sum < 1e-6, 0.0, out / row_sum)
    return dict(zip(row_names, out))


def compute_gene_gs_prob(result: CogapsResult, gs_to_genes: Sequence[str],
                         num_perm: int = 500, pw: Optional[np.ndarray] = None,
                         pw_null: bool = False, seed: int = 0) -> Dict[str, float]:
    """Gene membership probability (reference: methods:571-594)."""
    gene_stat = calc_gene_gs_stat(result, gs_to_genes, num_perm=num_perm,
                                  pw=pw, seed=seed)
    perm_stat = calc_gene_gs_stat(result, gs_to_genes, num_perm=num_perm,
                                  pw=pw if pw_null else None,
                                  null_genes=True, seed=seed)
    perm_vals = np.asarray(list(perm_stat.values()))
    return {g: float((perm_vals > gene_stat[g]).sum() / len(perm_vals))
            for g in gene_stat}


# ----------------------------------------------------------------------
# getPatternGeneSet (reference: methods:296-344)
# ----------------------------------------------------------------------
def _bh_adjust(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg, matching R p.adjust(method='BH')."""
    n = len(p)
    order = np.argsort(p)[::-1]
    out = np.empty(n)
    cummin = 1.0
    for rank_from_top, idx in enumerate(order):
        r = n - rank_from_top
        val = p[idx] * n / r
        cummin = min(cummin, val)
        out[idx] = min(cummin, 1.0)
    return out


def _gsea_es(ranked_in_set: np.ndarray, stats_sorted: np.ndarray) -> float:
    """Weighted KS enrichment score (fgsea/GSEA statistic, p=1 weights)."""
    n = len(stats_sorted)
    hits = ranked_in_set
    sum_hit = np.abs(stats_sorted[hits]).sum()
    if sum_hit == 0 or len(hits) == 0 or len(hits) == n:
        return 0.0
    inc = np.zeros(n)
    inc[hits] = np.abs(stats_sorted[hits]) / sum_hit
    dec = np.full(n, 1.0 / (n - len(hits)))
    dec[hits] = 0.0
    path = np.cumsum(inc - dec)
    return float(path[np.argmax(np.abs(path))])


def get_pattern_gene_set(result: CogapsResult,
                         gene_sets: Mapping[str, Sequence[str]],
                         method: str = "enrichment",
                         num_perm: int = 1000, seed: int = 0,
                         **marker_kwargs) -> List[dict]:
    """Per-pattern gene-set testing (reference: methods:296-344).

    method='enrichment': preranked GSEA on each pattern's amplitude column
    (positive scores only, matching fgsea scoreType='pos'), permutation
    p-values, BH adjustment.
    method='overrepresentation': hypergeometric test of pattern markers vs
    each set (fgsea::fora), with k/K overlap ratios.
    Returns one record list per pattern: dicts with gene.set, pval, padj,
    neg.log.padj and method-specific fields.
    """
    if method not in ("enrichment", "overrepresentation"):
        raise ValueError("method must be 'enrichment' or 'overrepresentation'")
    from scipy import stats as sps

    A = result.Amean
    features = list(result.gene_names)
    name_ix = {n: i for i, n in enumerate(features)}
    rng = np.random.default_rng(seed)
    out = []

    if method == "enrichment":
        for p_i, pname in enumerate(result.pattern_names):
            amp = A[:, p_i].astype(np.float64)
            order = np.argsort(-amp, kind="stable")
            sorted_amp = amp[order]
            pos_in_sorted = np.empty(len(order), np.int64)
            pos_in_sorted[order] = np.arange(len(order))
            records = []
            for sname, genes in gene_sets.items():
                members = np.asarray(
                    [pos_in_sorted[name_ix[g]] for g in genes
                     if g in name_ix], np.int64)
                es = _gsea_es(members, sorted_amp)
                # permutation null over random same-size sets
                null = np.asarray([
                    _gsea_es(rng.choice(len(amp), size=len(members),
                                        replace=False), sorted_amp)
                    for _ in range(max(num_perm // 10, 100))])
                # scoreType 'pos': one-sided
                pval = float(((null >= es).sum() + 1) / (len(null) + 1))
                leading = []
                if len(members):
                    path_max = np.argsort(members)
                    leading = [features[order[m]]
                               for m in np.sort(members)[:16]]
                records.append({"gene.set": sname, "ES": es, "pval": pval,
                                "size": int(len(members)),
                                "leadingEdge": ", ".join(leading)})
            pv = np.asarray([r["pval"] for r in records])
            padj = _bh_adjust(pv)
            for r, pa in zip(records, padj):
                r["padj"] = float(pa)
                r["neg.log.padj"] = float(-10.0 * math.log10(max(pa, 1e-300)))
            out.append({"pattern": pname, "results": records})
    else:
        pm = pattern_markers(result, **marker_kwargs)
        universe = set(features)
        for pname in result.pattern_names:
            markers = set(pm["PatternMarkers"][pname])
            records = []
            for sname, genes in gene_sets.items():
                gs = set(g for g in genes if g in universe)
                overlap = len(markers & gs)
                # hypergeometric upper tail (fora)
                pval = float(sps.hypergeom.sf(overlap - 1, len(universe),
                                              len(gs), len(markers)))
                records.append({"gene.set": sname, "overlap": overlap,
                                "size": len(gs),
                                "k/K": overlap / max(len(gs), 1),
                                "pval": pval})
            pv = np.asarray([r["pval"] for r in records])
            padj = _bh_adjust(pv)
            for r, pa in zip(records, padj):
                r["padj"] = float(pa)
                r["neg.log.padj"] = float(-10.0 * math.log10(max(pa, 1e-300)))
            out.append({"pattern": pname, "results": records})
    return out


# ----------------------------------------------------------------------
# MANOVA (reference: methods:597-619)
# ----------------------------------------------------------------------
def manova(interested_variables: np.ndarray, result: CogapsResult
           ) -> Dict[str, dict]:
    """One-way MANOVA of the response variables against each pattern
    column (reference: methods:597-619 wraps stats::manova). Returns per
    pattern: Pillai trace, approximate F, degrees of freedom, p-value."""
    from scipy import stats as sps

    Y = np.asarray(interested_variables, np.float64)
    if Y.ndim != 2:
        raise ValueError("interestedVariables must be a 2-D matrix")
    n, q = Y.shape
    fits = {}
    for p_i, pname in enumerate(result.pattern_names):
        x = result.Pmean[:, p_i].astype(np.float64)
        if len(x) != n:
            raise ValueError("variable rows must match number of samples")
        X = np.stack([np.ones(n), x], axis=1)
        B, *_ = np.linalg.lstsq(X, Y, rcond=None)
        resid = Y - X @ B
        E = resid.T @ resid
        Yc = Y - Y.mean(axis=0)
        T = Yc.T @ Yc
        H = T - E
        # Pillai's trace V = tr(H (H+E)^-1); one predictor -> s = 1
        V = float(np.trace(H @ np.linalg.pinv(H + E)))
        s = 1.0
        df_h, df_e = 1.0, n - 2.0
        m_ = 0.5 * (abs(df_h - q) - 1)
        n_ = 0.5 * (df_e - q - 1)
        F = ((2 * n_ + s + 1) / (2 * m_ + s + 1)) * (V / (s - V)) \
            if (s - V) > 1e-12 else np.inf
        df1 = s * (2 * m_ + s + 1)
        df2 = s * (2 * n_ + s + 1)
        pval = float(sps.f.sf(F, df1, df2)) if np.isfinite(F) else 0.0
        fits[pname] = {"pillai": V, "approx_f": float(F),
                       "num_df": df1, "den_df": df2, "p_value": pval}
    return fits
