"""Plotting — parity with the reference's graphics outputs
(reference: R/methods-CogapsResult.R: plot.CogapsResult :67-111,
binaryA :246-263, plotResiduals :266-286, plotPatternGeneSet :351-390,
plotPatternMarkers :709-739). matplotlib instead of R graphics; every
function returns the Figure so callers can save or display.
The port's copy of cogaps_tpu/plots.py; matplotlib (Agg) is imported
inside _mpl, so importing this module does not load it."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import analysis
from .result import CogapsResult


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_result(result: CogapsResult, groups: Optional[Sequence] = None):
    """Pattern weights per sample (reference: plot.CogapsResult :67-111);
    with `groups`, the group-averaged variant."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    P = result.Pmean
    if groups is not None:
        groups = np.asarray(groups)
        uniq = list(dict.fromkeys(groups))
        P = np.stack([P[groups == g].mean(axis=0) for g in uniq])
        xticks = uniq
    else:
        xticks = result.sample_names
    x = np.arange(P.shape[0])
    for j, name in enumerate(result.pattern_names):
        ax.plot(x, P[:, j], marker="o", markersize=3, label=name)
    ax.set_xlabel("Samples")
    ax.set_ylabel("Relative Amplitude")
    if len(xticks) <= 30:
        ax.set_xticks(x)
        ax.set_xticklabels(xticks, rotation=45, ha="right", fontsize=7)
    ax.legend(fontsize=7)
    fig.tight_layout()
    return fig


def binary_a(result: CogapsResult, threshold: float):
    """Heatmap of the thresholded standardized feature matrix
    (reference: binaryA :246-263)."""
    plt = _mpl()
    binA = analysis.binary_a(result, threshold)
    fig, ax = plt.subplots(figsize=(6, 8))
    ax.imshow(binA, aspect="auto", cmap="Blues", interpolation="nearest")
    ax.set_title(f"Heatmap of Standardized Feature Matrix "
                 f"(Threshold = {threshold})")
    ax.set_xticks(range(len(result.pattern_names)))
    ax.set_xticklabels(result.pattern_names, rotation=45, ha="right")
    fig.tight_layout()
    return fig


def plot_residuals(result: CogapsResult, data: np.ndarray,
                   uncertainty: Optional[np.ndarray] = None):
    """Residual heatmap (reference: plotResiduals :266-286)."""
    plt = _mpl()
    resid = analysis.residuals(result, data, uncertainty)
    fig, ax = plt.subplots(figsize=(6, 8))
    lim = float(np.abs(resid).max())
    im = ax.imshow(resid, aspect="auto", cmap="RdYlBu", vmin=-lim, vmax=lim,
                   interpolation="nearest")
    fig.colorbar(im, ax=ax)
    ax.set_title("Heatmap of Residuals")
    fig.tight_layout()
    return fig


def plot_pattern_markers(result: CogapsResult, data: np.ndarray,
                         pattern_palette: Optional[Sequence] = None,
                         sample_palette: Optional[Sequence] = None,
                         **marker_kwargs):
    """Marker-gene heatmap ordered by pattern (reference:
    plotPatternMarkers :709-739)."""
    plt = _mpl()
    pm = analysis.pattern_markers(result, **marker_kwargs)
    name_ix = {n: i for i, n in enumerate(result.gene_names)}
    rows, boundaries = [], []
    for pname in pm["patternNames"]:
        rows.extend(name_ix[g] for g in pm["PatternMarkers"][pname])
        boundaries.append(len(rows))
    data = np.asarray(data, np.float32)[rows]
    # z-score rows for display like pheatmap scale="row"
    mu = data.mean(axis=1, keepdims=True)
    sd = data.std(axis=1, keepdims=True)
    sd[sd == 0] = 1.0
    fig, ax = plt.subplots(figsize=(7, 9))
    ax.imshow((data - mu) / sd, aspect="auto", cmap="RdYlBu_r",
              interpolation="nearest")
    for b in boundaries[:-1]:
        ax.axhline(b - 0.5, color="black", linewidth=0.6)
    ax.set_title("Pattern Markers")
    fig.tight_layout()
    return fig


def plot_pattern_gene_set(result: CogapsResult, gene_sets, method="enrichment",
                          pval_threshold: float = 0.05, **kwargs):
    """Bar chart of -10*log10(padj) per gene set and pattern
    (reference: plotPatternGeneSet :351-390)."""
    plt = _mpl()
    res = analysis.get_pattern_gene_set(result, gene_sets, method=method,
                                        **kwargs)
    n = len(res)
    fig, axes = plt.subplots(n, 1, figsize=(7, 2.4 * n), squeeze=False)
    for ax, rec in zip(axes[:, 0], res):
        sets = [r for r in rec["results"] if r["padj"] <= pval_threshold]
        sets.sort(key=lambda r: r["padj"], reverse=True)
        names = [r["gene.set"] for r in sets]
        vals = [r["neg.log.padj"] for r in sets]
        ax.barh(names, vals)
        ax.set_xlabel("-10 * log10(padj)")
        ax.set_title(f"{rec['pattern']} ({method})", fontsize=9)
    fig.tight_layout()
    return fig
