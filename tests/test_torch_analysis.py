"""The analysis toolkit (cogaps_tpu_torch/analysis.py, plots.py) against
cogaps_tpu's, on the CPU.

One CogapsResult built from seeded numpy arrays (no sampler run) goes
through every function of analysis.py in both packages: the outputs are
equal exactly (the port's module is a copy run on the same numpy and
scipy, so even scipy's hypergeometric and F tails agree to the bit).
The CogapsResult methods delegate to analysis.py, and plots.py renders
each figure to Agg files."""

import numpy as np
import pytest

from cogaps_tpu import analysis as janalysis
from cogaps_tpu import result as jresult
from cogaps_tpu_torch import analysis, plots, result

N_GENES, N_SAMPLES, K = 60, 24, 4


def _arrays(seed=11):
    rs = np.random.default_rng(seed)
    A = (rs.gamma(1.5, 1.0, (N_GENES, K))
         * (rs.random((N_GENES, K)) < 0.6)).astype(np.float32)
    A[3] = 0.0  # a row of zeros: rowmax 0 in pattern_markers
    P = rs.gamma(2.0, 1.0, (N_SAMPLES, K)).astype(np.float32)
    Asd = (rs.random((N_GENES, K)) * 0.3).astype(np.float32)
    Asd[5, 1] = 0.0  # sd 0: calc_z's 1e-6 floor
    Psd = (rs.random((N_SAMPLES, K)) * 0.3).astype(np.float32)
    return dict(Amean=A, Asd=Asd, Pmean=P, Psd=Psd, mean_chi_sq=123.5,
                gene_names=[f"g{i}" for i in range(N_GENES)],
                sample_names=[f"s{j}" for j in range(N_SAMPLES)],
                pattern_names=[f"Pattern_{k + 1}" for k in range(K)])


@pytest.fixture(scope="module")
def pair():
    return (result.CogapsResult(**_arrays()),
            jresult.CogapsResult(**_arrays()))


@pytest.fixture(scope="module")
def gene_sets():
    rs = np.random.default_rng(2)
    sets = {f"set{i}": [f"g{j}" for j in rs.choice(N_GENES, 8,
                                                   replace=False)]
            for i in range(4)}
    sets["planted"] = [f"g{j}" for j in np.argsort(-_arrays()["Amean"][:, 0])
                       [:6]]
    sets["with_unknown"] = ["g1", "g2", "not_a_gene"]
    return sets


def _equal(a, b, path="out"):
    """Exact equality of nested dicts/lists/arrays/scalars (nan == nan)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


CASES = {
    "calc_z_features": lambda m, r, gs: m.calc_z(r, "featureLoadings"),
    "calc_z_samples": lambda m, r, gs: m.calc_z(r, "sampleFactors"),
    "reconstruct_all": lambda m, r, gs: m.reconstruct_gene(r),
    "reconstruct_names": lambda m, r, gs: m.reconstruct_gene(r, ["g7", "g2"]),
    "reconstruct_indices": lambda m, r, gs: m.reconstruct_gene(r, [0, 9]),
    "binary_a": lambda m, r, gs: m.binary_a(r, 1.5),
    "residuals": lambda m, r, gs: m.residuals(r, _data()),
    "residuals_unc": lambda m, r, gs: m.residuals(r, _data(),
                                                  _data() * 0.2 + 0.5),
    "markers_all": lambda m, r, gs: m.pattern_markers(r),
    "markers_cut": lambda m, r, gs: m.pattern_markers(r, threshold="cut"),
    "markers_axis2": lambda m, r, gs: m.pattern_markers(r, axis=2),
    "markers_lp": lambda m, r, gs: m.pattern_markers(
        r, lp={"first": np.array([1.0, 0.0, 0.5, 0.0]),
               "flat": np.full(K, 0.25)}),
    "cogaps_stat": lambda m, r, gs: m.calc_cogaps_stat(r, gs, num_perm=200,
                                                       seed=3),
    "cogaps_stat_samples": lambda m, r, gs: m.calc_cogaps_stat(
        r, {"s": ["s1", "s4", "s9"]}, which_matrix="sampleFactors",
        num_perm=100),
    "gene_gs_stat": lambda m, r, gs: m.calc_gene_gs_stat(
        r, gs["planted"], num_perm=100, seed=5),
    "gene_gs_stat_pw_null": lambda m, r, gs: m.calc_gene_gs_stat(
        r, gs["planted"], num_perm=100, pw=np.array([2.0, 1.0, 0.5, 1.0]),
        null_genes=True, seed=5),
    "gene_gs_prob": lambda m, r, gs: m.compute_gene_gs_prob(
        r, gs["planted"], num_perm=100, seed=1),
    "bh_adjust": lambda m, r, gs: m._bh_adjust(
        np.array([0.01, 0.04, 0.03, 0.5, 0.2, 0.04])),
    "enrichment": lambda m, r, gs: m.get_pattern_gene_set(r, gs,
                                                          num_perm=1000),
    "overrepresentation": lambda m, r, gs: m.get_pattern_gene_set(
        r, gs, method="overrepresentation", threshold="cut"),
    "manova": lambda m, r, gs: m.manova(_responses(r), r),
}


def _data():
    rs = np.random.default_rng(8)
    return rs.gamma(2.0, 2.0, (N_GENES, N_SAMPLES)).astype(np.float32)


def _responses(r):
    rs = np.random.default_rng(4)
    x = r.Pmean[:, 0].astype(np.float64)
    labels = rs.integers(0, 3, N_SAMPLES)
    return np.stack([2 * x + rs.normal(0, 0.1, N_SAMPLES),
                     labels.astype(np.float64)], axis=1)


@pytest.mark.parametrize("case", list(CASES))
def test_analysis_matches_jax(pair, gene_sets, case):
    mine, theirs = pair
    out = CASES[case](analysis, mine, gene_sets)
    _equal(out, CASES[case](janalysis, theirs, gene_sets))


def test_analysis_contracts(pair, gene_sets):
    """A few of tests/test_analysis.py's contracts, on the port's
    module: every gene a marker once; the planted set most enriched in
    its pattern; the pattern behind the responses significant."""
    mine, _ = pair
    pm = analysis.pattern_markers(mine)
    markers = [g for v in pm["PatternMarkers"].values() for g in v]
    assert sorted(markers) == sorted(mine.gene_names)
    stat = analysis.calc_cogaps_stat(mine, gene_sets, num_perm=200)
    planted = stat["setNames"].index("planted")
    assert stat["GSUpreg"][planted, 0] < 0.05
    fits = analysis.manova(_responses(mine), mine)
    assert fits["Pattern_1"]["p_value"] < 1e-6
    assert all(0.0 <= f["pillai"] <= 1.0 for f in fits.values())


@pytest.mark.parametrize("method,args", [
    ("pattern_markers", {}), ("calc_z", {}), ("reconstruct_gene", {}),
    ("binary_a", {"threshold": 1.0}),
    ("calc_cogaps_stat", {"sets": {"a": ["g1", "g2"]}}),
    ("get_pattern_gene_set", {"gene_sets": {"a": ["g1", "g2", "g3"]}}),
])
def test_result_methods_delegate(pair, method, args):
    mine, theirs = pair
    _equal(getattr(mine, method)(**args), getattr(theirs, method)(**args))


def test_result_manova_delegates(pair):
    mine, theirs = pair
    y = _responses(mine)
    _equal(mine.manova(y), analysis.manova(y, mine))
    _equal(mine.manova(y), theirs.manova(y))


def test_plots_render(pair, gene_sets, tmp_path):
    mine, _ = pair
    figs = [
        plots.plot_result(mine),
        plots.plot_result(mine, groups=["a", "b"] * (N_SAMPLES // 2)),
        plots.binary_a(mine, 1.0),
        plots.plot_residuals(mine, _data()),
        plots.plot_pattern_markers(mine, _data()),
        plots.plot_pattern_gene_set(mine, gene_sets, pval_threshold=1.0,
                                    num_perm=100),
    ]
    for i, fig in enumerate(figs):
        fig.savefig(tmp_path / f"fig{i}.png")
        assert (tmp_path / f"fig{i}.png").stat().st_size > 1000
    import matplotlib
    assert matplotlib.get_backend().lower() == "agg"
