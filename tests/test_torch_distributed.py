"""The port's distributed runs (cogaps_tpu_torch/parallel/distributed.py
and clustering.py; scCoGAPS, GWCoGAPS) against the JAX package on the
CPU.

* create_sets in every mode, the consensus clustering and
  stitch_together are exactly the JAX functions' on the same inputs;
* the padded multichain data of unequal subsets equals JAX's: dense D,
  invS2 and lambda exactly; the sparse CSR rows, densified, equal to the
  densified JAX ELL rows;
* the contracts of tests/test_distributed.py:123-247 on the port, at
  fewer iterations (the plain sweeps cost milliseconds each here).

tests/test_torch_distributed_lockstep.py holds the subset chains to the
JAX package iteration by iteration."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cogaps_tpu import sparse_engine as jsparse_engine
from cogaps_tpu.parallel import clustering as jclustering
from cogaps_tpu.parallel import distributed as jdist
from cogaps_tpu.parallel import multichain as jmultichain
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu.result import CogapsResult as JResult
from cogaps_tpu_torch import CoGAPS, scCoGAPS, sparse_engine
from cogaps_tpu_torch.api import _run_single
from cogaps_tpu_torch.io.coo import CooMatrix
from cogaps_tpu_torch.parallel import clustering, distributed, multichain
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.result import CogapsResult

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# create_sets, clustering, stitch_together
# ----------------------------------------------------------------------
def _set_cases():
    names = [f"g{i}" for i in range(25)]
    annot = ["a"] * 10 + ["b"] * 9 + ["c"] * 6
    return [
        ("uniform2", 25, dict(n_sets=2), None),
        ("uniform4", 25, dict(n_sets=4), None),
        ("uniform3_of_20", 20, dict(n_sets=3), None),
        ("explicit", 25, dict(n_sets=2, explicit_sets=[[3, 1, 7], [0, 24]]),
         None),
        ("named", 25, dict(n_sets=2, explicit_sets=[["g4", "g2"],
                                                    ["g10", "g11"]]), names),
        ("annotation", 25, dict(n_sets=3, sampling_annotation=annot,
                                sampling_weight={"a": 1.0, "b": 2.0,
                                                 "c": 0.5}), None),
        ("annotation_zero_weight", 25, dict(
            n_sets=2, sampling_annotation=annot,
            sampling_weight={"a": 1.0}), None),
        ("too_many_sets", 25, dict(n_sets=3, explicit_sets=[[0], [1]]),
         None),
        ("out_of_range", 25, dict(n_sets=2, explicit_sets=[[0], [25]]),
         None),
        ("missing_name", 25, dict(n_sets=2, explicit_sets=[["g1"], ["x"]]),
         names),
        ("names_needed", 25, dict(n_sets=2, explicit_sets=[["g1"], ["g2"]]),
         None),
        ("bad_annotation", 25, dict(n_sets=2, sampling_annotation=["a"] * 3,
                                    sampling_weight={"a": 1.0}), None),
    ]


@pytest.mark.parametrize("name,n_total,kw,names", _set_cases(),
                         ids=[c[0] for c in _set_cases()])
def test_create_sets_equals_jax(name, n_total, kw, names):
    """The same sets from the same seed, or the same ValueError."""
    outs = []
    for mod, P in ((distributed, CogapsParams), (jdist, JParams)):
        params = P(n_patterns=2, seed=11)
        for key, val in kw.items():
            setattr(params, key, val)
        rng = np.random.default_rng(params.resolved_seed())
        try:
            outs.append(mod.create_sets(n_total, params, rng, names))
        except ValueError as e:
            outs.append(str(e))
    mine, theirs = outs
    if isinstance(theirs, str):
        assert mine == theirs
        return
    assert len(mine) == len(theirs) == kw["n_sets"]
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _patterns(seed, n=15, m=8):
    """m pattern columns in groups that correlate, and noise."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 1.0, (n, 3))
    cols = [base[:, j % 3] + rng.normal(0, 0.3, n) for j in range(m)]
    return np.abs(np.stack(cols, axis=1)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_equals_jax(seed):
    X = _patterns(seed)
    d = 1.0 - np.corrcoef(X.T)
    mine = clustering.complete_linkage(d)
    theirs = jclustering.complete_linkage(d)
    assert [(h, set(m)) for h, m in mine] == [(h, set(m)) for h, m in theirs]
    for k in (1, 2, 3, 5, 8):
        np.testing.assert_array_equal(clustering.cutree_k(mine, 8, k),
                                      jclustering.cutree_k(theirs, 8, k))
    for cut, min_ns in ((3, 1), (3, 2), (2, 3), (8, 1)):
        a = clustering.corcut(X, cut, min_ns)
        b = jclustering.corcut(X, cut, min_ns)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(clustering.corr_to_mean_pattern(x),
                                          jclustering.corr_to_mean_pattern(y))
    # max_ns 2 splits the clusters of three and more
    for cut, min_ns, max_ns in ((3, 1, 4), (3, 1, 2), (2, 2, 3)):
        (ca, pa), (cb, pb) = (
            m.pattern_match(X, cut, min_ns, max_ns)
            for m in (clustering, jclustering))
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x, y)
        assert pa.dtype == pb.dtype == np.float32
        np.testing.assert_array_equal(pa, pb)
    for m in (clustering, jclustering):
        with pytest.raises(ValueError, match="minNS"):
            m.pattern_match(X, 8, 2, 4)


def _subset_results(cls, sets, genome_wide, genes, samples, k=3, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(sets):
        g = len(s) if genome_wide else len(genes)
        n = len(samples) if genome_wide else len(s)
        mats = [rng.gamma(2.0, 1.0, shape).astype(np.float32)
                for shape in ((g, k), (g, k), (n, k), (n, k))]
        out.append(cls(
            Amean=mats[0], Asd=mats[1], Pmean=mats[2], Psd=mats[3],
            mean_chi_sq=float(10 + i),
            gene_names=([genes[j] for j in s] if genome_wide
                        else list(genes)),
            sample_names=(list(samples) if genome_wide
                          else [samples[j] for j in s]),
            pattern_names=[f"Pattern_{j + 1}" for j in range(k)],
            diagnostics={"totalUpdates": 100 * (i + 1), "seed": 9}))
    return out


@pytest.mark.parametrize("genome_wide", [True, False],
                         ids=["genome-wide", "single-cell"])
@pytest.mark.parametrize("sets", [
    [np.array([4, 0, 2]), np.array([1, 3, 5])],  # a permutation: reorder
    [np.array([0, 2, 2]), np.array([1, 3])],  # with a repeat: kept as is
], ids=["permutation", "repeats"])
def test_stitch_together_equals_jax(genome_wide, sets):
    genes = [f"g{i}" for i in range(6)]
    samples = [f"s{i}" for i in range(6)]
    mine = distributed.stitch_together(
        _subset_results(CogapsResult, sets, genome_wide, genes, samples),
        sets, genome_wide, genes, samples)
    theirs = jdist.stitch_together(
        _subset_results(JResult, sets, genome_wide, genes, samples),
        sets, genome_wide, genes, samples)
    for f in ("Amean", "Asd", "Pmean", "Psd"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    for f in ("mean_chi_sq", "gene_names", "sample_names", "pattern_names",
              "diagnostics"):
        assert getattr(mine, f) == getattr(theirs, f), f
    if len(np.concatenate(sets)) == 6:
        assert (mine.gene_names if genome_wide
                else mine.sample_names) == [f"{'g' if genome_wide else 's'}"
                                            f"{i}" for i in range(6)]


# ----------------------------------------------------------------------
# the padded stacks
# ----------------------------------------------------------------------
GW_SETS = [np.arange(0, 12), np.arange(12, 25)]  # 12 and 13 genes
SC_SETS = [np.array([0, 2, 4, 6, 8, 10, 12, 14, 16]),
           np.array([1, 3, 5, 7, 9, 11, 13, 15, 17, 18, 19])]  # 9 and 11


def _subsets(D, sets, genome_wide):
    return [D[s, :] if genome_wide else D[:, s] for s in sets]


def _pads(subs):
    return max(d.shape[0] for d in subs), max(d.shape[1] for d in subs)


@pytest.mark.parametrize("genome_wide,sets", [(True, GW_SETS),
                                              (False, SC_SETS)],
                         ids=["genome-wide", "single-cell"])
@pytest.mark.parametrize("with_unc", [False, True],
                         ids=["default_S", "given_S"])
def test_padded_dense_stack_equals_jax(modsim, genome_wide, sets, with_unc):
    D = modsim[0]
    subs = _subsets(D, sets, genome_wide)
    uncs = (_subsets(0.2 + 0.05 * D, sets, genome_wide) if with_unc
            else None)
    G, S = _pads(subs)
    cfg = CogapsParams(n_patterns=3).engine_config(G, S)
    mine = multichain.stack_device_data(subs, uncs, cfg, "cpu")
    theirs = jax.device_get(jmultichain.stack_device_data(
        subs, uncs, JParams(n_patterns=3).engine_config(G, S), pad_rows=G,
        pad_cols=S))
    for f in ("D", "invS2", "D_t", "invS2_t"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      getattr(theirs, f), f)
    for side in ("mass_a", "mass_p"):
        for f in ("lam", "max_gibbs_mass"):
            np.testing.assert_array_equal(
                getattr(getattr(mine, side), f).numpy(),
                getattr(getattr(theirs, side), f))
    # padding: invS2 = 0 beyond each subset's true rows and columns
    for i, d in enumerate(subs):
        g, s = d.shape
        assert not mine.invS2[i, g:].any() and not mine.invS2[i, :, s:].any()


def _fixed_consensus(modsim, genome_wide):
    """A consensus of the true factor, rescaled to max 1 as
    pattern_match leaves it."""
    f = modsim[2] if genome_wide else modsim[1]
    return (f / f.max(axis=0)).astype(np.float32)


def _dense_of_csr(csr, c, n_cols):
    one = csr.chain(c)
    out = np.zeros((csr.n_rows, n_cols), np.float32)
    out[one.row_ids().numpy(), one.idx.numpy()] = one.val.numpy()
    return out


def _dense_of_ell(ell, c, n_cols):
    idx, val = np.asarray(ell.idx[c]), np.asarray(ell.val[c])
    out = np.zeros((idx.shape[0], n_cols), np.float32)
    r, slot = np.nonzero(idx >= 0)
    out[r, idx[r, slot]] = val[r, slot]
    return out


@pytest.mark.parametrize("genome_wide,sets", [
    (True, GW_SETS), (False, SC_SETS),
    (False, [np.array([7, 3, 3, 12, 0]), np.array([19, 1, 2, 5])]),
], ids=["genome-wide", "single-cell", "unsorted_with_repeat"])
def test_padded_sparse_stack_equals_jax(modsim, genome_wide, sets):
    D = modsim[0] * (np.random.default_rng(0).random(modsim[0].shape) < 0.6)
    coos = distributed.subset_coos(D, sets, genome_wide)
    subs = _subsets(D, sets, genome_wide)
    for coo, sub in zip(coos, subs):  # row-major, as np.nonzero lists them
        r, c = np.nonzero(sub)
        np.testing.assert_array_equal(coo.rows, r)
        np.testing.assert_array_equal(coo.cols, c)
        np.testing.assert_array_equal(coo.vals, sub[r, c])
        assert coo.shape == sub.shape
    G, S = _pads(subs)
    cfg = CogapsParams(n_patterns=3).engine_config(G, S)
    mine, shapes = sparse_engine.stack_sparse_device_data(
        coos, cfg, "cpu", pad_rows=G, pad_cols=S)
    theirs, jshapes = jsparse_engine.stack_sparse_device_data(
        subs, JParams(n_patterns=3).engine_config(G, S), pad_rows=G,
        pad_cols=S)
    assert [tuple(s) for s in shapes] == [tuple(s) for s in jshapes]
    for c in range(len(sets)):
        np.testing.assert_array_equal(_dense_of_csr(mine.csr_a, c, S),
                                      _dense_of_ell(theirs.ell_a, c, S))
        np.testing.assert_array_equal(_dense_of_csr(mine.csr_p, c, G),
                                      _dense_of_ell(theirs.ell_p, c, G))
    for side in ("mass_a", "mass_p"):
        for f in ("lam", "max_gibbs_mass"):
            np.testing.assert_array_equal(
                getattr(getattr(mine, side), f).numpy(),
                np.asarray(getattr(getattr(theirs, side), f)))


# ----------------------------------------------------------------------
# the contracts of tests/test_distributed.py on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sparse_model", [False, True],
                         ids=["dense", "sparse"])
@pytest.mark.parametrize("mode", ["genome-wide", "single-cell"])
def test_distributed_end_to_end(modsim, mode, sparse_model):
    """Shapes, subsets, the consensus, the free factor learned and the
    fixed one zero (tests/test_distributed.py:123-151, :221-247); at least
    one of the seeds returns exactly nPatterns patterns. Each stage's
    seconds, updates and launches are in diagnostics["stages"]."""
    D = modsim[0]
    if sparse_model:
        D = D * (np.random.default_rng(0).random(D.shape) < 0.6)
    exact = False
    for seed in (7, 12, 42):
        params = CogapsParams(n_patterns=3, n_iterations=30, seed=seed,
                              n_sets=2)
        res = CoGAPS(D, params, distributed=mode, messages=False,
                     sparse_optimization=sparse_model, device="cpu")
        k_out = res.Amean.shape[1]
        assert k_out >= 3
        assert res.Amean.shape == (25, k_out)
        assert res.Pmean.shape == (20, k_out)
        assert len(res.diagnostics["subsets"]) == 2
        assert res.diagnostics["consensusPatterns"].shape[1] == k_out
        assert len(res.diagnostics["unmatchedPatterns"]) == 2
        assert res.diagnostics["totalUpdates"] > 0
        assert res.diagnostics["device"] == "cpu"
        stages = res.diagnostics["stages"]  # free, then fixed
        assert len(stages) == 2 and all(st["seconds"] > 0 for st in stages)
        assert stages[1]["updates"] == res.diagnostics["totalUpdates"]
        assert stages[0]["updates"] > 0
        # the plain versions ran: no kernel launched on the CPU
        assert all(n == 0 for st in stages for n in st["launches"].values())
        assert set(stages[0]["launches"]) == {"sweep", "span", "atlas"}
        free, fixed_m = ((res.Amean, res.Pmean) if mode == "genome-wide"
                         else (res.Pmean, res.Amean))
        assert np.abs(free).sum() > 0 and np.isfinite(free).all()
        assert np.abs(fixed_m).sum() == 0
        if k_out == 3:
            exact = True
            break
    assert exact, "no seed produced exactly nPatterns consensus patterns"


def test_distributed_seed_reproducible(modsim):
    params = CogapsParams(n_patterns=3, n_iterations=15, seed=7, n_sets=2)
    r1, r2 = (CoGAPS(modsim[0], params, distributed="genome-wide",
                     messages=False, device="cpu") for _ in range(2))
    np.testing.assert_array_equal(r1.Amean, r2.Amean)
    assert r1.mean_chi_sq == r2.mean_chi_sq


def test_subset_too_small_rejected(modsim):
    params = CogapsParams(n_patterns=8, n_iterations=10, seed=1, n_sets=4)
    with pytest.raises(ValueError, match="less than nPatterns"):
        CoGAPS(modsim[0], params, distributed="single-cell", messages=False,
               device="cpu")


def test_coo_input_refused_for_distributed(modsim):
    D = modsim[0]
    r, c = np.nonzero(D)
    coo = CooMatrix(r.astype(np.int32), c.astype(np.int32), D[r, c], D.shape)
    with pytest.raises(ValueError, match="dense matrix"):
        scCoGAPS(coo, n_patterns=3, n_iterations=5, messages=False,
                 device="cpu")


def test_given_consensus_runs_the_fixed_stage_only(modsim, monkeypatch):
    """fixed_patterns from the caller (manual pattern matching, explicit
    sets) skip stage 1 (cogaps_tpu/parallel/distributed.py:175-176)."""
    calls = []
    real = distributed._run_subsets_multichain

    def spy(*args):
        calls.append(args[-2])
        return real(*args)

    monkeypatch.setattr(distributed, "_run_subsets_multichain", spy)
    consensus = _fixed_consensus(modsim, True)
    params = CogapsParams(n_patterns=3, n_iterations=10, seed=2, n_sets=2,
                          explicit_sets=[list(s) for s in GW_SETS],
                          which_matrix_fixed="P", fixed_patterns=consensus,
                          distributed="genome-wide")
    res = CoGAPS(modsim[0], params, messages=False, device="cpu")
    assert len(calls) == 1 and calls[0] is not None
    np.testing.assert_array_equal(res.diagnostics["consensusPatterns"],
                                  consensus)
    assert "unmatchedPatterns" not in res.diagnostics
    assert len(res.diagnostics["stages"]) == 1
    assert np.abs(res.Pmean).sum() == 0 and np.abs(res.Amean).sum() > 0


@pytest.mark.parametrize("route", ["per-call", "fused"])
def test_multichain_matches_serial_subset_runs(modsim, route):
    """Equal-size explicit subsets (no padding) run as one multichain
    program equal each subset run alone, exactly
    (tests/test_distributed.py:182-218): alone through _run_single where
    both take the per-call route, alone as a one-chain multichain
    program where the subsets take the fused span."""
    D = modsim[0]
    sets = [np.arange(0, 12), np.arange(12, 24)]
    genes = [f"G{i}" for i in range(D.shape[0])]
    samples = [f"S{i}" for i in range(D.shape[1])]
    extra = dict(output_frequency=10) if route == "per-call" else {}
    params = CogapsParams(n_patterns=3, n_iterations=20, seed=21,
                          distributed="genome-wide", n_sets=2,
                          explicit_sets=[list(s) for s in sets],
                          print_messages=False, **extra)
    cfg = params.engine_config(12, D.shape[1])
    data = multichain.stack_device_data([D[s] for s in sets], None, cfg,
                                        "cpu")
    assert multichain.MultichainEngine(data, cfg, "cpu")._fused_ok() == (
        route == "fused")
    multi = distributed._run_subsets_multichain(
        D, None, params, sets, True, genes, samples, None, "cpu")
    for i, s in enumerate(sets):
        if route == "per-call":
            p = dataclasses.replace(params, distributed=None,
                                    explicit_sets=None,
                                    running_distributed=True)
            alone = _run_single(D[s, :], p, None, [genes[j] for j in s],
                                samples, torch.device("cpu"))
        else:
            [alone] = distributed._run_subsets_multichain(
                D, None, params, [s], True, genes, samples, None, "cpu")
        for f in ("Amean", "Asd", "Pmean", "Psd"):
            np.testing.assert_array_equal(getattr(multi[i], f),
                                          getattr(alone, f), f)
        assert multi[i].mean_chi_sq == alone.mean_chi_sq
        assert (multi[i].diagnostics["totalUpdates"]
                == alone.diagnostics["totalUpdates"])
