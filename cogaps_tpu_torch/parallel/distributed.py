"""Distributed CoGAPS: subsets, consensus, fixed re-solve, stitch — the
PyTorch counterpart of cogaps_tpu/parallel/distributed.py (reference:
R/DistributedCogaps.R:48-119).

  stage 1: partition the long axis (genes for genome-wide, samples for
           single-cell) into nSets subsets and run a full chain on each
           (the reference forks one C++ engine per subset,
           R/DistributedCogaps.R:64-67);
  match:   consensus patternMatch of the gathered short-axis factors
           (clustering.pattern_match: complete-linkage clusters of
           1 - cor, cut, minNS/maxNS, cor^3-weighted means rescaled to
           max 1; R/DistributedCogaps.R:129-217);
  stage 2: re-run every subset with the consensus fixed
           (whichMatrixFixed = "P" for genome-wide, "A" for single-cell;
           R/DistributedCogaps.R:86-97);
  stitch:  concatenate the free factor across subsets, restore the input
           order when the subsets form a permutation, sum meanChiSq
           (R/DistributedCogaps.R:226-278).

The subset chains of a stage run as one multichain program on `device`:
the dense ones on parallel/multichain.MultichainEngine (the fused span
K3 where its gate holds, else the per-call sweep kernel K1), the sparse
ones on sparse_engine.SparseMultichainEngine (K2 or K4, by
resolve_sparse_mode). Subsets are padded to the largest one; every chain
is keyed by the same seed, as the reference's forked workers all carry
params@seed.

Across ranks (a call made in every rank of a torch.distributed process
group, parallel/multihost.py): the dense subset chains take the JAX
package's device-mesh rule (cogaps_tpu/parallel/distributed.py:279-289),
with ranks for devices. With nd = min(nSets, ranks) dividing nSets, the
first nd ranks each run nSets / nd of the chains (subset_mesh) with no
communication until the stage's end, when its statistics are gathered in
chain order and broadcast to the ranks outside; else every rank runs all
chains. Every rank then runs the consensus, stage 2 and the stitch on the
same bits and returns the same CogapsResult: a chain's bits do not depend
on which rank runs it, or beside how many others. The sparse subset
chains take no mesh, as in the JAX package, and run whole on every rank.
The consensus step is O(nSets^2 k^2) on the host. The result's
diagnostics["stages"] hold each stage's seconds (its two phases, this
rank's clock), updates and launches of each kernel in KERNELS (summed
over the ranks where the chains have a mesh).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..engine import EQUILIBRATION, SAMPLING, PhiloxRandom
from ..io.coo import CooMatrix
from ..models import dense, sparse
from ..ops import atlas_cuda, span_cuda, sweep_cuda
from ..params import CogapsParams
from ..result import CogapsResult, finalize_statistics, mean_chi_sq
from ..sparse_engine import SparseMultichainEngine, stack_sparse_device_data
from ..utils.logging import log_message
from . import multihost
from .clustering import corr_to_mean_pattern, pattern_match
from .multichain import MultichainEngine, stack_device_data

# the kernel wrappers a stage may launch, by the name its record uses
KERNELS = {"sweep": sweep_cuda.run_updates_multi,
           "span": span_cuda.run_span,
           "atlas": atlas_cuda.run_updates_atlas_multi}


# ----------------------------------------------------------------------
# subset creation (reference: R/SubsetData.R) — numpy, as in the JAX
# package, so that one seed gives the same sets in both
# ----------------------------------------------------------------------
def create_sets(n_total: int, params: CogapsParams,
                rng: np.random.Generator,
                names: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    """Partition indices [0, n_total) into nSets subsets (reference:
    R/SubsetData.R:85-116). Explicit sets may be index lists (0-based here;
    the reference uses R's 1-based) or name lists."""
    if params.explicit_sets is not None:
        if len(params.explicit_sets) != params.n_sets:
            raise ValueError("nSets does not match number of explicit sets")
        sets = []
        for s in params.explicit_sets:
            s = list(s)
            if s and isinstance(s[0], str):
                if names is None:
                    raise ValueError("named explicit sets require names")
                name_ix = {n: i for i, n in enumerate(names)}
                missing = [x for x in s if x not in name_ix]
                if missing:
                    raise ValueError(
                        f"some named entries in explicit_sets not found: "
                        f"{missing[:5]}")
                sets.append(np.asarray([name_ix[x] for x in s], np.int64))
            else:
                ix = np.asarray(s, np.int64)
                if ix.min() < 0 or ix.max() >= n_total:
                    raise ValueError("explicit set index out of range")
                sets.append(ix)
        return sets

    set_size = n_total // params.n_sets
    if params.sampling_annotation is not None:
        # weighted sampling with replacement by annotation group
        # (reference: R/SubsetData.R:36-54)
        annot = np.asarray(params.sampling_annotation)
        if len(annot) != n_total:
            raise ValueError("samplingAnnotation length must match data")
        weight = dict(params.sampling_weight or {})
        groups = np.unique(annot)
        probs = np.asarray([float(weight.get(g, 0.0)) for g in groups])
        if probs.sum() <= 0:
            raise ValueError("sampling weights must have positive sum")
        probs = probs / probs.sum()
        sets = []
        for _ in range(params.n_sets):
            group_draw = rng.choice(len(groups), size=set_size, p=probs)
            chosen = []
            for gi, g in enumerate(groups):
                cnt = int((group_draw == gi).sum())
                if cnt == 0:
                    continue
                pool = np.where(annot == g)[0]
                chosen.append(rng.choice(pool, size=cnt, replace=True))
            sets.append(np.sort(np.concatenate(chosen)) if chosen
                        else np.empty(0, np.int64))
        return sets

    # uniform partition without replacement (reference: R/SubsetData.R:63-75)
    remaining = np.arange(n_total)
    sets = []
    for _ in range(params.n_sets - 1):
        sel = rng.choice(remaining, size=set_size, replace=False)
        sets.append(np.sort(sel))
        remaining = np.setdiff1d(remaining, sel)
    sets.append(np.sort(remaining))
    return sets


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------
def distributed_cogaps(D: np.ndarray, params: CogapsParams, uncertainty,
                       gene_names: Sequence[str],
                       sample_names: Sequence[str],
                       device="cuda") -> CogapsResult:
    """Run CoGAPS across data subsets on `device` and stitch the results
    back together (reference: R/DistributedCogaps.R:48-119)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the rank's own card under NCCL (multihost.initialize_distributed)
        device = torch.device("cuda", torch.cuda.current_device())
    genome_wide = params.distributed == "genome-wide"
    n_total = D.shape[0] if genome_wide else D.shape[1]
    rng = np.random.default_rng(params.resolved_seed())
    names = gene_names if genome_wide else sample_names
    sets = create_sets(n_total, params, rng, names)
    if min(len(s) for s in sets) < params.n_patterns:
        raise ValueError("data subset dimension less than nPatterns")
    if params.print_messages:
        sizes = [len(s) for s in sets]
        log_message(f"Creating subsets...\nset sizes (min, mean, max): "
                    f"({min(sizes)}, {np.mean(sizes):.1f}, {max(sizes)})")

    unc = np.asarray(uncertainty, np.float32) if uncertainty is not None else None

    stages = []

    def run_stage(fixed):
        if params.sparse_optimization:
            results = _run_subsets_multichain_sparse(
                D, params, sets, genome_wide, gene_names, sample_names,
                fixed, device)
        else:
            results = _run_subsets_multichain(
                D, unc, params, sets, genome_wide, gene_names,
                sample_names, fixed, device)
        stages.append({
            "seconds": results[0].diagnostics["totalRunningTime"],
            "updates": sum(r.diagnostics["totalUpdates"] for r in results),
            "launches": results[0].diagnostics["launches"]})
        return results

    diagnostics = {}
    if params.fixed_patterns is None:
        if params.print_messages:
            log_message("Running Across Subsets...")
        initial = run_stage(None)
        # the short-axis factor of every subset chain: Pmean for
        # genome-wide, Amean for single-cell (R/DistributedCogaps.R:71-74)
        unmatched = [(r.Pmean if genome_wide else r.Amean) for r in initial]
        all_patterns = np.concatenate(unmatched, axis=1)
        if params.print_messages:
            log_message("Matching Patterns Across Subsets...")
        clusters, consensus = pattern_match(
            all_patterns, params.resolved_cut(), params.resolved_min_ns(),
            params.resolved_max_ns())
        diagnostics["unmatchedPatterns"] = unmatched
        diagnostics["clusteredPatterns"] = clusters
        diagnostics["CorrToMeanPattern"] = [
            corr_to_mean_pattern(c) for c in clusters]
    else:
        consensus = np.asarray(params.fixed_patterns, np.float32)

    if params.print_messages:
        log_message("Running Final Stage...")
    final = run_stage(consensus)

    result = stitch_together(final, sets, genome_wide, gene_names,
                             sample_names)
    result.diagnostics.update(diagnostics)
    result.diagnostics["consensusPatterns"] = consensus
    result.diagnostics["subsets"] = [[names[j] for j in s] for s in sets]
    result.diagnostics["stages"] = stages
    result.diagnostics["device"] = str(device)
    return result


def stitch_together(results: List[CogapsResult], sets: List[np.ndarray],
                    genome_wide: bool, gene_names, sample_names
                    ) -> CogapsResult:
    """Concatenate per-subset results (reference:
    R/DistributedCogaps.R:226-278)."""
    set_indices = np.concatenate(sets)

    def reorder(mat: np.ndarray, sd: np.ndarray, names: List[str]):
        if mat.shape[0] == len(set_indices):
            indices = np.arange(mat.shape[0])
            if np.array_equal(np.sort(indices), np.sort(set_indices)):
                # match(indices, setIndices): the argsort of a
                # permutation is each index's position in it
                ro = np.argsort(set_indices, kind="stable")
                return mat[ro], sd[ro], [names[j] for j in ro]
        return mat, sd, names

    if genome_wide:
        amean = np.concatenate([r.Amean for r in results], axis=0)
        asd = np.concatenate([r.Asd for r in results], axis=0)
        cat_genes = [g for r in results for g in r.gene_names]
        amean, asd, cat_genes = reorder(amean, asd, cat_genes)
        pmean = results[0].Pmean
        psd = np.zeros_like(pmean)
        genes, samples = cat_genes, list(sample_names)
    else:
        pmean = np.concatenate([r.Pmean for r in results], axis=0)
        psd = np.concatenate([r.Psd for r in results], axis=0)
        cat_samples = [s for r in results for s in r.sample_names]
        pmean, psd, cat_samples = reorder(pmean, psd, cat_samples)
        amean = results[0].Amean
        asd = np.zeros_like(amean)
        genes, samples = list(gene_names), cat_samples

    mean_chi_sq = float(sum(r.mean_chi_sq for r in results))
    k = amean.shape[1]
    return CogapsResult(
        Amean=amean, Asd=asd, Pmean=pmean, Psd=psd,
        mean_chi_sq=mean_chi_sq, gene_names=genes, sample_names=samples,
        pattern_names=[f"Pattern_{i+1}" for i in range(k)],
        diagnostics={"meanChiSq": mean_chi_sq,
                     "totalUpdates": sum(
                         r.diagnostics.get("totalUpdates", 0)
                         for r in results),
                     "seed": results[0].diagnostics.get("seed")})


def _stage_params(params: CogapsParams, genome_wide: bool,
                  fixed) -> CogapsParams:
    """A stage's parameters: one subset run each, the consensus fixed in
    stage 2 (P for genome-wide, A for single-cell)."""
    p = dataclasses.replace(params)
    p.distributed = None
    p.running_distributed = True
    if fixed is not None:
        p.n_patterns = int(np.asarray(fixed).shape[1])
        p.fixed_patterns = np.asarray(fixed, np.float32)
        p.which_matrix_fixed = "P" if genome_wide else "A"
    return p


def _pad_fixed(fixed, n_rows: int):
    """The fixed consensus zero-padded to the padded subsets' n_rows."""
    if fixed is None:
        return None
    fp = np.asarray(fixed, np.float32)
    pad = np.zeros((n_rows, fp.shape[1]), np.float32)
    pad[: fp.shape[0]] = fp
    return pad


def _take(X: np.ndarray, s: np.ndarray, genome_wide: bool) -> np.ndarray:
    return X[s, :] if genome_wide else X[:, s]


OUTSIDE = "outside"  # subset_mesh's answer on a rank that runs no chain


def subset_mesh(n_sets: int):
    """The JAX package's rule for the subset chains' mesh
    (cogaps_tpu/parallel/distributed.py:279-289), with the process group's
    ranks for devices: with more than one rank and nd = min(n_sets, ranks)
    dividing n_sets, a "chains" mesh over ranks 0 .. nd-1 (the whole group,
    or a sub-group that every rank makes, in the same order) and OUTSIDE
    on the ranks past it; else None, and every rank runs every chain."""
    world = multihost.process_count()
    nd = min(n_sets, world)
    if world <= 1 or n_sets % nd:
        return None
    if nd == world:
        return multihost.global_mesh("chains")
    group = torch.distributed.new_group(list(range(nd)))
    rank = multihost.process_index()
    if rank >= nd:
        return OUTSIDE
    return multihost.ProcessMesh("chains", group, nd, rank,
                                 torch.distributed.get_backend(group))


def subset_engine(data, cfg, device, mesh=None) -> MultichainEngine:
    """The engine of a stage's dense subset chains (those of `mesh` this
    rank holds). A chain's bits follow neither its rank nor how many
    chains share its calls: on the per-call route the tables kernel sums
    each chain's tables in an order of its shape alone
    (ops/tables_cuda.py), and on the fused span the table sums are
    bit-equal to the plain tables at every cluster size a chain count
    gives (tests/test_torch_cuda.py)."""
    return MultichainEngine(data, cfg, device, mesh=mesh)


def _run_stage(eng, state, stats, seed: int, mesh=None, device="cpu"):
    """Both phases of the subset chains `eng` holds, each keyed by `seed`;
    returns (every chain's stats on the host, this rank's seconds, the
    launches of each of KERNELS). With a mesh (subset_mesh) the chains'
    stats are gathered in chain order over it and, where ranks lie
    outside it (eng None there), broadcast to them from rank 0; the
    launches are summed over the ranks in a tensor on `device`."""
    before = {n: w.launches for n, w in KERNELS.items()}
    t0 = time.perf_counter()
    st = None
    if eng is not None:
        rand = PhiloxRandom([seed] * eng.n_chains, eng.device)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        for phase in (EQUILIBRATION, SAMPLING):
            state, stats = eng.run_phase(state, stats, rand, phase)
        chains = mesh if isinstance(mesh, multihost.ProcessMesh) else None
        st = {f: multihost.all_gather_units(getattr(stats, f), chains)
              .cpu().numpy() for f in ("a_sum", "a_sumsq", "p_sum",
                                       "p_sumsq", "n_stat", "upd")}
    if mesh is OUTSIDE or (mesh is not None
                           and mesh.size < multihost.process_count()):
        box = [st]
        torch.distributed.broadcast_object_list(box, src=0)
        st = box[0]
    elapsed = time.perf_counter() - t0
    launches = torch.tensor([w.launches - before[n]
                             for n, w in KERNELS.items()], device=device)
    if mesh is not None:
        launches = multihost.sum_ints(launches, multihost.global_mesh())
    return st, elapsed, dict(zip(KERNELS, launches.tolist()))


def _subset_results(st, shapes, sets, genome_wide, gene_names,
                    sample_names, seed, elapsed, launches,
                    chisq) -> List[CogapsResult]:
    """One CogapsResult per subset chain, sliced to its true rows;
    chisq(i, amean, pmean) gives its meanChiSq. `elapsed` and `launches`
    are the stage's, shared by its chains."""
    results = []
    for i, s in enumerate(sets):
        g_i, s_i = shapes[i]
        amean, asd, pmean, psd = finalize_statistics(
            st["a_sum"][i][:g_i], st["a_sumsq"][i][:g_i],
            st["p_sum"][i][:s_i], st["p_sumsq"][i][:s_i],
            int(st["n_stat"][i]))
        mcs = chisq(i, amean, pmean)
        if genome_wide:
            genes = [gene_names[j] for j in s]
            samples = list(sample_names)
        else:
            genes = list(gene_names)
            samples = [sample_names[j] for j in s]
        k = amean.shape[1]
        results.append(CogapsResult(
            Amean=amean, Asd=asd, Pmean=pmean, Psd=psd, mean_chi_sq=mcs,
            gene_names=genes, sample_names=samples,
            pattern_names=[f"Pattern_{j+1}" for j in range(k)],
            diagnostics={
                "meanChiSq": mcs, "seed": seed,
                "totalUpdates": int(st["upd"][i]),
                "totalRunningTime": elapsed,
                "launches": launches,
            }))
    return results


def _run_subsets_multichain(D, unc, params: CogapsParams, sets,
                            genome_wide: bool, gene_names, sample_names,
                            fixed, device="cuda") -> List[CogapsResult]:
    """All nSets dense subset chains as one multichain program, padded to
    a common (Gmax, Smax) with invS2 = 0 entries (exact likelihood no-ops),
    the concurrent analog of the reference's bplapply forks
    (R/DistributedCogaps.R:64-67, 93-97)."""
    p = _stage_params(params, genome_wide, fixed)
    subDs = [_take(D, s, genome_wide) for s in sets]
    subUs = ([_take(unc, s, genome_wide) for s in sets]
             if unc is not None else None)
    shapes = [d.shape for d in subDs]
    Gmax = max(g for g, _ in shapes)
    Smax = max(s for _, s in shapes)
    cfg = p.engine_config(Gmax, Smax)
    seed = p.resolved_seed()
    mesh = subset_mesh(len(sets))
    eng = state = stats = None
    if mesh is not OUTSIDE:
        # with a mesh, stacked on the host: the engine moves its chains
        data = stack_device_data(subDs, subUs, cfg,
                                 device if mesh is None else "cpu")
        eng = subset_engine(data, cfg, device, mesh)
        del data
        state = eng.init_state(_pad_fixed(fixed,
                                          Smax if genome_wide else Gmax))
        stats = eng.init_stats()
    st, elapsed, launches = _run_stage(eng, state, stats, seed, mesh,
                                       device)

    def chisq(i, amean, pmean):
        if p.which_matrix_fixed != "N":
            return 0.0  # zeroed for fixed-matrix runs (GapsRunner.cpp:478-485)
        Si = (subUs[i] if subUs is not None
              else dense.default_uncertainty(subDs[i]))
        return mean_chi_sq(amean, pmean, subDs[i], Si)

    return _subset_results(st, shapes, sets, genome_wide, gene_names,
                           sample_names, seed, elapsed, launches, chisq)


def subset_coos(D: np.ndarray, sets, genome_wide: bool) -> List[CooMatrix]:
    """Each subset of D (its rows for genome-wide, its columns for
    single-cell) as a CooMatrix whose nonzeros are in row-major order, as
    np.nonzero lists them on the dense subset, gathered from D's nonzeros
    without a dense copy of any subset."""
    D = np.asarray(D, np.float32)
    if genome_wide:
        major, minor = np.nonzero(D)  # by row
        vals = D[major, minor]
    else:
        major, minor = np.nonzero(D.T)  # by column
        vals = D[minor, major]
    n_major = D.shape[0] if genome_wide else D.shape[1]
    ptr = np.zeros(n_major + 1, np.int64)
    np.cumsum(np.bincount(major, minlength=n_major), out=ptr[1:])
    coos = []
    for s in sets:
        s = np.asarray(s, np.int64)
        cnt = ptr[s + 1] - ptr[s]
        offs = np.cumsum(cnt) - cnt
        take = (np.arange(int(cnt.sum()), dtype=np.int64)
                + np.repeat(ptr[s] - offs, cnt))
        pos = np.repeat(np.arange(len(s), dtype=np.int32), cnt)
        other = minor[take].astype(np.int32)
        if genome_wide:
            coos.append(CooMatrix(pos, other, vals[take],
                                  (len(s), D.shape[1])))
        else:
            order = np.lexsort((pos, other))
            coos.append(CooMatrix(other[order], pos[order],
                                  vals[take][order], (D.shape[0], len(s))))
    return coos


def _run_subsets_multichain_sparse(D, params: CogapsParams, sets,
                                   genome_wide: bool, gene_names,
                                   sample_names, fixed, device="cuda"
                                   ) -> List[CogapsResult]:
    """The sparse counterpart of _run_subsets_multichain: all nSets sparse
    subset chains as one chain-batched program. A padded row or column is
    an all-zero observation under the implied uncertainty, as in the JAX
    package. Custom uncertainty never reaches here: the sparse model
    refuses it at the API (R/HelperFunctions.R:223-224)."""
    p = _stage_params(params, genome_wide, fixed)
    coos = subset_coos(D, sets, genome_wide)
    shapes = [c.shape for c in coos]
    Gmax = max(g for g, _ in shapes)
    Smax = max(s for _, s in shapes)
    cfg = p.engine_config(Gmax, Smax)
    data, _ = stack_sparse_device_data(coos, cfg, "cpu")
    del coos
    eng = SparseMultichainEngine(data, cfg, device)
    del data
    seed = p.resolved_seed()
    state = eng.init_state(_pad_fixed(fixed, Smax if genome_wide else Gmax))
    st, elapsed, launches = _run_stage(eng, state, eng.init_stats(), seed)

    def chisq(i, amean, pmean):
        if p.which_matrix_fixed != "N":
            return 0.0
        g_i, s_i = shapes[i]

        def padded(x, n):
            return torch.as_tensor(np.pad(x, ((0, n - x.shape[0]), (0, 0))),
                                   dtype=torch.float32, device=eng.device)

        # the closed form over the subset's nonzeros (padded rows have none)
        return float(sparse.sparse_chisq(eng.data.csr_a, padded(amean, Gmax),
                                         padded(pmean, Smax), chain=i))

    return _subset_results(st, shapes, sets, genome_wide, gene_names,
                           sample_names, seed, elapsed, launches, chisq)
