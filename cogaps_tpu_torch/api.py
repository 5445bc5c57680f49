"""Top-level user API — the PyTorch counterpart of cogaps_tpu/api.py
(reference: R/CoGAPS.R:90-236).

``CoGAPS(data, params=None, n_patterns=..., device="cuda", ...)`` takes
a numpy array, an io.coo.CooMatrix, or a csv/tsv/mtx/gct (io/parsers.py)
or h5/hdf5/h5ad path (io/h5.py), validates the inputs
(R/HelperFunctions.R:194-249), runs the two-phase engine on
`device` — the dense model, or the sparse model (sparse_engine.py) for
sparse_optimization=True or COO input — and returns a CogapsResult.
With ``distributed="genome-wide"`` or ``"single-cell"`` (and through
``GWCoGAPS()`` and ``scCoGAPS()``) it runs the subset-and-consensus
scheme of parallel/distributed.py instead (reference: R/CoGAPS.R:145-151).
A single run writes a checkpoint every ``checkpoint_interval``
iterations and resumes from ``checkpoint_in_file`` (utils/checkpoint.py).
`device` is where the engines run: there is no silent fallback, so
without a GPU the default raises from torch, and the CPU is asked for by
name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .engine import EQUILIBRATION, SAMPLING, GapsEngine, PhiloxRandom
from .io import parsers
from .io.coo import CooMatrix
from .models import dense, sparse
from .params import CogapsParams
from .result import CogapsResult, finalize_statistics, mean_chi_sq
from .utils import checkpoint as ckpt
from .utils.debug import check_state
from .utils.logging import log_message, log_worker


def _load_data(data, transpose: bool):
    """Input coercion (reference: R/HelperFunctions.R:342-356 + file
    dispatch in R/CoGAPS.R:145-151)."""
    gene_names = sample_names = None
    if isinstance(data, str):
        if data.endswith((".h5", ".hdf5", ".h5ad")):
            from .io.h5 import read_any_h5
            mat, gene_names, sample_names = read_any_h5(data)
        else:
            mat, gene_names, sample_names = parsers.read_matrix(data)
    elif isinstance(data, CooMatrix):
        mat = data
    else:
        mat = np.asarray(data, dtype=np.float32)
        if hasattr(data, "index") and hasattr(data, "columns"):  # DataFrame
            gene_names = [str(x) for x in data.index]
            sample_names = [str(x) for x in data.columns]
    if isinstance(mat, CooMatrix):
        if transpose:
            mat = CooMatrix(rows=mat.cols, cols=mat.rows, vals=mat.vals,
                            shape=(mat.shape[1], mat.shape[0]))
            gene_names, sample_names = sample_names, gene_names
        return mat, gene_names, sample_names
    if mat.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    if transpose:
        mat = mat.T
        gene_names, sample_names = sample_names, gene_names
    return np.ascontiguousarray(mat, np.float32), gene_names, sample_names


def _check_inputs(D, uncertainty, params: CogapsParams) -> None:
    """Validation rules (reference: R/HelperFunctions.R:194-249)."""
    if isinstance(D, CooMatrix):
        if np.isnan(D.vals).any():
            raise ValueError("NA values in data")
        if (D.vals < 0).any():
            raise ValueError("negative values in data matrix")
        if uncertainty is not None:
            raise ValueError(
                "sparse (COO) input uses the implied uncertainty; custom "
                "uncertainty requires a dense matrix")
        if params.n_patterns >= min(D.shape) > 1:
            raise ValueError(
                "nPatterns must be less than the smaller data dimension")
        return
    if np.isnan(D).any():
        raise ValueError("NA values in data")
    if (D < 0).any():
        raise ValueError("negative values in data matrix")
    if params.sparse_optimization and uncertainty is not None:
        raise ValueError(
            "must use default uncertainty when enabling sparseOptimization")
    if uncertainty is not None:
        unc = np.asarray(uncertainty, np.float32)
        if unc.shape != D.shape:
            raise ValueError("uncertainty is not the same dimension as the data")
        if (unc < 0).any():
            raise ValueError("negative values in uncertainty matrix")
        if (unc < 1e-5).any():
            raise ValueError("small values in uncertainty matrix detected")
    if params.n_patterns >= min(D.shape) > 1:
        raise ValueError("nPatterns must be less than the smaller data dimension")


def CoGAPS(
    data: Union[np.ndarray, CooMatrix, str],
    params: Optional[CogapsParams] = None,
    n_patterns: Optional[int] = None,
    n_iterations: Optional[int] = None,
    uncertainty: Optional[np.ndarray] = None,
    seed: Optional[int] = None,
    transpose_data: bool = False,
    messages: bool = True,
    gene_names: Optional[Sequence[str]] = None,
    sample_names: Optional[Sequence[str]] = None,
    checkpoint_in_file: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    **kwargs,
) -> CogapsResult:
    """Run CoGAPS on `device` (reference: R/CoGAPS.R:90-171)."""
    params = dataclasses.replace(params) if params is not None else CogapsParams()
    if n_patterns is not None:
        params.n_patterns = int(n_patterns)
    if n_iterations is not None:
        params.n_iterations = int(n_iterations)
    if seed is not None:
        params.seed = int(seed)
    if transpose_data:
        params.transpose_data = True
    if checkpoint_in_file is not None:
        params.checkpoint_in_file = checkpoint_in_file
    params.print_messages = messages
    for key, val in kwargs.items():
        name = (key if hasattr(params, key)
                else params._PARAM_ALIASES.get(key))
        if name is None or not hasattr(params, name):
            raise ValueError(f"unrecognized CoGAPS parameter: {key!r}")
        setattr(params, name, val)
    params.validate()

    D, file_genes, file_samples = _load_data(data, params.transpose_data)
    gene_names = list(gene_names) if gene_names is not None else file_genes
    sample_names = (list(sample_names) if sample_names is not None
                    else file_samples)
    if gene_names is None:
        gene_names = [f"Gene_{i+1}" for i in range(D.shape[0])]
    if sample_names is None:
        sample_names = [f"Sample_{i+1}" for i in range(D.shape[1])]
    _check_inputs(D, uncertainty, params)

    if params.distributed is not None:
        if isinstance(D, CooMatrix):
            # the subsets are slices of a dense matrix, as in the JAX
            # package (cogaps_tpu/parallel/distributed.py:267, :381)
            raise ValueError("distributed runs need a dense matrix, not a "
                             "CooMatrix")
        from .parallel.distributed import distributed_cogaps
        return distributed_cogaps(D, params, uncertainty, gene_names,
                                  sample_names, torch.device(device))
    return _run_single(D, params, uncertainty, gene_names, sample_names,
                       torch.device(device))


def _run_single(D: np.ndarray, params: CogapsParams, uncertainty,
                gene_names, sample_names, device) -> CogapsResult:
    """One full engine run (reference: src/Cogaps.cpp:141-215,
    src/GapsRunner.cpp:380-503)."""
    # a resumed run restores the original seed regardless of the seed
    # argument (reference: GapsRunner.cpp:100-106)
    if params.checkpoint_in_file:
        seed = ckpt.checkpoint_seed(params.checkpoint_in_file)
    else:
        seed = params.resolved_seed()
    is_coo = isinstance(D, CooMatrix)
    config = params.engine_config(D.shape[0], D.shape[1])
    if params.sparse_optimization or is_coo:
        from .sparse_engine import SparseGapsEngine
        engine = SparseGapsEngine(D, config, device)
    else:
        engine = GapsEngine(D, uncertainty, config, device)

    if params.print_messages and not params.running_distributed:
        model = "Sparse" if params.sparse_optimization else "Dense"
        log_message(
            f"Data Model: {model}, Normal\nSampler Type: Batched\n"
            f"nPatterns: {config.n_patterns}, nIterations: {config.n_iterations},"
            f" seed: {seed}, device: {device}")
        if params.sparse_optimization or is_coo:
            log_message("Sparse update mode: "
                        f"{engine.config.sparse_table_mode}")
        if not params.sparse_optimization and engine.data_sparsity > 0.80:
            log_message("Warning: data is more than 80% sparse and "
                        "sparseOptimization is not enabled")

    rand = PhiloxRandom([seed], device)
    start = time.time()
    if params.checkpoint_in_file:
        state, stats, phase0, start_iter = ckpt.load_checkpoint(
            params.checkpoint_in_file, engine)
    else:
        state = engine.init_state(params.fixed_patterns)
        stats = engine.init_stats()
        phase0, start_iter = EQUILIBRATION, 0
    if params.running_distributed:
        log_worker(params.worker_id, "is starting!")
    progress_cb = _make_progress(engine, params, config, start)
    # a resume may start in either phase (GapsRunner.cpp:453-468)
    for phase in (EQUILIBRATION, SAMPLING)[phase0:]:
        it = start_iter if phase == phase0 else 0
        if params.checkpoint_interval > 0 and not params.subset_indices:
            # spans of checkpoint_interval iterations, a checkpoint after
            # each but the run's last (GapsRunner.cpp:225-270)
            while it < config.n_iterations:
                stop = min(it + params.checkpoint_interval,
                           config.n_iterations)
                state, stats = engine.run_phase(state, stats, rand, phase,
                                                it, stop,
                                                progress_cb=progress_cb)
                it = stop
                if it < config.n_iterations or phase == EQUILIBRATION:
                    ckpt.save_checkpoint(params.checkpoint_out_file, engine,
                                         state, stats, phase, it, seed)
        else:
            state, stats = engine.run_phase(state, stats, rand, phase, it,
                                            progress_cb=progress_cb)
        if params.debug_checks:
            check_state(state, config.n_patterns)

    st = {f.name: getattr(stats, f.name)[0].cpu().numpy()
          for f in dataclasses.fields(stats)}
    elapsed = time.time() - start

    amean, asd, pmean, psd = finalize_statistics(
        st["a_sum"], st["a_sumsq"], st["p_sum"], st["p_sumsq"], st["n_stat"])
    if params.which_matrix_fixed != "N":
        mcs = 0.0  # zeroed for fixed-matrix runs (GapsRunner.cpp:478-485)
    elif is_coo:
        # the closed form over the nonzeros, never densified
        # (reference formula: GapsStatistics.cpp:88-111)
        mcs = float(sparse.sparse_chisq(
            engine.data.csr_a.to("cpu"), torch.from_numpy(amean),
            torch.from_numpy(pmean)))
    else:
        # the sparse model's implied uncertainty max(0.1 D, 0.1) is the
        # default (GapsStatistics.cpp:106)
        S = (np.asarray(uncertainty, np.float32) if uncertainty is not None
             else dense.default_uncertainty(D))
        mcs = mean_chi_sq(amean, pmean, D, S)

    total_updates = int(st["upd"])
    prop = st["prop_counts"].astype(np.int64)
    acc = st["acc_counts"].astype(np.int64)
    sw = st["sweep_counts"].astype(np.int64)
    types = ("birth", "death", "move", "exchange")
    half = st["snap_a"].shape[0] // 2
    diagnostics = {
        "chisqHistory": st["chisq_hist"],
        "atomHistoryA": st["atom_hist_a"],
        "atomHistoryP": st["atom_hist_p"],
        "totalUpdates": total_updates,
        "totalRunningTime": elapsed,
        "seed": seed,
        "meanChiSq": mcs,
        "nStatUpdates": int(st["n_stat"]),
        "equilibrationSnapshotsA": st["snap_a"][:half],
        "equilibrationSnapshotsP": st["snap_p"][:half],
        "samplingSnapshotsA": st["snap_a"][half:],
        "samplingSnapshotsP": st["snap_p"][half:],
        "proposalCounts": {
            m: dict(zip(types, prop[i].tolist()))
            for i, m in enumerate(("A", "P"))},
        "acceptanceRates": {
            m: dict(zip(types,
                        (acc[i] / np.maximum(prop[i], 1)).round(4).tolist()))
            for i, m in enumerate(("A", "P"))},
        "sweepCounts": {"A": int(sw[0]), "P": int(sw[1])},
        "averageQueueLengthA": float(prop[0].sum() / max(int(sw[0]), 1)),
        "averageQueueLengthP": float(prop[1].sum() / max(int(sw[1]), 1)),
        "device": str(device),
    }
    if params.take_pump_samples:
        diagnostics["pumpMatrix"] = st["pump"] / max(int(st["n_pump"]), 1)
        mpa = np.zeros_like(amean)
        mpa[np.arange(amean.shape[0]), np.argmax(amean, axis=1)] = 1.0
        diagnostics["meanPatternAssignment"] = mpa
    if params.which_matrix_fixed != "N":
        diagnostics["fixedPatterns"] = np.asarray(params.fixed_patterns,
                                                  np.float32)
        diagnostics["whichMatrixFixed"] = params.which_matrix_fixed

    if params.running_distributed:
        log_worker(params.worker_id, f"is finished! Time: {elapsed:.1f}s")
    elif params.print_messages:
        log_message(f"meanChiSq: {mcs:.1f}, totalUpdates: {total_updates}, "
                    f"time: {elapsed:.1f}s")

    diagnostics["params"] = params
    pattern_names = [f"Pattern_{i+1}" for i in range(config.n_patterns)]
    return CogapsResult(
        Amean=np.asarray(amean, np.float32), Asd=np.asarray(asd, np.float32),
        Pmean=np.asarray(pmean, np.float32), Psd=np.asarray(psd, np.float32),
        mean_chi_sq=mcs, gene_names=gene_names, sample_names=sample_names,
        pattern_names=pattern_names, diagnostics=diagnostics)


def scCoGAPS(data, params: Optional[CogapsParams] = None,
             **kwargs) -> CogapsResult:
    """Single-cell CoGAPS: distributed across sample (cell) subsets, the
    sparse model by default (reference: R/CoGAPS.R:173-211)."""
    params = dataclasses.replace(params) if params is not None else CogapsParams()
    params.distributed = "single-cell"
    kwargs.setdefault("sparse_optimization", True)
    return CoGAPS(data, params, **kwargs)


def GWCoGAPS(data, params: Optional[CogapsParams] = None,
             **kwargs) -> CogapsResult:
    """Genome-wide CoGAPS: distributed across gene subsets (reference:
    R/CoGAPS.R:213-236)."""
    params = dataclasses.replace(params) if params is not None else CogapsParams()
    params.distributed = "genome-wide"
    return CoGAPS(data, params, **kwargs)


def _fmt_hms(seconds: float) -> str:
    s = max(int(seconds), 0)
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"


def _make_progress(engine, params: CogapsParams, config, t0: float):
    """Status line every dispatch_iters iterations — the analog of the
    reference's per-outputFrequency display (GapsRunner.cpp:130-199).
    It reads the device, so it is off (None) when messages are off or
    outputFrequency is 0."""
    if (not params.print_messages or params.output_frequency <= 0
            or params.running_distributed):
        return None
    total = 2 * config.n_iterations

    def cb(phase, iter_end, state):
        frac = (phase * config.n_iterations + iter_end) / total
        elapsed = time.time() - t0
        est = elapsed / frac if frac > 0 else 0.0
        cs = float(engine.chisq(state)[0])
        n_a = int(state.atoms_a.n[0])
        n_p = int(state.atoms_p.n[0])
        name = "equilibration" if phase == EQUILIBRATION else "sampling"
        log_message(
            f"{iter_end} of {config.n_iterations}, Atoms: {n_a}({n_p}),"
            f" ChiSq: {cs:.0f}, time: {_fmt_hms(elapsed)} /"
            f" {_fmt_hms(est)} [{name}]")

    return cb
