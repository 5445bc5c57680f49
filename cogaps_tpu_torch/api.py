"""Top-level user API for the dense model — the PyTorch counterpart of
cogaps_tpu/api.py (reference: R/CoGAPS.R:90-236).

``CoGAPS(data, params=None, n_patterns=..., device="cuda", ...)`` takes
a numpy array or a csv/tsv/mtx/gct path, validates the inputs
(R/HelperFunctions.R:194-249), runs the two-phase engine on `device` and
returns a CogapsResult. `device` is where the engine runs: there is no
silent fallback, so without a GPU the default raises from torch, and
the CPU is asked for by name.

Not in this slice, and raising NotImplementedError rather than being
ignored: distributed runs, sparseOptimization, checkpoints and h5/h5ad
input (ROADMAP.md, "Queue 1").
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .engine import EQUILIBRATION, SAMPLING, GapsEngine, PhiloxRandom
from .io import parsers
from .models import dense
from .params import CogapsParams
from .result import CogapsResult, finalize_statistics, mean_chi_sq
from .utils.logging import log_message, log_worker


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to cogaps_tpu_torch yet (ROADMAP.md "
        f"Queue 1, {item}); cogaps_tpu runs it")


def _load_data(data, transpose: bool):
    """Input coercion (reference: R/HelperFunctions.R:342-356)."""
    gene_names = sample_names = None
    if isinstance(data, str):
        if data.endswith((".h5", ".hdf5", ".h5ad")):
            raise _not_ported("h5/h5ad input", "analysis, plots and h5 I/O")
        mat, gene_names, sample_names = parsers.read_matrix(data)
    else:
        mat = np.asarray(data, dtype=np.float32)
        if hasattr(data, "index") and hasattr(data, "columns"):  # DataFrame
            gene_names = [str(x) for x in data.index]
            sample_names = [str(x) for x in data.columns]
    if mat.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    if transpose:
        mat = mat.T
        gene_names, sample_names = sample_names, gene_names
    return np.ascontiguousarray(mat, np.float32), gene_names, sample_names


def _check_inputs(D, uncertainty, params: CogapsParams) -> None:
    """Validation rules (reference: R/HelperFunctions.R:194-249)."""
    if np.isnan(D).any():
        raise ValueError("NA values in data")
    if (D < 0).any():
        raise ValueError("negative values in data matrix")
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
    data: Union[np.ndarray, str],
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
    if params.distributed is not None:
        raise _not_ported("distributed CoGAPS", "distributed runs")
    if params.sparse_optimization:
        raise _not_ported("sparseOptimization", "the sparse model")
    if params.checkpoint_in_file or params.checkpoint_interval > 0:
        raise _not_ported("checkpointing", "checkpoints")

    D, file_genes, file_samples = _load_data(data, params.transpose_data)
    gene_names = list(gene_names) if gene_names is not None else file_genes
    sample_names = (list(sample_names) if sample_names is not None
                    else file_samples)
    if gene_names is None:
        gene_names = [f"Gene_{i+1}" for i in range(D.shape[0])]
    if sample_names is None:
        sample_names = [f"Sample_{i+1}" for i in range(D.shape[1])]
    _check_inputs(D, uncertainty, params)
    return _run_single(D, params, uncertainty, gene_names, sample_names,
                       torch.device(device))


def _run_single(D: np.ndarray, params: CogapsParams, uncertainty,
                gene_names, sample_names, device) -> CogapsResult:
    """One full engine run (reference: src/Cogaps.cpp:141-215,
    src/GapsRunner.cpp:380-503)."""
    seed = params.resolved_seed()
    config = params.engine_config(D.shape[0], D.shape[1])
    engine = GapsEngine(D, uncertainty, config, device)

    if params.print_messages and not params.running_distributed:
        log_message(
            f"Data Model: Dense, Normal\nSampler Type: Batched\n"
            f"nPatterns: {config.n_patterns}, nIterations: {config.n_iterations},"
            f" seed: {seed}, device: {device}")
        if engine.data_sparsity > 0.80:
            log_message("Warning: data is more than 80% sparse and "
                        "sparseOptimization is not enabled")

    rand = PhiloxRandom([seed], device)
    start = time.time()
    state = engine.init_state(params.fixed_patterns)
    stats = engine.init_stats()
    if params.running_distributed:
        log_worker(params.worker_id, "is starting!")
    progress_cb = _make_progress(engine, params, config, start)
    for phase in (EQUILIBRATION, SAMPLING):
        state, stats = engine.run_phase(state, stats, rand, phase,
                                        progress_cb=progress_cb)

    st = {f.name: getattr(stats, f.name)[0].cpu().numpy()
          for f in dataclasses.fields(stats)}
    elapsed = time.time() - start

    amean, asd, pmean, psd = finalize_statistics(
        st["a_sum"], st["a_sumsq"], st["p_sum"], st["p_sumsq"], st["n_stat"])
    if params.which_matrix_fixed != "N":
        mcs = 0.0  # zeroed for fixed-matrix runs (GapsRunner.cpp:478-485)
    else:
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
