"""Throughput harness — the PyTorch counterpart of
cogaps_tpu/bench_harness.py.

Runs C independent chains of the dense engine on one device and reports
aggregate Gibbs atom-updates per second (the number of proposals
processed, as totalUpdates counts them) plus the converged meanChiSq of
chain 0. With no per-iteration output (output_frequency=0) and few
samples, MultichainEngine runs whole spans in the fused-span kernel.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .engine import EQUILIBRATION, SAMPLING, PhiloxRandom
from .io.coo import CooMatrix
from .models import dense
from .parallel.multichain import MultichainEngine, stack_device_data
from .params import CogapsParams
from .result import finalize_statistics, mean_chi_sq


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synthetic_dense(n_genes: int, n_samples: int, k: int, n_chains: int,
                    seed: int):
    """Gamma factors, Gaussian noise, clipped at 0; one matrix per chain."""
    rng = np.random.default_rng(seed)
    A = rng.gamma(2.0, 1.0, (n_genes, k)).astype(np.float32)
    P = rng.gamma(2.0, 1.0, (n_samples, k)).astype(np.float32)
    return [np.clip(A @ P.T + rng.normal(0, 0.5, (n_genes, n_samples)), 0,
                    None).astype(np.float32) for _ in range(n_chains)]


def synthetic_sparse(n_genes: int, n_samples: int, k: int, n_chains: int,
                     seed: int, zeros: float = 0.875):
    """Data with structural zeros, one matrix per chain: D = A @ P.T of
    gamma factors whose entries are kept with probability q, so that D
    has a share `zeros` of zeros ((1 - q^2)^k = zeros), zeros a rank-k
    nonnegative factorization can fit (tests/test_sparse.py's
    sparse_data, at any size)."""
    rng = np.random.default_rng(seed)
    q = float(np.sqrt(1.0 - zeros ** (1.0 / k)))
    out = []
    for _ in range(n_chains):
        A = (rng.gamma(2.0, 1.0, (n_genes, k))
             * (rng.random((n_genes, k)) < q)).astype(np.float32)
        P = (rng.gamma(2.0, 1.0, (n_samples, k))
             * (rng.random((n_samples, k)) < q)).astype(np.float32)
        out.append((A @ P.T).astype(np.float32))
    return out


def synthetic_coo(n_genes: int, n_samples: int, density: float,
                  seed: int) -> CooMatrix:
    """A genes x samples CooMatrix with structural zeros, never dense:
    every gene and every sample belongs to one of k = round(1/density)
    programs (uniformly at random), and D[g, s] = a_g * p_s (gamma
    draws) where the two share a program, else 0 — a rank-k nonnegative
    factorization with a share ~density of nonzeros, whose zeros the
    sparse model can fit (unlike nonzeros at uniform positions, which
    its implied uncertainty S = 0.1 at zeros forbids fitting)."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(1.0 / density)))
    g_prog = rng.integers(0, k, n_genes)
    s_prog = rng.integers(0, k, n_samples)
    a = rng.gamma(2.0, 1.0, n_genes).astype(np.float32)
    p = rng.gamma(2.0, 1.0, n_samples).astype(np.float32)
    rows, cols = [], []
    for prog in range(k):
        g = np.flatnonzero(g_prog == prog).astype(np.int32)
        s = np.flatnonzero(s_prog == prog).astype(np.int32)
        rows.append(np.repeat(g, len(s)))
        cols.append(np.tile(s, len(g)))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return CooMatrix(rows=rows, cols=cols, vals=a[rows] * p[cols],
                     shape=(n_genes, n_samples))


def run_throughput(D: np.ndarray, params: CogapsParams, n_chains: int = 16,
                   uncertainty: Optional[np.ndarray] = None,
                   device="cuda") -> dict:
    eng, rand = throughput_engine(D, params, n_chains, uncertainty, device)
    return time_run(eng, rand, D, uncertainty, eng.run_phase)


def throughput_engine(D: np.ndarray, params: CogapsParams, n_chains: int,
                      uncertainty: Optional[np.ndarray], device):
    """The MultichainEngine of n_chains copies of D, and its random
    streams (chain c seeded resolved_seed + c)."""
    device = torch.device(device)
    D = np.asarray(D, np.float32)
    cfg = params.engine_config(*D.shape)
    data = stack_device_data([D] * n_chains,
                             [uncertainty] * n_chains
                             if uncertainty is not None else None,
                             cfg, device)
    eng = MultichainEngine(data, cfg, device)
    seed = params.resolved_seed()
    return eng, PhiloxRandom([seed + c for c in range(n_chains)], device)


def time_run(eng: MultichainEngine, rand: PhiloxRandom, D: np.ndarray,
             uncertainty: Optional[np.ndarray], run_phase) -> dict:
    """A full two-phase run of `eng` through `run_phase` (the engine's
    own, or ChainEngine.run_phase for the per-call route), after a warm-up
    span of each phase: updates per second and chain 0's meanChiSq."""
    cfg = eng.config
    device = eng.device

    # warmup: one dispatch span of each phase (builds the kernels)
    wu_stop = min(cfg.dispatch_iters, cfg.n_iterations)
    st, ss = eng.init_state(), eng.init_stats()
    st, ss = run_phase(st, ss, rand, EQUILIBRATION, 0, wu_stop)
    st, ss = run_phase(st, ss, rand, SAMPLING, 0, wu_stop)
    _sync(device)

    t0 = time.perf_counter()
    state, stats = eng.init_state(), eng.init_stats()
    state, stats = run_phase(state, stats, rand, EQUILIBRATION)
    state, stats = run_phase(state, stats, rand, SAMPLING)
    total_updates = int(stats.upd.sum())  # waits for the device
    elapsed = time.perf_counter() - t0

    amean, _, pmean, _ = finalize_statistics(
        stats.a_sum[0].cpu().numpy(), stats.a_sumsq[0].cpu().numpy(),
        stats.p_sum[0].cpu().numpy(), stats.p_sumsq[0].cpu().numpy(),
        int(stats.n_stat[0]))
    D = np.asarray(D, np.float32)
    S = (np.asarray(uncertainty, np.float32) if uncertainty is not None
         else dense.default_uncertainty(D))
    return {
        "updates_per_second": total_updates / elapsed,
        "total_updates": total_updates,
        "elapsed_s": elapsed,
        "n_chains": eng.n_chains,
        "mean_chi_sq": mean_chi_sq(amean, pmean, D, S),
    }
