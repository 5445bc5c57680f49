"""Throughput harness — the PyTorch counterpart of
cogaps_tpu/bench_harness.py.

Runs C independent chains of the dense engine on one device and reports
aggregate Gibbs atom-updates per second (the number of proposals
processed, as totalUpdates counts them) plus the converged meanChiSq of
chain 0.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .engine import EQUILIBRATION, SAMPLING, PhiloxRandom
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


def run_throughput(D: np.ndarray, params: CogapsParams, n_chains: int = 16,
                   uncertainty: Optional[np.ndarray] = None,
                   device="cuda") -> dict:
    device = torch.device(device)
    D = np.asarray(D, np.float32)
    cfg = params.engine_config(*D.shape)
    data = stack_device_data([D] * n_chains,
                             [uncertainty] * n_chains
                             if uncertainty is not None else None,
                             cfg, device)
    eng = MultichainEngine(data, cfg, device)
    seed = params.resolved_seed()
    rand = PhiloxRandom([seed + c for c in range(n_chains)], device)

    # warmup: one dispatch span of each phase (builds the kernel)
    wu_stop = min(cfg.dispatch_iters, params.n_iterations)
    st, ss = eng.init_state(), eng.init_stats()
    st, ss = eng.run_phase(st, ss, rand, EQUILIBRATION, 0, wu_stop)
    st, ss = eng.run_phase(st, ss, rand, SAMPLING, 0, wu_stop)
    _sync(device)

    t0 = time.perf_counter()
    state, stats = eng.init_state(), eng.init_stats()
    state, stats = eng.run_phase(state, stats, rand, EQUILIBRATION)
    state, stats = eng.run_phase(state, stats, rand, SAMPLING)
    total_updates = int(stats.upd.sum())  # waits for the device
    elapsed = time.perf_counter() - t0

    amean, _, pmean, _ = finalize_statistics(
        stats.a_sum[0].cpu().numpy(), stats.a_sumsq[0].cpu().numpy(),
        stats.p_sum[0].cpu().numpy(), stats.p_sumsq[0].cpu().numpy(),
        int(stats.n_stat[0]))
    S = (np.asarray(uncertainty, np.float32) if uncertainty is not None
         else dense.default_uncertainty(D))
    return {
        "updates_per_second": total_updates / elapsed,
        "total_updates": total_updates,
        "elapsed_s": elapsed,
        "n_chains": n_chains,
        "mean_chi_sq": mean_chi_sq(amean, pmean, D, S),
    }
