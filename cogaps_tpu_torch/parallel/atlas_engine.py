"""Atlas-scale sparse chain on the CSR sweep kernel — the PyTorch
counterpart of cogaps_tpu/parallel/atlas_engine.py.

The regime: genes x cells too large for per-row tables (k = 50 at
30,000 x 50,000 and more). The data lives on the device as plain CSR in
both orientations (models/sparse.CsrMatrix, built once from COO, never
densified); each sampler's update call is one launch of the CSR sweep
kernel (ops/atlas_cuda.run_updates_atlas_multi, csrc/atlas.cu), which
reads the partner factor's rows through the column indices. Per
iteration, as the JAX engine's _iteration_impl:

  budgets (exact Poisson)  ->  A update call against P  ->
  P update call against the updated A  ->  statistics,

with Z2 = other^T other and canUseGibbs formed by the wrapper from the
frozen partner factor, and the closed-form chi^2 from the CSR rows every
chisq_every-th output tick. The JAX engine's paired 128-lane planes, M
mirrors with metadata lanes and per-iteration plane rebuild exist for the
TPU's DMA rules and are not carried over; neither is its k <= 60 bound
(the CSR kernel reads k from its arguments). A checkpoint
(save_checkpoint/load_checkpoint, in utils/checkpoint.py's format)
stores the atoms, the factors and the statistics: the planes and mirrors
the JAX engine rebuilds from do not exist here. As in the JAX package,
run_atlas takes no checkpoint options.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..engine import (BUDGETS, EQUILIBRATION, SAMPLER_A, SAMPLER_P,
                      SAMPLING, ChainState, PhiloxRandom, RunStats,
                      accumulate_stats, annealing_temp, derive_hist,
                      init_chain_state, init_run_stats, stream_key)
from ..io.coo import CooMatrix
from ..models import sparse
from ..ops import rng as gaps_rng
from ..ops.atlas_cuda import run_updates_atlas_multi
from ..ops.sweep import MassParams, make_consts
from ..params import CogapsParams, EngineConfig
from ..result import CogapsResult, finalize_statistics
from ..utils import checkpoint


def build_side(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_rows: int) -> sparse.CsrMatrix:
    """One sampler side's rows as CSR (row pointer, partner index, d),
    built on the host once. The kernel divides by d itself, as the plain
    version does, so 1/d and 1/d^2 are not stored."""
    return sparse.coo_to_csr(rows, cols, vals, n_rows)


class AtlasRandom(PhiloxRandom):
    """The atlas engine's random source: the sweeps' Philox keys of
    engine.PhiloxRandom, and exact Poisson budgets round(Poisson(max(n,
    10))) drawn on the device from a torch.Generator seeded afresh for
    each (seed, phase, iteration), as the JAX atlas engine draws
    jax.random.poisson under a key folded from them
    (atlas_engine.py:249-252): a checkpoint needs the seed alone."""

    def __init__(self, seed: int, device):
        super().__init__([seed], device)
        self.seed = int(seed) & 0xFFFFFFFF
        self.generator = torch.Generator(device=device)

    def budgets(self, phase, it, n_a, n_p):
        self.generator.manual_seed(
            (self.seed << 32) | stream_key(phase, it, BUDGETS))
        lam = torch.clamp(torch.stack([n_a, n_p]), min=10).to(torch.float32)
        n = gaps_rng.poisson(lam, self.generator)
        return n[0], n[1]


class AtlasEngine:
    """Single-chain sparse engine on the CSR sweep kernel. `coo` is a
    CooMatrix (genes x samples), never densified."""

    n_chains = 1
    sparse_model = True

    def __init__(self, coo: CooMatrix, config: EngineConfig,
                 batch: int = 512, capacity: Optional[int] = None,
                 chisq_every: int = 8, device="cuda"):
        self.device = device = torch.device(device)
        G, S = coo.shape
        k = config.n_patterns
        self.n_genes, self.n_samples, self.k = G, S, k
        self.config = config
        self.hist = derive_hist(config)
        self.chisq_every = chisq_every
        rows = np.asarray(coo.rows, np.int64)
        cols = np.asarray(coo.cols, np.int64)
        vals = np.asarray(coo.vals, np.float32)
        self.side_a = build_side(rows, cols, vals, G).to(device)
        self.side_p = build_side(cols, rows, vals, S).to(device)
        root = float(np.sqrt(k / (float(vals.mean()) if len(vals) else 1.0)))

        def mass(alpha, mgm):
            lam = float(alpha) * root
            return MassParams(
                lam=torch.tensor([lam], dtype=torch.float32, device=device),
                max_gibbs_mass=torch.tensor([mgm / lam], dtype=torch.float32,
                                            device=device))

        self.mass_a = mass(config.alpha_a, config.max_gibbs_mass_a)
        self.mass_p = mass(config.alpha_p, config.max_gibbs_mass_p)
        cap = capacity or (1 << 19)
        self.consts_a = make_consts(G, S, k, cap, batch, config.alpha_a)
        self.consts_p = make_consts(S, G, k, cap, batch, config.alpha_p)

    def init_state(self) -> ChainState:
        cfg = dataclasses.replace(self.config,
                                  capacity_a=self.consts_a.capacity,
                                  capacity_p=self.consts_p.capacity)
        return init_chain_state(cfg, 1, self.n_genes, self.n_samples,
                                self.device)

    def init_stats(self) -> RunStats:
        return init_run_stats(self.config, 1, self.n_genes, self.n_samples,
                              self.hist, self.device)

    def iteration(self, state: ChainState, stats: RunStats, rand,
                  phase: int, it: int, with_chisq: bool):
        """One iteration: the A call against P, then the P call against
        the updated A, then the statistics."""
        cfg = self.config
        temp = annealing_temp(cfg, phase, it)
        n_a, n_p = rand.budgets(phase, it, state.atoms_a.n, state.atoms_p.n)
        atoms_a, M_a, done_a, ns_a, cnt_a = run_updates_atlas_multi(
            state.atoms_a, state.M_a, self.side_a, state.M_p, temp, n_a,
            self.consts_a, self.mass_a, rand.sweeps(phase, it, SAMPLER_A))
        atoms_p, M_p, done_p, ns_p, cnt_p = run_updates_atlas_multi(
            state.atoms_p, state.M_p, self.side_p, M_a, temp, n_p,
            self.consts_p, self.mass_p, rand.sweeps(phase, it, SAMPLER_P))

        def chisq_fn():
            if not with_chisq:
                return torch.zeros(1, device=self.device)
            return sparse.sparse_chisq(self.side_a, M_a[0], M_p[0])[None]

        stats = accumulate_stats(cfg, self.hist, phase, it, M_a, M_p,
                                 atoms_a.n, atoms_p.n, done_a, done_p, stats,
                                 chisq_fn, obs_a=(ns_a, cnt_a),
                                 obs_p=(ns_p, cnt_p))
        return (ChainState(atoms_a=atoms_a, atoms_p=atoms_p, M_a=M_a,
                           M_p=M_p), stats)

    def run_phase(self, state: ChainState, stats: RunStats, rand,
                  phase: int, start_iter: int = 0,
                  stop_iter: Optional[int] = None, progress=None):
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        of = self.config.output_frequency
        for it in range(start_iter, stop):
            # chi^2 lands in the history only on output ticks
            # (engine.accumulate_stats); chisq_every prunes the
            # reconstruction to every Nth tick
            tick = of > 0 and (it + 1) % of == 0
            with_chisq = tick and ((it + 1) // of) % self.chisq_every == 0
            state, stats = self.iteration(state, stats, rand, phase, it,
                                          with_chisq)
            if progress is not None:
                progress(phase, it, state)
        return state, stats


# ----------------------------------------------------------------------
# Checkpoints: the atoms, the factors and the statistics, in the format
# of utils/checkpoint.py (the JAX engine stores its M mirrors and
# rebuilds its planes from them; the port has neither, and its M is the
# factor itself). The random source needs only the seed (AtlasRandom).
# ----------------------------------------------------------------------
def save_checkpoint(path: str, engine: AtlasEngine, state: ChainState,
                    stats: RunStats, phase: int, it: int, seed: int) -> str:
    """Write the chain after iteration `it` of `phase` to `path`."""
    checkpoint.save_checkpoint(path, engine, state, stats, phase, it, seed)
    return path


def load_checkpoint(path: str, engine: AtlasEngine):
    """(state, stats, phase, iter, seed) of a checkpoint, on the engine's
    device; refuses a file of other dimensions or configuration."""
    state, stats, phase, it = checkpoint.load_checkpoint(path, engine)
    return state, stats, phase, it, checkpoint.checkpoint_seed(path)


def run_atlas(coo: CooMatrix, n_patterns: int = 50,
              n_iterations: int = 2000, seed: int = 42,
              messages: bool = True, device="cuda",
              **engine_kw) -> CogapsResult:
    """End-to-end atlas run -> CogapsResult (cogaps_tpu/parallel/
    atlas_engine.run_atlas): one sparse chain on the CSR sweep kernel.
    meanChiSq is the closed form over the nonzeros, from the CSR rows,
    in float64; the data is never densified."""
    params = CogapsParams(n_patterns=n_patterns, n_iterations=n_iterations,
                          seed=seed, sparse_optimization=True)
    cfg = params.engine_config(coo.shape[0], coo.shape[1])
    eng = AtlasEngine(coo, cfg, device=device, **engine_kw)
    state, stats = eng.init_state(), eng.init_stats()
    rand = AtlasRandom(seed, eng.device)
    t0 = time.time()
    for phase in (EQUILIBRATION, SAMPLING):
        if messages:
            print(f"atlas phase {phase}: {n_iterations} iterations",
                  flush=True)
        state, stats = eng.run_phase(state, stats, rand, phase)
    st = {f: getattr(stats, f)[0].cpu().numpy()
          for f in ("a_sum", "a_sumsq", "p_sum", "p_sumsq", "n_stat", "upd",
                    "chisq_hist", "atom_hist_a", "atom_hist_p")}
    amean, asd, pmean, psd = finalize_statistics(
        st["a_sum"], st["a_sumsq"], st["p_sum"], st["p_sumsq"], st["n_stat"])
    mcs = float(sparse.sparse_chisq(
        eng.side_a, torch.as_tensor(amean, dtype=torch.float64,
                                    device=eng.device),
        torch.as_tensor(pmean, dtype=torch.float64, device=eng.device)))
    diagnostics = {
        "meanChiSq": mcs,
        "seed": seed,
        "totalRunningTime": time.time() - t0,
        "totalUpdates": int(st["upd"]),
        "chisqHistory": st["chisq_hist"],
        "atomHistoryA": st["atom_hist_a"],
        "atomHistoryP": st["atom_hist_p"],
        "engine": "AtlasEngine",
        "device": str(eng.device),
    }
    return CogapsResult(
        Amean=np.asarray(amean, np.float32), Asd=np.asarray(asd, np.float32),
        Pmean=np.asarray(pmean, np.float32), Psd=np.asarray(psd, np.float32),
        mean_chi_sq=mcs,
        gene_names=[f"Gene_{i}" for i in range(coo.shape[0])],
        sample_names=[f"Sample_{i}" for i in range(coo.shape[1])],
        pattern_names=[f"Pattern_{i + 1}" for i in range(n_patterns)],
        diagnostics=diagnostics)
