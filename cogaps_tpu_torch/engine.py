"""The two-phase annealed Gibbs run — the PyTorch
counterpart of cogaps_tpu/engine.py (reference: src/GapsRunner.cpp:
273-503, src/GapsStatistics.{h,cpp}).

* two phases (equilibration with annealing temp min(1, 2*iter/N), then
  sampling) of nIterations each (GapsRunner.cpp:285-291, 455-469);
* per-iteration update budgets drawn round(N(n, sqrt n)) with
  n = max(nAtoms, 10) per matrix, both from the atom counts at the start
  of the iteration (GapsRunner.cpp:293-296);
* update order A -> P (GapsRunner.cpp:202-222); each sampler's update
  call starts from an exact rebuild of its Y/SQ/Z tables;
* posterior statistics with the per-pattern max normalization
  (GapsStatistics.h:130-185), PUMP counts, snapshots and the chi^2 /
  atom-count histories (GapsRunner.cpp:160-199, 316-322).

Chains are a leading tensor dimension of every array: one function,
run_iteration, serves the single-chain engine (NCH = 1) and the
multi-chain engine, as cogaps_tpu/engine.run_iteration and
run_iteration_batch do between them. An iteration is a fixed sequence
of matrix products, budget draws, one sweep-kernel launch per sampler
and elementwise statistics on the device; the host reads nothing back
until the caller asks for it.

Random numbers: the budgets and the sweeps' uniform blocks come from
Philox4x32-10 keyed by (chain seed, phase, iteration, stream)
(PhiloxRandom). They differ from the JAX package's threefry streams, so
runs of the two packages agree in distribution, not draw for draw; the
tests inject the JAX draws to compare them exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import dense
from .ops import rng as gaps_rng
from .ops.atoms import AtomTable, init_atoms
from .ops.sweep import MassParams, SamplerConsts, make_consts
from .ops.sweep_cuda import PhiloxKey, run_updates_multi
from .params import EngineConfig

EQUILIBRATION = 0
SAMPLING = 1
SAMPLER_A, SAMPLER_P, BUDGETS = 0, 1, 2  # Philox streams of an iteration


@dataclasses.dataclass
class DeviceData:
    """Device-resident data of NCH chains, both layouts (the reference's
    per-sampler transposed copies, GapsRunner.cpp:391-406), plus the
    data-derived mass-prior parameters of each chain."""

    D: torch.Tensor  # (NCH, nGenes, nSamples)
    invS2: torch.Tensor  # (NCH, nGenes, nSamples) = 1/S^2
    D_t: torch.Tensor  # (NCH, nSamples, nGenes)
    invS2_t: torch.Tensor
    mass_a: MassParams  # (NCH,) each
    mass_p: MassParams


class HistConfig(NamedTuple):
    n_hist: int
    snap_freq: int


@dataclasses.dataclass
class ChainState:
    atoms_a: AtomTable  # (NCH, capacity_a)
    atoms_p: AtomTable
    M_a: torch.Tensor  # (NCH, nGenes, k)
    M_p: torch.Tensor  # (NCH, nSamples, k)


@dataclasses.dataclass
class RunStats:
    a_sum: torch.Tensor  # (NCH, G, k)
    a_sumsq: torch.Tensor
    p_sum: torch.Tensor  # (NCH, S, k)
    p_sumsq: torch.Tensor
    n_stat: torch.Tensor  # (NCH,) int32
    pump: torch.Tensor  # (NCH, G, k)
    n_pump: torch.Tensor  # (NCH,) int32
    chisq_hist: torch.Tensor  # (NCH, H) float32
    atom_hist_a: torch.Tensor  # (NCH, H) int32
    atom_hist_p: torch.Tensor
    snap_a: torch.Tensor  # (NCH, 2*nSnapshots or 0, G, k) [equil | sampling]
    snap_p: torch.Tensor
    upd: torch.Tensor  # (NCH,) int64 — totalUpdates
    # proposals processed and accepted by type [birth, death, move,
    # exchange] per sampler [A, P], and sweeps per sampler
    prop_counts: torch.Tensor  # (NCH, 2, 4) int32
    acc_counts: torch.Tensor  # (NCH, 2, 4) int32
    sweep_counts: torch.Tensor  # (NCH, 2) int32


def stream_key(phase: int, it: int, stream: int) -> int:
    """Philox key word of one (phase, iteration, stream)."""
    return ((it * 2 + phase) * 4 + stream) & 0xFFFFFFFF


class PhiloxRandom:
    """The engine's random streams: chain c draws from Philox4x32-10
    under key (seeds[c], stream_key(phase, it, stream)), and its counters
    hold no chain index, so a chain's draws are its seed's alone: chains
    of one seed draw alike, as the JAX package's chains keyed by one
    PRNGKey(seed) do (the distributed runs' subset chains), and a chain
    of a multichain run draws what a one-chain run of its seed draws.
    Budgets are drawn on the device, the normals of _BLOCK iterations at
    a time; the sweeps' blocks are drawn inside the kernel
    (ops/rng.philox_uniforms on the CPU)."""

    _BLOCK = 256

    def __init__(self, seeds: Sequence[int], device):
        self.key0 = torch.tensor([int(s) & 0xFFFFFFFF for s in seeds],
                                 dtype=torch.int64, device=device)
        self._normals = None  # (phase, first iteration, z_a, z_p)
        self.blocks_drawn = 0  # of normals, by _block

    def _block(self, phase: int, it: int):
        """(first iteration, z_a, z_p) of the block holding `it`: the
        normals of _BLOCK iterations, each (NCH, _BLOCK)."""
        first = it - it % self._BLOCK
        if self._normals is None or self._normals[:2] != (phase, first):
            keys = torch.tensor(
                [stream_key(phase, i, BUDGETS)
                 for i in range(first, first + self._BLOCK)],
                dtype=torch.int64, device=self.key0.device)
            self._normals = (phase, first,
                             *gaps_rng.philox_normals(self.key0, keys))
            self.blocks_drawn += 1
        return self._normals[1:]

    def budgets(self, phase: int, it: int, n_a: torch.Tensor,
                n_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        first, z_a, z_p = self._block(phase, it)
        return (gaps_rng.budget(z_a[:, it - first], n_a),
                gaps_rng.budget(z_p[:, it - first], n_p))

    def budget_normals(self, phase: int, start: int, n: int) -> torch.Tensor:
        """The normals behind budgets() for iterations [start, start + n),
        as one (NCH, n, 2) float32 tensor [A, P] on the device: the fused
        span kernel (ops/span_cuda.py) forms the budgets from them."""
        parts, it = [], start
        while it < start + n:
            first, z_a, z_p = self._block(phase, it)
            stop = min(start + n, first + self._BLOCK)
            parts.append(torch.stack([z_a[:, it - first:stop - first],
                                      z_p[:, it - first:stop - first]], dim=2))
            it = stop
        return torch.cat(parts, dim=1).contiguous()

    def sweeps(self, phase: int, it: int, sampler: int) -> PhiloxKey:
        return PhiloxKey(self.key0, stream_key(phase, it, sampler))


def annealing_temp(cfg: EngineConfig, phase: int, it: int) -> float:
    """min(1, 2*it/N) in float32 (equilibration), else 1."""
    if phase != EQUILIBRATION:
        return 1.0
    return float(min(np.float32(1.0),
                     np.float32(2.0 * it) / np.float32(cfg.n_iterations)))


def run_iteration(cfg: EngineConfig, consts_a: SamplerConsts,
                  consts_p: SamplerConsts, hist: HistConfig, phase: int,
                  data: DeviceData, it: int, state: ChainState,
                  stats: RunStats, rand, *, tables=dense.tables,
                  update=run_updates_multi) -> Tuple[ChainState, RunStats]:
    """One MCMC iteration of every chain (reference: GapsRunner.cpp:
    273-325). `rand` provides budgets(phase, it, n_a, n_p) and
    sweeps(phase, it, sampler) (PhiloxRandom, or injected draws in the
    tests). `tables(D, invS2, M, other)` builds an update call's (cache,
    phase) and `update` runs it; the fused span's plain version
    (ops/span.py) passes its own."""
    fixed = cfg.which_matrix_fixed
    temp = annealing_temp(cfg, phase, it)
    n_a, n_p = rand.budgets(phase, it, state.atoms_a.n, state.atoms_p.n)

    atoms_a, M_a = state.atoms_a, state.M_a
    atoms_p, M_p = state.atoms_p, state.M_p
    NCH = M_a.shape[0]
    done_a = done_p = torch.zeros(NCH, dtype=torch.int32, device=M_a.device)
    obs_a = obs_p = None

    if fixed != "A":
        cache, tabs = tables(data.D, data.invS2, M_a, M_p)
        atoms_a, M_a, _, done_a, ns_a, cnt_a = update(
            atoms_a, M_a, cache.Y, tabs, temp, n_a, consts_a, data.mass_a,
            rand.sweeps(phase, it, SAMPLER_A))
        obs_a = (ns_a, cnt_a)
    if fixed != "P":
        cache, tabs = tables(data.D_t, data.invS2_t, M_p, M_a)
        atoms_p, M_p, _, done_p, ns_p, cnt_p = update(
            atoms_p, M_p, cache.Y, tabs, temp, n_p, consts_p, data.mass_p,
            rand.sweeps(phase, it, SAMPLER_P))
        obs_p = (ns_p, cnt_p)

    state = ChainState(atoms_a=atoms_a, atoms_p=atoms_p, M_a=M_a, M_p=M_p)

    def chisq_fn():
        return dense.chisq_from_state(data.D, data.invS2, M_a, M_p)

    stats = accumulate_stats(cfg, hist, phase, it, M_a, M_p, atoms_a.n,
                             atoms_p.n, done_a, done_p, stats, chisq_fn,
                             obs_a=obs_a, obs_p=obs_p)
    return state, stats


def accumulate_stats(cfg: EngineConfig, hist: HistConfig, phase: int,
                     it: int, M_a, M_p, n_atoms_a, n_atoms_p, done_a, done_p,
                     stats: RunStats, chisq_fn, obs_a=None,
                     obs_p=None) -> RunStats:
    """Post-sweep bookkeeping (cogaps_tpu/engine.accumulate_stats):
    totalUpdates, sampler counters, posterior statistics with
    max-normalization (GapsStatistics.h:130-185), snapshots
    (GapsRunner.cpp:316-322) and chi^2/atom-count histories
    (GapsRunner.cpp:160-199). Returns new tensors; `it` is a host int,
    so whether this iteration records is decided on the host."""
    fixed = cfg.which_matrix_fixed
    upd = stats.upd + done_a.to(torch.int64) + done_p.to(torch.int64)
    prop = stats.prop_counts.clone()
    acc = stats.acc_counts.clone()
    sw = stats.sweep_counts.clone()
    for row, obs in ((0, obs_a), (1, obs_p)):
        if obs is None:
            continue
        ns, cnt = obs
        prop[:, row] += cnt.processed
        acc[:, row] += cnt.accepted
        sw[:, row] += ns
    stats = dataclasses.replace(stats, upd=upd, prop_counts=prop,
                                acc_counts=acc, sweep_counts=sw)

    if phase == SAMPLING:
        if fixed == "A":
            stats = dataclasses.replace(
                stats, p_sum=stats.p_sum + M_p,
                p_sumsq=stats.p_sumsq + M_p * M_p,
                n_stat=stats.n_stat + 1)
        elif fixed == "P":
            stats = dataclasses.replace(
                stats, a_sum=stats.a_sum + M_a,
                a_sumsq=stats.a_sumsq + M_a * M_a,
                n_stat=stats.n_stat + 1)
        else:
            norm = M_p.amax(dim=1, keepdim=True)
            norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
            q = M_p / norm
            prod = M_a * norm
            stats = dataclasses.replace(
                stats, p_sum=stats.p_sum + q, p_sumsq=stats.p_sumsq + q * q,
                a_sum=stats.a_sum + prod,
                a_sumsq=stats.a_sumsq + prod * prod,
                n_stat=stats.n_stat + 1)
            if cfg.take_pump_samples:
                pump_oh = torch.nn.functional.one_hot(
                    M_a.argmax(dim=2), M_a.shape[2]).to(torch.float32)
                stats = dataclasses.replace(stats, pump=stats.pump + pump_oh,
                                            n_pump=stats.n_pump + 1)

    # snapshots; layout [equil block | sampling block]
    if hist.snap_freq > 0 and (
            cfg.snapshot_phase == "all"
            or (cfg.snapshot_phase == "equilibration"
                and phase == EQUILIBRATION)
            or (cfg.snapshot_phase == "sampling" and phase == SAMPLING)):
        if (it + 1) % hist.snap_freq == 0:
            s_idx = phase * cfg.n_snapshots + (it + 1) // hist.snap_freq - 1
            if 0 <= s_idx < stats.snap_a.shape[1]:
                snap_a = stats.snap_a.clone()
                snap_p = stats.snap_p.clone()
                snap_a[:, s_idx] = M_a
                snap_p[:, s_idx] = M_p
                stats = dataclasses.replace(stats, snap_a=snap_a,
                                            snap_p=snap_p)

    # chi^2 / atom-count history every outputFrequency
    if hist.n_hist > 0 and (it + 1) % cfg.output_frequency == 0:
        h_idx = phase * (hist.n_hist // 2) + (it + 1) // cfg.output_frequency - 1
        if 0 <= h_idx < hist.n_hist:
            chisq_hist = stats.chisq_hist.clone()
            atom_hist_a = stats.atom_hist_a.clone()
            atom_hist_p = stats.atom_hist_p.clone()
            chisq_hist[:, h_idx] = chisq_fn()
            atom_hist_a[:, h_idx] = n_atoms_a
            atom_hist_p[:, h_idx] = n_atoms_p
            stats = dataclasses.replace(stats, chisq_hist=chisq_hist,
                                        atom_hist_a=atom_hist_a,
                                        atom_hist_p=atom_hist_p)
    return stats


def init_chain_state(cfg: EngineConfig, n_chains: int, n_genes: int,
                     n_samples: int, device, fixed_patterns=None) -> ChainState:
    """Empty atom tables and zero factors for every chain; a fixed
    factor is (n, k) for all chains or (NCH, n, k)."""
    k = cfg.n_patterns
    M_a = torch.zeros((n_chains, n_genes, k), dtype=torch.float32,
                      device=device)
    M_p = torch.zeros((n_chains, n_samples, k), dtype=torch.float32,
                      device=device)
    if cfg.which_matrix_fixed in ("A", "P"):
        fp = torch.as_tensor(np.asarray(fixed_patterns, np.float32),
                             device=device)
        if cfg.which_matrix_fixed == "A":
            M_a = fp.expand_as(M_a).clone()
        else:
            M_p = fp.expand_as(M_p).clone()
    return ChainState(atoms_a=init_atoms(cfg.capacity_a, n_chains, device),
                      atoms_p=init_atoms(cfg.capacity_p, n_chains, device),
                      M_a=M_a, M_p=M_p)


def init_run_stats(cfg: EngineConfig, n_chains: int, n_genes: int,
                   n_samples: int, hist: HistConfig, device) -> RunStats:
    k = cfg.n_patterns
    n_snap = 2 * cfg.n_snapshots if cfg.n_snapshots > 0 else 0

    def zf(*shape):
        return torch.zeros((n_chains,) + shape, dtype=torch.float32,
                           device=device)

    def zi(*shape, dtype=torch.int32):
        return torch.zeros((n_chains,) + shape, dtype=dtype, device=device)

    return RunStats(
        a_sum=zf(n_genes, k), a_sumsq=zf(n_genes, k),
        p_sum=zf(n_samples, k), p_sumsq=zf(n_samples, k),
        n_stat=zi(), pump=zf(n_genes, k), n_pump=zi(),
        chisq_hist=zf(hist.n_hist), atom_hist_a=zi(hist.n_hist),
        atom_hist_p=zi(hist.n_hist),
        snap_a=zf(n_snap, n_genes, k), snap_p=zf(n_snap, n_samples, k),
        upd=zi(dtype=torch.int64), prop_counts=zi(2, 4),
        acc_counts=zi(2, 4), sweep_counts=zi(2))


def derive_hist(cfg: EngineConfig) -> HistConfig:
    n_hist = (2 * (cfg.n_iterations // cfg.output_frequency)
              if cfg.output_frequency > 0 else 0)
    snap_freq = (cfg.n_iterations // cfg.n_snapshots
                 if cfg.n_snapshots > 0 else 0)
    return HistConfig(n_hist=n_hist, snap_freq=snap_freq)


def prepare_device_data(D: np.ndarray, S: Optional[np.ndarray],
                        cfg: EngineConfig, device) -> DeviceData:
    """One chain's DeviceData (NCH = 1), validated as
    cogaps_tpu/engine.prepare_device_data validates it."""
    D = np.asarray(D, np.float32)
    if S is None:
        S = dense.default_uncertainty(D)
    S = np.asarray(S, np.float32)
    if S.shape != D.shape:
        raise ValueError("uncertainty shape must match data shape")
    if np.any(S <= 0):
        raise ValueError("uncertainty must be strictly positive")
    if np.any(D < 0):
        raise ValueError("negative values in data matrix")
    k = cfg.n_patterns
    lam_a = dense.compute_lambda(D, cfg.alpha_a, k)
    lam_p = dense.compute_lambda(D, cfg.alpha_p, k)
    return _device_data(
        D[None], (1.0 / (S * S))[None],
        np.float32([lam_a]), np.float32([cfg.max_gibbs_mass_a / lam_a]),
        np.float32([lam_p]), np.float32([cfg.max_gibbs_mass_p / lam_p]),
        device)


def _device_data(D, invS2, lam_a, mgm_a, lam_p, mgm_p, device) -> DeviceData:
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    Dt, inv = t(D), t(invS2)
    return DeviceData(
        D=Dt, invS2=inv, D_t=Dt.transpose(1, 2).contiguous(),
        invS2_t=inv.transpose(1, 2).contiguous(),
        mass_a=MassParams(lam=t(lam_a), max_gibbs_mass=t(mgm_a)),
        mass_p=MassParams(lam=t(lam_p), max_gibbs_mass=t(mgm_p)))


def build_consts(cfg: EngineConfig, n_genes: int, n_samples: int
                 ) -> Tuple[SamplerConsts, SamplerConsts]:
    k = cfg.n_patterns
    return (make_consts(n_genes, n_samples, k, cfg.capacity_a, cfg.batch_a,
                        cfg.alpha_a, local_moves=cfg.local_moves),
            make_consts(n_samples, n_genes, k, cfg.capacity_p, cfg.batch_p,
                        cfg.alpha_p, local_moves=cfg.local_moves))


class ChainEngine:
    """Runs the chains of a DeviceData together: every array carries the
    chain dimension, and each sampler's update call is one kernel launch
    for all chains. GapsEngine (one chain) and parallel/multichain.
    MultichainEngine build on it; the sparse engines
    (sparse_engine.SparseChainEngine) share its state, statistics and
    run_phase with their own data and iteration."""

    iterate = staticmethod(run_iteration)
    sparse_model = False  # the model, as a checkpoint records it

    def __init__(self, data: DeviceData, config: EngineConfig, device):
        device = torch.device(device)
        self.config = config
        self.device = device
        self.data = DeviceData(
            D=data.D.to(device), invS2=data.invS2.to(device),
            D_t=data.D_t.to(device), invS2_t=data.invS2_t.to(device),
            mass_a=MassParams(*(x.to(device) for x in data.mass_a)),
            mass_p=MassParams(*(x.to(device) for x in data.mass_p)))
        self.n_chains, self.n_genes, self.n_samples = data.D.shape
        self.hist = derive_hist(config)
        self.consts_a, self.consts_p = build_consts(
            config, self.n_genes, self.n_samples)

    def init_state(self, fixed_patterns=None) -> ChainState:
        return init_chain_state(self.config, self.n_chains, self.n_genes,
                                self.n_samples, self.device, fixed_patterns)

    def init_stats(self) -> RunStats:
        return init_run_stats(self.config, self.n_chains, self.n_genes,
                              self.n_samples, self.hist, self.device)

    def run_phase(self, state: ChainState, stats: RunStats, rand,
                  phase: int, start_iter: int = 0,
                  stop_iter: Optional[int] = None, progress_cb=None):
        """Iterations [start, stop) of one phase. `progress_cb(phase,
        iter_end, state)` fires every dispatch_iters iterations and at
        the end — the live status hook (GapsRunner.cpp:160-199)."""
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        every = max(self.config.dispatch_iters, 1)
        for it in range(start_iter, stop):
            state, stats = self.iterate(
                self.config, self.consts_a, self.consts_p, self.hist, phase,
                self.data, it, state, stats, rand)
            if progress_cb is not None and (
                    (it + 1 - start_iter) % every == 0 or it + 1 == stop):
                progress_cb(phase, it + 1, state)
        return state, stats

    def chisq(self, state: ChainState) -> torch.Tensor:
        """chi^2 of every chain's current factors, (NCH,)."""
        return dense.chisq_from_state(self.data.D, self.data.invS2,
                                      state.M_a, state.M_p)


class GapsEngine(ChainEngine):
    """One chain of the dense model on `device` (the analog of
    runCoGAPSAlgorithm, GapsRunner.cpp:380-503). `D`/`S` are
    (nGenes, nSamples) numpy arrays; S defaults to max(0.1*D, 0.1)."""

    def __init__(self, D: np.ndarray, S: Optional[np.ndarray],
                 config: EngineConfig, device):
        D = np.asarray(D, np.float32)
        super().__init__(prepare_device_data(D, S, config, device), config,
                         device)
        self.lam_a = float(self.data.mass_a.lam[0])
        self.lam_p = float(self.data.mass_p.lam[0])
        self.data_sparsity = float((D == 0).mean())
