"""Gene-sharded single chain — the PyTorch counterpart of
cogaps_tpu/parallel/sharded.py: one Gibbs chain whose gene axis is cut
into `n_blocks` fixed row blocks, spread over the ranks of a
multihost.ProcessMesh (or all held by one rank with mesh=None).

DETERMINISM CONTRACT (the analog of the reference's thread-count
invariance, tests/testthat/test_seed_consistency.R:36-68): the unit of
A-side parallelism is a ROW BLOCK, not a rank. Every stream is keyed by
(seed, phase, iteration, BLOCK ID), every A-side atom table and proposal
batch is block-local, every per-block table has the same sums on every
rank count (block_tables: on the card the rank's blocks are the chains
of one models/dense.tables call, whose kernel sums a chain in an order
of its own shape alone; on the CPU a call per block, since a batched
CPU product may sum by the batch count), and every cross-block float
reduction (the P sampler's SQ/Z/Y tables, chi^2) is an all_gather of
per-block partials added in block order (multihost.ordered_sum). Ranks
merely hold contiguous groups of blocks, so THE SAME SEED GIVES BITWISE
THE SAME TRAJECTORY ON 1, 2, 4, ... n_blocks RANKS.

* A sampler — the rank's blocks are the chains of one launch of the
  sweep kernel (ops/sweep_cuda.run_updates_multi, K1): block b samples
  its own rows against the replicated P (the likelihood factorizes over
  rows while P is frozen) with its own (n_blocks, cap_blk) atom-table
  row and its own budget, an exact Poisson draw. Moves and exchanges
  stay within the block (a valid blocked kernel mixture; the reference's
  distributed mode restricts them to the subset the same way).
* P sampler — replicated: each block's partial tables are
  dense.tables(D_b^T, invS2_b^T, M_p, M_a_b) (block_tables), summed in
  block order; then one K1 launch, identical on every rank (the kernel
  is deterministic for equal inputs).
* integer counters cross ranks by an integer sum (exact in any order).

Random streams (ShardedRandom): unit u's sweeps draw Philox4x32-10 under
key (w_u, stream_key(phase, it, SAMPLER_A)) with the unit word
w_u = seed + u * UNIT_STEP mod 2^32. UNIT_STEP is odd, so distinct units
of one run have distinct words; the P sampler draws under (seed,
stream_key(phase, it, SAMPLER_P)), whose second word no A stream has, so
no two streams of a run overlap. Budgets are exact Poisson draws from a
torch.Generator seeded afresh with (w_u, stream_key(phase, it, BUDGETS))
for unit u and (seed, stream_key(phase, it, BUDGET_P)) for P: a
checkpoint needs the seed alone. The JAX package draws
jax.random.poisson under fold_in(kpa, block) instead: the two agree in
distribution, and the tests hand the port JAX's draws to compare them
exactly.

Statistics follow engine.accumulate_stats on unit-stacked arrays: the
A-side arrays (atom tables, M_a, a_sum, a_sumsq, pump, snap_a) carry the
rank's units as their leading dimension, the rest one leading dimension
of 1. (The JAX sharded engine records no PUMP counts or snapshots; this
one does, from the same arrays.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..engine import (BUDGETS, SAMPLER_A, SAMPLER_P, ChainState, RunStats,
                      accumulate_stats, annealing_temp, derive_hist,
                      init_run_stats, stream_key)
from ..models import dense
from ..ops import rng as gaps_rng
from ..ops.atoms import AtomTable, init_atoms
from ..ops.sweep import MassParams, SweepCounts, make_consts
from ..ops.sweep_cuda import PhiloxKey, run_updates_multi
from ..params import EngineConfig
from . import multihost

UNIT_STEP = 0x9E3779B9  # odd: unit ids map one to one onto seed words
BUDGET_P = 3  # the stream of the P sampler's budget (engine.py uses 0-2)

# each leaf's sharded dimension: the A-side arrays are unit-stacked
STATE_SPEC = ChainState(atoms_a=AtomTable(mass=0, elem=0, n=0),
                        atoms_p=AtomTable(mass=None, elem=None, n=None),
                        M_a=0, M_p=None)
STATS_SPEC = RunStats(**{f.name: None for f in dataclasses.fields(RunStats)}
                      | dict(a_sum=0, a_sumsq=0, pump=0, snap_a=0))


def pad_to_multiple(D: np.ndarray, S: Optional[np.ndarray], n: int):
    """Pad the gene axis to a multiple of n. Padded rows get invS2 = 0
    downstream => they are exact no-ops in every likelihood term."""
    G = D.shape[0]
    pad = (-G) % n
    if pad == 0:
        return D, S, G
    D2 = np.concatenate([D, np.zeros((pad, D.shape[1]), D.dtype)], axis=0)
    if S is None:
        S = dense.default_uncertainty(D)
    S2 = np.concatenate([S, np.full((pad, D.shape[1]), 1.0, np.float32)],
                        axis=0)
    return D2, S2, G


class ShardedRandom:
    """The sharded engines' random streams (the module docstring): unit
    u of the A sampler under its unit word, the P sampler under the
    seed."""

    def __init__(self, seed: int, device):
        self.seed = int(seed) & 0xFFFFFFFF
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def unit_word(self, unit: int) -> int:
        return (self.seed + unit * UNIT_STEP) & 0xFFFFFFFF

    def _poisson(self, word: int, key: int, n: torch.Tensor) -> torch.Tensor:
        self.generator.manual_seed((word << 32) | key)
        return gaps_rng.poisson(torch.clamp(n, min=10).to(torch.float32),
                                self.generator)

    def budgets(self, phase: int, it: int, n_a: torch.Tensor,
                n_p: torch.Tensor, units):
        """((len(units),), (1,)) budgets from the atom counts of the A
        sampler's units and of the P sampler, one draw each."""
        key = stream_key(phase, it, BUDGETS)
        n_units = torch.cat([self._poisson(self.unit_word(u), key,
                                           n_a[j:j + 1])
                             for j, u in enumerate(units)])
        return n_units, self._poisson(self.seed, stream_key(
            phase, it, BUDGET_P), n_p)

    def sweeps(self, phase: int, it: int, sampler: int, units=None):
        if sampler == SAMPLER_A:
            words = [self.unit_word(u) for u in units]
        else:
            words = [self.seed]
        return PhiloxKey(torch.tensor(words, dtype=torch.int64,
                                      device=self.device),
                         stream_key(phase, it, sampler))


def unit_stats(cfg: EngineConfig, n_units: int, rows: int, n_samples: int,
               hist, device) -> RunStats:
    """Zero statistics of a unit-stacked chain: n_units blocks of `rows`
    rows on the A side."""
    return to_units(init_run_stats(cfg, 1, n_units * rows, n_samples, hist,
                                   device), n_units)


def to_units(stats: RunStats, n_units: int) -> RunStats:
    """One chain's statistics ((1, n_units * rows, k) on the A side) as a
    unit-stacked chain's ((n_units, rows, k); snap_a (n_units, n_snap,
    rows, k))."""
    rows, k = stats.a_sum.shape[-2] // n_units, stats.a_sum.shape[-1]

    def units(t):
        return t.reshape(n_units, rows, k)

    snap = stats.snap_a[0]
    snap = snap.reshape(snap.shape[0], n_units, rows, k).transpose(0, 1)
    return dataclasses.replace(stats, a_sum=units(stats.a_sum),
                               a_sumsq=units(stats.a_sumsq),
                               pump=units(stats.pump),
                               snap_a=snap.contiguous())


def accumulate(cfg, hist, mesh, phase, it, state: ChainState,
               stats: RunStats, done_a, done_p, obs_a, obs_p, chisq_parts):
    """engine.accumulate_stats for a unit-stacked chain: the A sampler's
    counters (done, sweeps, proposals, accepts) and atom counts summed
    over the rank's units and then over the ranks, in one integer sum;
    chi^2 the ordered sum of `chisq_parts()`, one value a unit."""
    parts = [done_a.sum()[None], state.atoms_a.n.sum()[None]]
    if obs_a is not None:
        ns, cnt = obs_a
        parts += [ns.sum()[None], cnt.processed.sum(0), cnt.accepted.sum(0)]
    tot = multihost.sum_ints(torch.cat([p.to(torch.int64) for p in parts]),
                             mesh).to(torch.int32)
    if obs_a is not None:
        obs_a = (tot[2:3], SweepCounts(processed=tot[3:7][None],
                                       accepted=tot[7:11][None]))

    def chisq_fn():
        return multihost.ordered_sum(chisq_parts(), mesh)

    return accumulate_stats(cfg, hist, phase, it, state.M_a, state.M_p,
                            tot[1:2], state.atoms_p.n, tot[0:1], done_p,
                            stats, chisq_fn, obs_a=obs_a, obs_p=obs_p)


def unit_mass(lam: float, mgm: float, n: int, device) -> MassParams:
    """The mass parameters of n chains of one sampler (lambda and
    maxGibbsMass / lambda, float32)."""
    return MassParams(
        lam=torch.full((n,), lam, dtype=torch.float32, device=device),
        max_gibbs_mass=torch.full((n,), mgm / lam, dtype=torch.float32,
                                  device=device))


def checkpoint_extra(path_prefix: str) -> dict:
    """The `extra_*` entries of a per-rank checkpoint, as ints."""
    with np.load(multihost.shard_files(path_prefix)[0]) as z:
        return {k[6:]: int(z[k]) for k in z.files if k.startswith("extra_")}


def block_tables(D, invS2, M, other):
    """dense.tables of each block of a rank, (DenseCache, DensePhase) with
    the blocks as the leading dimension; M and other have the blocks' or
    a leading dimension of one. On the card one call (the kernel's plan
    takes no chain count); on the CPU a call per block, each the same
    product on every rank count."""
    if D.device.type == "cuda":
        return dense.tables(D, invS2, M, other)
    caches, phases = zip(*[
        dense.tables(D[j], invS2[j], M[j % M.shape[0]],
                     other[j % other.shape[0]]) for j in range(D.shape[0])])
    return (dense.DenseCache(Y=torch.stack([c.Y for c in caches])),
            dense.DensePhase(*(torch.stack(x) for x in zip(*phases))))


class UnitChain:
    """What the gene-sharded engines share: one chain whose A side is
    cut into units (row blocks or gene shards), the replicated P
    sampler's update call, the phase loop, the padding's trim and the
    checkpoint's writer. A subclass provides iteration(), p_tables()
    and its A sampler."""

    def p_call(self, atoms_p: AtomTable, M_p: torch.Tensor,
               M_a: torch.Tensor, temp, n_p, key) -> tuple:
        """The arguments of the P sampler's one sweep-kernel call
        (ops/sweep_cuda.run_updates_multi) on tables of the updated
        M_a; the same on every rank."""
        Y, phase = self.p_tables(M_a, M_p)
        return (atoms_p, M_p, Y, phase, temp, n_p, self.consts_p,
                self.mass_p, key)

    def run_phase(self, state: ChainState, stats: RunStats, rand,
                  phase: int, start_iter: int = 0,
                  stop_iter: Optional[int] = None):
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        for it in range(start_iter, stop):
            state, stats = self.iteration(state, stats, rand, phase, it)
        return state, stats

    def trim(self, arr) -> np.ndarray:
        """Rows of a gathered A-side array ((n_units, rows, k) or
        (n_genes, k)) with the gene-axis padding stripped."""
        arr = np.asarray(arr)
        return arr.reshape(-1, arr.shape[-1])[: self.n_genes_orig]

    def _save(self, path_prefix: str, state, stats, phase: int, it: int,
              seed: int, **extra) -> str:
        """This rank's units of (state, stats) after iteration `it` of
        `phase`, with the run's seed, shape and `extra` layout fields."""
        return multihost.save_sharded_checkpoint(
            path_prefix, (state, stats),
            extra={"phase": np.int32(phase), "iter": np.int32(it),
                   "seed": np.int64(seed),
                   "n_genes": np.int64(self.n_genes_orig),
                   "n_samples": np.int64(self.n_samples),
                   "k": np.int32(self.config.n_patterns)} | extra,
            spec=(STATE_SPEC, STATS_SPEC), mesh=self.mesh)


class ShardedGapsEngine(UnitChain):
    """One dense chain whose genes are cut into n_blocks row blocks, the
    rank's contiguous group of them on `device`. Results are invariant to
    the rank count for a fixed n_blocks. `mesh` is a
    multihost.ProcessMesh, or None for one rank holding every block."""

    def __init__(self, D: np.ndarray, S: Optional[np.ndarray],
                 config: EngineConfig,
                 mesh: Optional[multihost.ProcessMesh] = None,
                 n_blocks: Optional[int] = None, device="cuda"):
        self.device = device = torch.device(device)
        self.mesh = mesh
        size = mesh.size if mesh is not None else 1
        self.n_blocks = int(n_blocks or max(8, size))
        if self.n_blocks % size != 0:
            raise ValueError("n_blocks must be a multiple of the rank count")
        self.blocks = multihost.local_units(self.n_blocks, mesh)
        bpd = len(self.blocks)

        D = np.asarray(D, np.float32)
        D, S, self.n_genes_orig = pad_to_multiple(D, S, self.n_blocks)
        if S is None:
            S = dense.default_uncertainty(D)
        S = np.asarray(S, np.float32)
        inv = (1.0 / (S * S)).astype(np.float32)
        inv[self.n_genes_orig:] = 0.0  # padded rows contribute nothing

        self.n_genes, self.n_samples = D.shape
        self.g_blk = self.n_genes // self.n_blocks
        self.config = config
        self.hist = derive_hist(config)
        k = config.n_patterns

        lam_a = dense.compute_lambda(D[: self.n_genes_orig], config.alpha_a, k)
        lam_p = dense.compute_lambda(D[: self.n_genes_orig], config.alpha_p, k)
        self.lam_a, self.lam_p = lam_a, lam_p

        self.mass_a = unit_mass(lam_a, config.max_gibbs_mass_a, bpd, device)
        self.mass_p = unit_mass(lam_p, config.max_gibbs_mass_p, 1, device)

        # per-BLOCK A consts (block-local bins, capacity and batch) and the
        # replicated P consts
        self.cap_blk = max(256, config.capacity_a // self.n_blocks)
        self.batch_blk = max(32, config.batch_a // self.n_blocks)
        self.consts_a = make_consts(
            self.g_blk, self.n_samples, k, self.cap_blk, self.batch_blk,
            config.alpha_a, local_moves=config.local_moves)
        self.consts_p = make_consts(
            self.n_samples, self.n_genes, k, config.capacity_p,
            config.batch_p, config.alpha_p, local_moves=config.local_moves)

        # the rank's blocks, each with its transposed copies
        rows = slice(self.blocks.start * self.g_blk,
                     self.blocks.stop * self.g_blk)

        def blocks(x):
            return x[rows].reshape(bpd, self.g_blk, self.n_samples)

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        self.D, self.invS2 = t(blocks(D)), t(blocks(inv))
        self.D_t = self.D.transpose(1, 2).contiguous()
        self.invS2_t = self.invS2.transpose(1, 2).contiguous()

    # ------------------------------------------------------------------
    def init_state(self, fixed_patterns=None) -> ChainState:
        k = self.config.n_patterns
        bpd, dev = len(self.blocks), self.device
        M_a = torch.zeros((bpd, self.g_blk, k), dtype=torch.float32,
                          device=dev)
        M_p = torch.zeros((1, self.n_samples, k), dtype=torch.float32,
                          device=dev)
        if self.config.which_matrix_fixed == "A":
            fp = np.zeros((self.n_genes, k), np.float32)
            fp[: self.n_genes_orig] = np.asarray(fixed_patterns, np.float32)
            lo = self.blocks.start * self.g_blk
            M_a = torch.as_tensor(fp[lo:lo + bpd * self.g_blk].reshape(
                bpd, self.g_blk, k), device=dev)
        elif self.config.which_matrix_fixed == "P":
            M_p = torch.as_tensor(np.asarray(fixed_patterns, np.float32)[None],
                                  device=dev)
        return ChainState(atoms_a=init_atoms(self.cap_blk, bpd, dev),
                          atoms_p=init_atoms(self.config.capacity_p, 1, dev),
                          M_a=M_a, M_p=M_p)

    def init_stats(self) -> RunStats:
        return unit_stats(self.config, len(self.blocks), self.g_blk,
                          self.n_samples, self.hist, self.device)

    # ------------------------------------------------------------------
    def a_call(self, state: ChainState, n_a, temp, key) -> tuple:
        """The arguments of the A sampler's one K1 call, the rank's blocks
        as its chains: each block's tables from its rows against the
        replicated P, the blocks the chains of one tables call."""
        cache, phase = block_tables(self.D, self.invS2, state.M_a,
                                    state.M_p)
        phase = phase._replace(col_nz=phase.col_nz.expand(
            len(self.blocks), -1).contiguous())
        return (state.atoms_a, state.M_a, cache.Y, phase, temp, n_a,
                self.consts_a, self.mass_a, key)

    def update_a(self, state: ChainState, n_a, temp, key):
        atoms, M, _, done, ns, cnt = run_updates_multi(
            *self.a_call(state, n_a, temp, key))
        return atoms, M, done, (ns, cnt)

    def p_tables(self, M_a: torch.Tensor, M_p: torch.Tensor):
        """The replicated P sampler's tables, (Y, DensePhase) with a
        leading dimension of 1: each block's partial
        dense.tables(D_b^T, invS2_b^T, M_p, M_a_b), added in block order;
        col_nz from the max over every block."""
        cache, phase = block_tables(self.D_t, self.invS2_t, M_p, M_a)
        parts = [(cache.Y[j], phase.SQ[j], phase.Z[j])
                 for j in range(len(self.blocks))]
        col_max = multihost.max_all(M_a.amax(dim=(0, 1)), self.mesh)

        def total(i):
            return multihost.ordered_sum([part[i] for part in parts],
                                         self.mesh)[None]

        Y = total(0)
        phase = dense.DensePhase(SQ=total(1), Z=total(2),
                                 col_nz=(col_max > 0.0)[None])
        return Y, phase

    def chisq_parts(self, M_a: torch.Tensor, M_p: torch.Tensor) -> list:
        """chi^2 of each of the rank's blocks."""
        return [dense.chisq_from_state(self.D[j], self.invS2[j], M_a[j],
                                       M_p[0])
                for j in range(len(self.blocks))]

    def iteration(self, state: ChainState, stats: RunStats, rand,
                  phase: int, it: int):
        """One iteration (cogaps_tpu/parallel/sharded.py::_iteration): the
        A sampler's blocks, then the P sampler against the updated A, then
        the statistics. `rand` is a ShardedRandom (or the tests' injected
        draws)."""
        cfg = self.config
        fixed = cfg.which_matrix_fixed
        temp = annealing_temp(cfg, phase, it)
        n_a, n_p = rand.budgets(phase, it, state.atoms_a.n, state.atoms_p.n,
                                self.blocks)
        atoms_a, M_a, atoms_p, M_p = (state.atoms_a, state.M_a,
                                      state.atoms_p, state.M_p)
        done_a = torch.zeros(len(self.blocks), dtype=torch.int32,
                             device=self.device)
        done_p = torch.zeros(1, dtype=torch.int32, device=self.device)
        obs_a = obs_p = None
        if fixed != "A":
            atoms_a, M_a, done_a, obs_a = self.update_a(
                state, n_a, temp, rand.sweeps(phase, it, SAMPLER_A,
                                              self.blocks))
        if fixed != "P":
            atoms_p, M_p, _, done_p, ns, cnt = run_updates_multi(
                *self.p_call(atoms_p, M_p, M_a, temp, n_p,
                             rand.sweeps(phase, it, SAMPLER_P)))
            obs_p = (ns, cnt)
        state = ChainState(atoms_a=atoms_a, atoms_p=atoms_p, M_a=M_a, M_p=M_p)
        stats = accumulate(cfg, self.hist, self.mesh, phase, it, state,
                           stats, done_a, done_p, obs_a, obs_p,
                           lambda: self.chisq_parts(M_a, M_p))
        return state, stats

    # ------------------------------------------------------------------
    # per-rank checkpoints (cogaps_tpu/parallel/sharded.py:426-456): each
    # rank writes its blocks; a resume may use another rank count
    def save_checkpoint(self, path_prefix: str, state, stats, phase: int,
                        it: int, seed: int) -> str:
        return self._save(path_prefix, state, stats, phase, it, seed,
                          n_blocks=np.int32(self.n_blocks))

    def load_checkpoint(self, path_prefix: str):
        """(state, stats, phase, iter, seed): this rank's blocks of a
        checkpoint written on any rank count."""
        extra = checkpoint_extra(path_prefix)
        if extra["n_blocks"] != self.n_blocks:
            raise ValueError(f"checkpoint has n_blocks={extra['n_blocks']}, "
                             f"engine has {self.n_blocks}")
        spec = (STATE_SPEC, STATS_SPEC)
        state, stats = multihost.load_sharded_checkpoint(
            path_prefix, spec, spec, self.mesh)
        return (multihost.to_device(state, self.device),
                multihost.to_device(stats, self.device),
                extra["phase"], extra["iter"], extra["seed"])
