"""Gene-sharded sparse-model chain — the PyTorch counterpart of
cogaps_tpu/parallel/sparse_sharded.py: the atlas-scale configuration
(SURVEY.md §7.10 — 1M cells x 30k genes, k=50, sparse, sharded).

The sparse data model (models/sparse.py; the reference's
SparseNormalModel closed forms, src/gibbs_sampler/SparseNormalModel.cpp:
153-311) on the gene-sharded execution of parallel/sharded.py:

* the gene axis is cut into `n_shards` shards of g_local rows (padded to
  a multiple of n_shards); n_shards plays the part of the JAX mesh's
  device count, and a rank holds a contiguous group of shards, so one
  card with n_shards=4 reproduces JAX's 4-device mesh. Each shard has a
  gene-major CSR over its local rows and a sample-major CSR over its
  local genes: no rank holds the matrix of another rank's shards;
* A sampler — local to each shard: the shard's rows against the
  replicated P, its proposal stream keyed by the shard id
  (sharded.ShardedRandom; JAX folds in the device index). The update
  is the sparse engine's own for the shard's rows, in the mode that
  sparse_engine.resolve_sparse_mode picks at one shard's size: K2 on
  tables built a shard at a time ("dense", "ell"), or K4 on the CSR rows
  ("xla"). The rank's shards are the chains of one launch;
* tables — on the card both table modes build every shard's tables of a
  sampler in one launch of the sparse tables kernel on the shards' CSR
  rows (ops/sparse_tables_cuda, csrc/sparse_tables.cu), the shards as its
  chains; on the CPU a shard at a time by models/sparse.kernel_tables
  ("dense") or kernel_tables_ell ("ell");
* memory — on the card every mode keeps the matrix sparse on the device.
  On the CPU "dense" also holds each of the rank's shards densified: its
  two (g_local, S) float32 weight matrices (sparse.dense_weights), 8 *
  g_local * S bytes a shard. The rule admits "dense" when ONE shard's
  weights and tables fit in sparse_engine.MEMORY_SHARE of the device's
  memory (the weights term as the JAX package counts it, also on the
  card);
* P sampler — replicated, on tables summed over shards: every
  closed-form term (the "all elements" parts through Z2 and the
  nonzero corrections) is additive over genes, so each shard builds its
  partial (SQ, Y0, G) from its genes (the sparse tables kernel; on the
  CPU kernel_tables or kernel_tables_ell), multihost.ordered_sum adds
  them in shard order,
  and one K2 launch runs, identical on every rank. JAX instead psums
  each sweep's alpha terms (_psum_model): the same sums, rounded in
  another order;
* chi^2 — additive over genes, an ordered sum of each shard's closed
  form.

Padding: the sparse model's implied uncertainty attaches S = 0.1 to
every zero, so padded gene rows are zero OBSERVATIONS rather than exact
no-ops (the dense sharded engine's invS2 = 0 has no sparse analog), as
in the JAX package; at most n_shards - 1 rows are added.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..engine import (SAMPLER_A, SAMPLER_P, ChainState, RunStats,
                      annealing_temp, derive_hist)
from ..io.coo import CooMatrix
from ..models import dense, sparse
from ..ops.atlas_cuda import run_updates_atlas_multi
from ..ops.atoms import AtomTable, init_atoms
from ..ops.sparse_tables_cuda import sparse_tables
from ..ops.sweep import make_consts
from ..ops.sweep_cuda import run_updates_multi
from ..params import EngineConfig
from ..sparse_engine import resolve_sparse_mode
from . import multihost
from .sharded import (STATE_SPEC, STATS_SPEC, UnitChain, accumulate,
                      checkpoint_extra, unit_mass, unit_stats)


def atlas_memory_plan(n_cells: int, n_genes: int, k: int, density: float,
                      n_devices: int) -> dict:
    """Per-device memory budget (bytes) for the atlas configuration —
    the planning artifact for SURVEY.md §7.10; a copy of
    cogaps_tpu/parallel/sparse_sharded.atlas_memory_plan."""
    nnz = int(n_cells * n_genes * density)
    g_local = -(-n_cells // n_devices)  # long axis sharded
    ell_rows = nnz // n_devices * 8  # idx int32 + val fp32
    return {
        "A_shard": g_local * k * 4,
        "P_replicated": n_genes * k * 4,
        "ell_gene_major": ell_rows,
        "ell_sample_major": ell_rows,
        "atoms_local": 2 * max(4096, 2 * g_local * k // 4) * 8,
        "total_per_device": (g_local * k * 4 + n_genes * k * 4
                             + 2 * ell_rows
                             + 2 * max(4096, 2 * g_local * k // 4) * 8),
    }


class SparseShardedEngine(UnitChain):
    """One sparse chain whose genes are cut into n_shards shards, the
    rank's contiguous group of them on `device`. `coo` is a CooMatrix
    (genes x samples), densified only in "dense" mode on the CPU (the
    module docstring). `mesh` is a multihost.ProcessMesh, or None for one
    rank holding every shard; n_shards defaults to the rank count."""

    def __init__(self, coo: CooMatrix, config: EngineConfig,
                 mesh: Optional[multihost.ProcessMesh] = None,
                 n_shards: Optional[int] = None, device="cuda"):
        self.device = device = torch.device(device)
        self.mesh = mesh
        size = mesh.size if mesh is not None else 1
        self.n_shards = int(n_shards or size)
        if self.n_shards % size != 0:
            raise ValueError("n_shards must be a multiple of the rank count")
        self.shards = multihost.local_units(self.n_shards, mesh)
        spr = len(self.shards)
        G, S = coo.shape
        Gp = -(-G // self.n_shards) * self.n_shards
        self.n_genes_orig, self.n_genes, self.n_samples = G, Gp, S
        self.g_local = Gp // self.n_shards
        self.config = config
        self.hist = derive_hist(config)
        k = config.n_patterns

        rows = np.asarray(coo.rows, np.int64)
        cols = np.asarray(coo.cols, np.int64)
        vals = np.asarray(coo.vals, np.float32)
        if np.any(vals < 0):
            raise ValueError("negative values in data matrix")
        nnz_mean = float(vals.mean()) if len(vals) else 1.0
        self.lam_a = float(config.alpha_a) * float(np.sqrt(k / nnz_mean))
        self.lam_p = float(config.alpha_p) * float(np.sqrt(k / nnz_mean))

        self.mass_a = unit_mass(self.lam_a, config.max_gibbs_mass_a, spr,
                                device)
        self.mass_p = unit_mass(self.lam_p, config.max_gibbs_mass_p, 1,
                                device)
        self.data_sparsity = 1.0 - len(vals) / max(G * S, 1)

        # the rank's shards: gene-major rows over local rows, sample-major
        # rows over local genes
        shard = rows // self.g_local
        a_side, p_side = [], []
        for d in self.shards:
            m = shard == d
            r_loc = rows[m] - d * self.g_local
            a_side.append((r_loc, cols[m], vals[m]))
            p_side.append((cols[m], r_loc, vals[m]))
        csr_a = sparse.stack_csr(a_side, self.g_local)
        csr_p = sparse.stack_csr(p_side, S)

        self.cap_a_local = max(256, config.capacity_a // self.n_shards)
        # as cogaps_tpu/parallel/sparse_sharded.py: the default
        # local_moves, the full batch, the padded gene count on P's side
        self.consts_a = make_consts(self.g_local, S, k, self.cap_a_local,
                                    config.batch_a, config.alpha_a)
        self.consts_p = make_consts(S, Gp, k, config.capacity_p,
                                    config.batch_p, config.alpha_p)
        # the mode at one shard's size, so that it is the same on every
        # rank count
        self.mode = config.sparse_table_mode or resolve_sparse_mode(
            1, self.g_local, S, k, device)
        if self.mode not in ("dense", "ell", "xla"):
            raise ValueError(f"unknown sparse_table_mode {self.mode!r}")
        self.Wd = self.D1 = None
        if self.mode == "dense" and device.type != "cuda":
            Wd, D1 = sparse.dense_weights(csr_a, S)
            self.Wd, self.D1 = Wd.to(device), D1.to(device)
        self.csr_a, self.csr_p = csr_a.to(device), csr_p.to(device)

    # ------------------------------------------------------------------
    def init_state(self) -> ChainState:
        k, dev = self.config.n_patterns, self.device
        spr = len(self.shards)
        return ChainState(
            atoms_a=init_atoms(self.cap_a_local, spr, dev),
            atoms_p=init_atoms(self.config.capacity_p, 1, dev),
            M_a=torch.zeros((spr, self.g_local, k), dtype=torch.float32,
                            device=dev),
            M_p=torch.zeros((1, self.n_samples, k), dtype=torch.float32,
                            device=dev))

    def init_stats(self) -> RunStats:
        return unit_stats(self.config, len(self.shards), self.g_local,
                          self.n_samples, self.hist, self.device)

    # ------------------------------------------------------------------
    def _side_tables(self, p_side: bool, M_a, M_p) -> tuple:
        """Every shard's (SQ, Y0, G) tables of one sampler, stacked: the A
        sampler's over each shard's rows, or each shard's partial of the
        P sampler's over its genes. On the card one launch of the sparse
        tables kernel, the shards as its chains; on the CPU a shard at a
        time."""
        if self.device.type == "cuda":
            if p_side:
                return sparse_tables(self.csr_p, M_a, M_p)
            return sparse_tables(self.csr_a, M_p, M_a)
        return tuple(torch.stack(x) for x in zip(*[
            self._tables(j, p_side, M_a, M_p)
            for j in range(len(self.shards))]))

    def _tables(self, j: int, p_side: bool, M_a, M_p):
        """Shard j's (SQ, Y0, G) tables of one sampler on the CPU: the A
        sampler's over the shard's rows, or the shard's partial of the P
        sampler's over its genes."""
        if p_side:
            other, M = M_a[j], M_p[0]
        else:
            other, M = M_p[0], M_a[j]
        if self.mode == "dense":
            Wd, D1 = self.Wd[j], self.D1[j]
            if p_side:
                Wd, D1 = Wd.T, D1.T
            return sparse.kernel_tables(Wd, D1, other, M)
        csr = self.csr_p if p_side else self.csr_a
        return sparse.kernel_tables_ell(csr.ell(j), other, M)

    def a_call(self, state: ChainState, n_a, temp, key) -> tuple:
        """The arguments of the A sampler's one launch, the rank's shards
        as its chains: K4's (ops/atlas_cuda.run_updates_atlas_multi) over
        the CSR rows in "xla" mode, else K2's (ops/sweep_cuda.
        run_updates_multi) on each shard's tables (_side_tables)."""
        spr = len(self.shards)
        if self.mode == "xla":
            other = state.M_p.expand(spr, -1, -1).contiguous()
            return (state.atoms_a, state.M_a, self.csr_a, other, temp, n_a,
                    self.consts_a, self.mass_a, key)
        SQ, Y0, G = self._side_tables(False, state.M_a, state.M_p)
        col_nz = (state.M_p.amax(dim=1) > 0.0).expand(spr, -1).contiguous()
        return (state.atoms_a, state.M_a, Y0,
                dense.DensePhase(SQ=SQ, Z=G, col_nz=col_nz), temp, n_a,
                self.consts_a, self.mass_a, key)

    def update_a(self, state: ChainState, n_a, temp, key):
        """The A sampler: (atoms, M, done, sweeps, counts)."""
        args = self.a_call(state, n_a, temp, key)
        if self.mode == "xla":
            return run_updates_atlas_multi(*args)
        atoms, M, _, done, ns, cnt = run_updates_multi(*args)
        return atoms, M, done, ns, cnt

    def p_parts(self, M_a: torch.Tensor, M_p: torch.Tensor) -> list:
        """Each of the rank's shards' partial (SQ, Y0, G) of the P
        sampler's tables, from its genes."""
        return list(zip(*self._side_tables(True, M_a, M_p)))

    def sum_p_parts(self, parts: list, M_a: torch.Tensor):
        """The replicated P sampler's tables (Y0, DensePhase), leading
        dimension 1: the shards' partials added in shard order; col_nz
        from the max over every shard."""
        col_max = multihost.max_all(M_a.amax(dim=(0, 1)), self.mesh)
        SQ, Y0, G = (multihost.ordered_sum([p[i] for p in parts],
                                           self.mesh)[None]
                     for i in range(3))
        return Y0, dense.DensePhase(SQ=SQ, Z=G,
                                    col_nz=(col_max > 0.0)[None])

    def p_tables(self, M_a: torch.Tensor, M_p: torch.Tensor):
        return self.sum_p_parts(self.p_parts(M_a, M_p), M_a)

    def chisq_parts(self, M_a: torch.Tensor, M_p: torch.Tensor) -> list:
        """The closed-form chi^2 of each of the rank's shards."""
        return [sparse.sparse_chisq(self.csr_a, M_a[j], M_p[0], chain=j)
                for j in range(len(self.shards))]

    def iteration(self, state: ChainState, stats: RunStats, rand,
                  phase: int, it: int):
        """One iteration (cogaps_tpu/parallel/sparse_sharded.py::
        _iteration): the A sampler on every shard, then the P sampler on
        the summed tables of the updated A, then the statistics."""
        cfg = self.config
        temp = annealing_temp(cfg, phase, it)
        n_a, n_p = rand.budgets(phase, it, state.atoms_a.n, state.atoms_p.n,
                                self.shards)
        atoms_a, M_a, done_a, ns_a, cnt_a = self.update_a(
            state, n_a, temp, rand.sweeps(phase, it, SAMPLER_A, self.shards))
        atoms_p, M_p, _, done_p, ns_p, cnt_p = run_updates_multi(
            *self.p_call(state.atoms_p, state.M_p, M_a, temp, n_p,
                         rand.sweeps(phase, it, SAMPLER_P)))
        state = ChainState(atoms_a=atoms_a, atoms_p=atoms_p, M_a=M_a, M_p=M_p)
        stats = accumulate(cfg, self.hist, self.mesh, phase, it, state,
                           stats, done_a, done_p, (ns_a, cnt_a),
                           (ns_p, cnt_p),
                           lambda: self.chisq_parts(M_a, M_p))
        return state, stats

    # ------------------------------------------------------------------
    # per-rank checkpoints (cogaps_tpu/parallel/sparse_sharded.py:
    # 322-364). The A atom tables are shard-local (elem = local_row * k +
    # c), so a resume on another shard count re-bins them through global
    # element ids (_rebin_atoms_a)
    def save_checkpoint(self, path_prefix: str, state, stats, phase: int,
                        it: int, seed: int) -> str:
        return self._save(path_prefix, state, stats, phase, it, seed,
                          n_shards=np.int32(self.n_shards),
                          g_local=np.int64(self.g_local),
                          cap_a_local=np.int64(self.cap_a_local))

    def load_checkpoint(self, path_prefix: str):
        """(state, stats, phase, iter, seed): this rank's shards of a
        checkpoint written on any rank count and any shard count (the A
        side re-binned to this engine's shards when they differ)."""
        extra = checkpoint_extra(path_prefix)
        for name, mine in (("n_genes", self.n_genes_orig),
                           ("n_samples", self.n_samples),
                           ("k", self.config.n_patterns)):
            if extra[name] != int(mine):
                raise ValueError(f"checkpoint {name}={extra[name]} does "
                                 f"not match engine {name}={mine}")
        spec = (STATE_SPEC, STATS_SPEC)
        state, stats = multihost.load_sharded_checkpoint(path_prefix, spec)
        if extra["n_shards"] != self.n_shards:
            state, stats = self._reshard(state, stats, extra["n_shards"],
                                         extra["g_local"],
                                         extra["cap_a_local"])
        state, stats = multihost.local_part((state, stats), spec, self.mesh)
        return (multihost.to_device(state, self.device),
                multihost.to_device(stats, self.device),
                extra["phase"], extra["iter"], extra["seed"])

    def _reshard(self, state, stats, old_ns: int, old_gloc: int,
                 old_cap: int):
        """A full checkpoint tree of old_ns shards of old_gloc rows as
        this engine's shards: the A-side rows (M_a, a_sum, a_sumsq, pump,
        snap_a) re-cut, keeping the rows both layouts have, and the A
        atoms re-binned."""
        keep = min(old_ns * old_gloc, self.n_genes)

        def rows(arr):  # (old_ns, *mid, old_gloc, k) -> this layout
            a = np.moveaxis(arr, 0, -3)
            a = a.reshape(a.shape[:-3] + (old_ns * old_gloc, a.shape[-1]))
            out = np.zeros(a.shape[:-2] + (self.n_genes, a.shape[-1]),
                           a.dtype)
            out[..., :keep, :] = a[..., :keep, :]
            out = out.reshape(a.shape[:-2] + (self.n_shards, self.g_local,
                                              a.shape[-1]))
            return np.moveaxis(out, -3, 0)

        state = dataclasses.replace(
            self._rebin_atoms_a(state, old_ns, old_gloc, old_cap, keep),
            M_a=rows(state.M_a))
        stats = dataclasses.replace(
            stats, **{f: rows(getattr(stats, f))
                      for f in ("a_sum", "a_sumsq", "pump", "snap_a")})
        return state, stats

    def _rebin_atoms_a(self, state, old_ns: int, old_gloc: int,
                       old_cap: int, keep_rows: Optional[int] = None):
        """Re-shard the shard-local A atom tables onto this engine's shard
        count (host-side; local elem -> global elem -> new local), as
        cogaps_tpu/parallel/sparse_sharded._rebin_atoms_a does; atoms on
        rows at or past `keep_rows` (padding that this layout lacks) are
        dropped with those rows."""
        k = self.config.n_patterns
        mass = np.asarray(state.atoms_a.mass).reshape(old_ns, old_cap)
        elem = np.asarray(state.atoms_a.elem).reshape(old_ns, old_cap)
        ns = np.asarray(state.atoms_a.n).reshape(old_ns)
        g_elem = np.concatenate(
            [elem[d, :int(ns[d])].astype(np.int64) + d * old_gloc * k
             for d in range(old_ns)] + [np.zeros(0, np.int64)])
        g_mass = np.concatenate([mass[d, :int(ns[d])] for d in range(old_ns)]
                                + [np.zeros(0, np.float32)])
        if keep_rows is not None:
            live = g_elem < keep_rows * k
            g_elem, g_mass = g_elem[live], g_mass[live]
        new_mass = np.zeros((self.n_shards, self.cap_a_local), np.float32)
        new_elem = np.full((self.n_shards, self.cap_a_local), -1, np.int32)
        new_n = np.zeros((self.n_shards,), np.int32)
        dev = g_elem // (self.g_local * k)
        loc = g_elem - dev * (self.g_local * k)
        for d in range(self.n_shards):
            m = dev == d
            cnt = int(m.sum())
            if cnt > self.cap_a_local:
                raise ValueError(
                    f"shard {d} needs {cnt} atom slots, capacity is "
                    f"{self.cap_a_local}")
            new_elem[d, :cnt] = loc[m].astype(np.int32)
            new_mass[d, :cnt] = g_mass[m]
            new_n[d] = cnt
        return dataclasses.replace(state, atoms_a=AtomTable(
            mass=new_mass, elem=new_elem, n=new_n))
