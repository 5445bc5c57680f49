"""Sparse-model engines — the PyTorch counterpart of
cogaps_tpu/sparse_engine.py.

The same two-phase annealed MCMC as engine.py, with the sparse data
model (models/sparse.py): the nonzeros in CSR order in both
orientations, the partner-factor tables regenerated at every sampler
call (reference: SparseNormalModel.cpp:294-311, GapsRunner.cpp:202-222),
no residual cache and the closed-form chi^2. Custom uncertainty is not
supported: the model assumes the implied default (reference:
R/HelperFunctions.R:223-224).

Each sampler's update call runs in one of three modes (the names are
the JAX package's, so EngineConfig.sparse_table_mode overrides work):

* "dense" — (SQ, Y0, G) tables, then the dense sweep kernel with G in
  the Z table's place (ops/sweep_cuda, csrc/sweep.cu: the port of the
  TPU kernel's tables mode, K2); on the CPU the tables come from dense
  (G x S) weight matrices (models/sparse.kernel_tables);
* "ell"   — the same tables and kernel; on the CPU the tables come from
  each chain's rows without dense weights (models/sparse.
  kernel_tables_ell);
* "xla"   — no tables: the CSR sweep kernel (ops/atlas_cuda, csrc/
  atlas.cu, K4) on CUDA tensors; the plain sparse sweep on the CPU.

On CUDA tensors both table modes build the tables from the CSR rows in
one launch of the sparse tables kernel (ops/sparse_tables_cuda, csrc/
sparse_tables.cu), and hold no dense weights; every call launches its
kernels or raises.
The default mode is chosen from the memory each mode needs on the
device (resolve_sparse_mode); PERF.md states the rule with the card's
measured iteration times of each mode.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .engine import (SAMPLER_A, SAMPLER_P, ChainEngine,
                     ChainState, HistConfig, RunStats, accumulate_stats,
                     annealing_temp, build_consts, derive_hist)
from .io.coo import CooMatrix
from .models import dense, sparse
from .ops.atlas_cuda import run_updates_atlas_multi
from .ops.sparse_tables_cuda import sparse_tables
from .ops.sweep import MassParams, SamplerConsts
from .ops.sweep_cuda import run_updates_multi
from .params import EngineConfig

SPARSE_MODES = ("dense", "ell", "xla")
# share of the device's memory a mode's tables and weights may take
MEMORY_SHARE = 0.5


@dataclasses.dataclass
class SparseDeviceData:
    """Device-resident sparse data of NCH chains: the nonzeros in both
    orientations, the data-derived mass-prior parameters, and, in
    "dense" mode on the CPU, the dense weight matrices kernel_tables
    reads."""

    csr_a: sparse.CsrMatrix  # gene-major rows (A sampler)
    csr_p: sparse.CsrMatrix  # sample-major rows (P sampler)
    mass_a: MassParams  # (NCH,) each
    mass_p: MassParams
    Wd_a: Optional[torch.Tensor] = None  # (NCH, G, S) or None
    D1_a: Optional[torch.Tensor] = None

    def to(self, device) -> "SparseDeviceData":
        opt = (lambda t: None if t is None else t.to(device))  # noqa: E731
        return SparseDeviceData(
            csr_a=self.csr_a.to(device), csr_p=self.csr_p.to(device),
            mass_a=MassParams(*(x.to(device) for x in self.mass_a)),
            mass_p=MassParams(*(x.to(device) for x in self.mass_p)),
            Wd_a=opt(self.Wd_a), D1_a=opt(self.D1_a))


def device_memory_bytes(device) -> int:
    """Total memory of `device`: the card's, or the host's for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def mode_bytes(n_chains: int, n_genes: int, n_samples: int, k: int) -> dict:
    """Device bytes each mode needs beyond the CSR data and the factors:
    the (NR*k, k) G table of the larger side with its two same-size
    transients (U and M*G), plus the two dense (G, S) weight matrices in
    "dense" mode and the bounded row-chunk gather in "ell" mode. On the
    card neither mode holds weights or the gather (the sparse tables
    kernel reads the CSR rows): the rule is kept as the JAX package
    states it, and the modes pick the same."""
    tables = 4 * 3 * n_chains * max(n_genes, n_samples) * k * k
    return {"dense": tables + 2 * 4 * n_chains * n_genes * n_samples,
            "ell": tables + 4 * sparse._ELL_CHUNK_ELEMS,
            "xla": 0}


def resolve_sparse_mode(n_chains: int, n_genes: int, n_samples: int, k: int,
                        device) -> str:
    """The first of "dense", "ell", "xla" whose memory (mode_bytes) fits
    in MEMORY_SHARE of the device's memory."""
    budget = MEMORY_SHARE * device_memory_bytes(device)
    need = mode_bytes(n_chains, n_genes, n_samples, k)
    return next(m for m in SPARSE_MODES if need[m] <= budget)


def _coo_of(D):
    """(rows, cols, vals, shape) of a CooMatrix or a dense array."""
    if isinstance(D, CooMatrix):
        return (np.asarray(D.rows), np.asarray(D.cols),
                np.asarray(D.vals, np.float32), tuple(D.shape))
    D = np.asarray(D, np.float32)
    r, c = np.nonzero(D)
    return r.astype(np.int32), c.astype(np.int32), D[r, c], D.shape


def stack_sparse_device_data(Ds: Sequence, cfg: EngineConfig, device,
                             pad_rows: Optional[int] = None,
                             pad_cols: Optional[int] = None):
    """Stack per-chain sparse datasets (dense arrays or CooMatrix) into
    one chain-batched SparseDeviceData (cogaps_tpu/sparse_engine.
    stack_sparse_device_data). Rows/columns pad to a common shape; a
    padded row or column is an all-zero observation under the implied
    uncertainty (S = 0.1 at zeros), as in the JAX package. The dense
    weights of "dense" mode are built by the engine.

    Returns (data, shapes) with shapes the per-chain true (G, S)."""
    coos = [_coo_of(D) for D in Ds]
    shapes = [c[3] for c in coos]
    G = pad_rows or max(s[0] for s in shapes)
    S = pad_cols or max(s[1] for s in shapes)
    k = cfg.n_patterns
    # lambda = alpha*sqrt(k/meanNonZero) and maxGibbsMass/lambda, formed
    # in float64 and stored in float32 as the JAX engines do
    root = np.float64([np.sqrt(k / (float(v.mean()) if len(v) else 1.0))
                       for _, _, v, _ in coos])
    csr_a = sparse.stack_csr([(r, c, v) for r, c, v, _ in coos], G)
    csr_p = sparse.stack_csr([(c, r, v) for r, c, v, _ in coos], S)
    data = SparseDeviceData(
        csr_a=csr_a, csr_p=csr_p,
        mass_a=_mass(cfg.alpha_a * root, cfg.max_gibbs_mass_a),
        mass_p=_mass(cfg.alpha_p * root, cfg.max_gibbs_mass_p))
    return data.to(device), shapes


def _mass(lam: np.ndarray, max_gibbs_mass: float) -> MassParams:
    """lambda rounded to float32, and maxGibbsMass / lambda divided in
    float32 from the rounded lambda, as the JAX engines divide it."""
    lam = lam.astype(np.float32)
    return MassParams(
        lam=torch.from_numpy(lam),
        max_gibbs_mass=torch.from_numpy(
            (np.float32(max_gibbs_mass) / lam).astype(np.float32)))


def _table_call(mode, atoms, M, csr, Wd, D1, other, temp, n_upd, consts,
                mparams, rand):
    """One sampler's update call of every chain in "dense"/"ell" mode:
    the tables (on the card the sparse tables kernel on the CSR rows, in
    either mode), then the dense sweep kernel with G as its Z table
    (noise floors 0, as the JAX tables path). Y is call-scoped."""
    if M.device.type == "cuda":
        SQ, Y0, G = sparse_tables(csr, other, M)
    elif mode == "ell":
        SQ, Y0, G = (torch.stack(x) for x in zip(*[
            sparse.kernel_tables_ell(csr.ell(c), other[c], M[c])
            for c in range(M.shape[0])]))
    else:
        SQ, Y0, G = sparse.kernel_tables(Wd, D1, other, M)
    phase = dense.DensePhase(SQ=SQ, Z=G, col_nz=other.amax(dim=1) > 0.0)
    atoms, M, _, done, ns, cnt = run_updates_multi(
        atoms, M, Y0, phase, temp, n_upd, consts, mparams, rand)
    return atoms, M, done, ns, cnt


def run_iteration_sparse(cfg: EngineConfig, consts_a: SamplerConsts,
                         consts_p: SamplerConsts, hist: HistConfig,
                         phase: int, data: SparseDeviceData, it: int,
                         state: ChainState, stats: RunStats, rand):
    """One sparse-model MCMC iteration of every chain (reference:
    GapsRunner.cpp:273-325; cogaps_tpu/sparse_engine.run_iteration_sparse
    and run_iteration_sparse_batch). `rand` provides budgets and sweeps
    as in engine.run_iteration."""
    fixed = cfg.which_matrix_fixed
    mode = cfg.sparse_table_mode
    if mode not in SPARSE_MODES:
        raise ValueError(f"unresolved sparse_table_mode {mode!r}")
    temp = annealing_temp(cfg, phase, it)
    n_a, n_p = rand.budgets(phase, it, state.atoms_a.n, state.atoms_p.n)

    atoms_a, M_a = state.atoms_a, state.M_a
    atoms_p, M_p = state.atoms_p, state.M_p
    NCH = M_a.shape[0]
    done_a = done_p = torch.zeros(NCH, dtype=torch.int32, device=M_a.device)
    obs_a = obs_p = None

    def run_upd(atoms, M, n_upd, consts, mparams, csr, Wd, D1, other, key):
        if mode == "xla":
            return run_updates_atlas_multi(atoms, M, csr, other, temp, n_upd,
                                           consts, mparams, key)
        return _table_call(mode, atoms, M, csr, Wd, D1, other, temp, n_upd,
                           consts, mparams, key)

    if fixed != "A":
        atoms_a, M_a, done_a, ns_a, cnt_a = run_upd(
            atoms_a, M_a, n_a, consts_a, data.mass_a, data.csr_a,
            data.Wd_a, data.D1_a, M_p, rand.sweeps(phase, it, SAMPLER_A))
        obs_a = (ns_a, cnt_a)
    if fixed != "P":
        tr = (lambda t: None if t is None else t.transpose(1, 2))  # noqa: E731
        atoms_p, M_p, done_p, ns_p, cnt_p = run_upd(
            atoms_p, M_p, n_p, consts_p, data.mass_p, data.csr_p,
            tr(data.Wd_a), tr(data.D1_a), M_a,
            rand.sweeps(phase, it, SAMPLER_P))
        obs_p = (ns_p, cnt_p)

    state = ChainState(atoms_a=atoms_a, atoms_p=atoms_p, M_a=M_a, M_p=M_p)

    def chisq_fn():
        return sparse_chisq_chains(data.csr_a, M_a, M_p)

    stats = accumulate_stats(cfg, hist, phase, it, M_a, M_p, atoms_a.n,
                             atoms_p.n, done_a, done_p, stats, chisq_fn,
                             obs_a=obs_a, obs_p=obs_p)
    return state, stats


def sparse_chisq_chains(csr_a: sparse.CsrMatrix, M_a: torch.Tensor,
                        M_p: torch.Tensor) -> torch.Tensor:
    """The closed-form chi^2 of every chain, (NCH,)."""
    return torch.stack([sparse.sparse_chisq(csr_a, M_a[c], M_p[c], chain=c)
                        for c in range(M_a.shape[0])])


class SparseChainEngine(ChainEngine):
    """The chains of a SparseDeviceData run together (the sparse analog
    of engine.ChainEngine, whose state, statistics and run_phase it
    shares). A config without a sparse_table_mode gets the default of
    resolve_sparse_mode. On the CPU "dense" mode builds the dense weights
    when the data has none; on the card no mode holds them."""

    iterate = staticmethod(run_iteration_sparse)
    sparse_model = True

    def __init__(self, data: SparseDeviceData, config: EngineConfig,
                 device):
        device = torch.device(device)
        if config.sparse_table_mode is None:
            config = dataclasses.replace(
                config, sparse_table_mode=resolve_sparse_mode(
                    data.csr_a.n_chains, data.csr_a.n_rows,
                    data.csr_p.n_rows, config.n_patterns, device))
        if config.sparse_table_mode not in SPARSE_MODES:
            raise ValueError("sparse_table_mode must be one of "
                             f"{SPARSE_MODES}, not "
                             f"{config.sparse_table_mode!r}")
        if device.type == "cuda":
            data = dataclasses.replace(data, Wd_a=None, D1_a=None)
        elif config.sparse_table_mode == "dense" and data.Wd_a is None:
            Wd, D1 = sparse.dense_weights(data.csr_a.to("cpu"),
                                          data.csr_p.n_rows)
            data = dataclasses.replace(data, Wd_a=Wd, D1_a=D1)
        self.config = config
        self.device = device
        self.data = data.to(device)
        self.n_chains = data.csr_a.n_chains
        self.n_genes, self.n_samples = data.csr_a.n_rows, data.csr_p.n_rows
        self.hist = derive_hist(config)
        self.consts_a, self.consts_p = build_consts(
            config, self.n_genes, self.n_samples)

    def chisq(self, state: ChainState) -> torch.Tensor:
        """chi^2 of every chain's current factors, (NCH,)."""
        return sparse_chisq_chains(self.data.csr_a, state.M_a, state.M_p)


class SparseMultichainEngine(SparseChainEngine):
    """C independent sparse chains as one program
    (cogaps_tpu/sparse_engine.SparseMultichainEngine): `data` from
    stack_sparse_device_data; the default mode is resolved for all
    chains together."""


class SparseGapsEngine(SparseChainEngine):
    """One chain of the sparse model on `device`, with the surface of
    engine.GapsEngine. `D` is a dense (genes x samples) array or an
    io.coo.CooMatrix; the COO path never densifies."""

    def __init__(self, D, config: EngineConfig, device):
        rows, cols, vals, shape = _coo_of(D)
        if np.any(vals < 0):
            raise ValueError("negative values in data matrix")
        n_genes, n_samples = shape
        self.data_sparsity = 1.0 - len(vals) / max(n_genes * n_samples, 1)
        data, _ = stack_sparse_device_data(
            [CooMatrix(rows, cols, vals, shape)], config, "cpu")
        super().__init__(data, config, device)
        self.lam_a = float(self.data.mass_a.lam[0])
        self.lam_p = float(self.data.mass_p.lam[0])
