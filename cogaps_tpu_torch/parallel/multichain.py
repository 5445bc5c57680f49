"""Independent chains run as one program — the PyTorch counterpart of
cogaps_tpu/parallel/multichain.py.

The counterpart of the reference's process-level parallelism (one
forked C++ engine per data subset, R/DistributedCogaps.R:56-67): chains
are independent, so their state is stacked along a leading dimension.
Where the run records nothing per iteration and the data is small (the
throughput configuration on GIST), whole spans of iterations run in one
launch of the fused-span kernel (ops/span_cuda.py, the port of ops/pallas_iter.py);
otherwise each sampler's update call runs every chain in one kernel
launch. With a process mesh (parallel/multihost.py) each rank holds a
contiguous group of the chains and runs them with no communication, as
the JAX engine's shard_map over its "chains" axis does; a chain's bits do
not depend on the rank count, since its Philox streams hold no chain
index (engine.PhiloxRandom). Checkpoints are per rank: each rank writes
the chains it holds, and a load reassembles them for the current mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..engine import (ChainEngine, ChainState, DeviceData, RunStats,
                      _device_data)
from ..models import dense
from ..ops.atoms import AtomTable
from ..ops import span_cuda
from ..params import EngineConfig
from . import multihost

# the fused span's domain: the JAX package's semantic condition
MAX_SPAN_SAMPLES = 128
# and its size, in span_cuda.rebuild_ops a chain an iteration: the span's
# iteration grows with its float64 table rebuilds (a thread-block cluster
# a chain), the per-call route's with its float32 matmuls from a host
# floor. profile_iter, two runs on NVIDIA H100 80GB HBM3 cards at 700.00
# W, 16 chains, wall ms an iteration fused : per-call: 2000x32 k=7 (17.3
# M) 0.6304 : 1.1816 and 0.6641 : 3.0654; 4000x64 k=7 (69.1 M) 0.9390 :
# 1.2002 and 0.9570 : 1.6913; 6000x100 k=10 (284 M) 1.9506 : 3.1173;
# 10000x100 k=10 (474 M) 2.9241 : 2.8071 and 3.0245 : 3.3227; 20000x100
# k=10 (948 M) 5.5095 : 4.8534 and 5.5512 : 4.8791. The span wins up to
# 284 M, the two trade places near 474 M, per-call wins beyond.
MAX_SPAN_REBUILD_OPS = 300_000_000
# every leaf of a multichain state is sharded along its chain dimension
CHAIN_SPEC = (ChainState(atoms_a=AtomTable(0, 0, 0),
                         atoms_p=AtomTable(0, 0, 0), M_a=0, M_p=0),
              RunStats(**{f.name: 0 for f in dataclasses.fields(RunStats)}))


def stack_device_data(Ds, Ss, cfg: EngineConfig, device) -> DeviceData:
    """Stack per-chain datasets into one DeviceData, padding genes (and
    samples) to a common size with invS2 = 0 entries, which are exact
    no-ops in every likelihood term (cogaps_tpu/parallel/multichain.
    stack_device_data)."""
    n = len(Ds)
    G = max(d.shape[0] for d in Ds)
    S = max(d.shape[1] for d in Ds)
    D_stack = np.zeros((n, G, S), np.float32)
    inv_stack = np.zeros((n, G, S), np.float32)
    lam_a = np.zeros((n,), np.float32)
    lam_p = np.zeros((n,), np.float32)
    for i, D in enumerate(Ds):
        D = np.asarray(D, np.float32)
        Si = (np.asarray(Ss[i], np.float32)
              if Ss is not None and Ss[i] is not None
              else dense.default_uncertainty(D))
        g, s = D.shape
        D_stack[i, :g, :s] = D
        inv_stack[i, :g, :s] = 1.0 / (Si * Si)
        lam_a[i] = dense.compute_lambda(D, cfg.alpha_a, cfg.n_patterns)
        lam_p[i] = dense.compute_lambda(D, cfg.alpha_p, cfg.n_patterns)
    return _device_data(D_stack, inv_stack, lam_a,
                        cfg.max_gibbs_mass_a / lam_a, lam_p,
                        cfg.max_gibbs_mass_p / lam_p, device)


class MultichainEngine(ChainEngine):
    """C independent chains of stacked data on `device`. `data` carries a
    leading chain axis (stack_device_data); states, statistics and the
    PhiloxRandom seeds follow it. With a `mesh` (multihost.ProcessMesh)
    this rank holds the chains `self.chains` of `data`: its states,
    statistics and random streams are theirs (PhiloxRandom of
    [seeds[c] for c in self.chains])."""

    def __init__(self, data: DeviceData, config: EngineConfig, device,
                 mesh: Optional[multihost.ProcessMesh] = None):
        self.mesh = mesh
        self.n_chains_total = data.D.shape[0]
        self.chains = multihost.local_units(self.n_chains_total, mesh)
        if mesh is not None:
            lo, hi = self.chains.start, self.chains.stop
            data = DeviceData(
                D=data.D[lo:hi], invS2=data.invS2[lo:hi],
                D_t=data.D_t[lo:hi], invS2_t=data.invS2_t[lo:hi],
                mass_a=type(data.mass_a)(*(x[lo:hi] for x in data.mass_a)),
                mass_p=type(data.mass_p)(*(x[lo:hi] for x in data.mass_p)))
        super().__init__(data, config, device)

    def _fused_ok(self) -> bool:
        """Whether run_phase takes the fused span: the semantic conditions
        of cogaps_tpu/parallel/multichain.MultichainEngine._fused_ok
        (both factors sampled, no histories, snapshots or PUMP counts,
        n_samples <= 128), and a table rebuild below the size where the
        per-call route overtakes it (MAX_SPAN_REBUILD_OPS). Its TPU
        conditions (backend, mesh, <= 8 chains for the v5e's VMEM) have no
        counterpart here."""
        cfg = self.config
        return (cfg.which_matrix_fixed == "N" and self.hist.n_hist == 0
                and cfg.n_snapshots == 0 and not cfg.take_pump_samples
                and self.n_samples <= MAX_SPAN_SAMPLES
                and span_cuda.rebuild_ops(self.n_genes, self.n_samples,
                                          cfg.n_patterns)
                <= MAX_SPAN_REBUILD_OPS)

    def run_phase(self, state: ChainState, stats: RunStats, rand,
                  phase: int, start_iter: int = 0,
                  stop_iter: Optional[int] = None, progress_cb=None):
        """Iterations [start, stop) of one phase: run_spans when
        _fused_ok() holds, else ChainEngine.run_phase."""
        run = self.run_spans if self._fused_ok() else super().run_phase
        return run(state, stats, rand, phase, start_iter, stop_iter,
                   progress_cb)

    def run_spans(self, state: ChainState, stats: RunStats, rand,
                  phase: int, start_iter: int = 0,
                  stop_iter: Optional[int] = None, progress_cb=None):
        """Iterations [start, stop) of one phase in spans of up to
        span_cuda.CHUNK iterations, one fused-span launch each, whatever
        the data's size (progress_cb fires at span ends)."""
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        for a in range(start_iter, stop, span_cuda.CHUNK):
            b = min(a + span_cuda.CHUNK, stop)
            state, stats = span_cuda.run_span(
                self.config, self.consts_a, self.consts_p, self.hist, phase,
                self.data, a, b - a, state, stats, rand)
            if progress_cb is not None:
                progress_cb(phase, b, state)
        return state, stats

    # ------------------------------------------------------------------
    # per-rank checkpoints (cogaps_tpu/parallel/multichain.py:345-376):
    # every leaf is sharded along its leading chain dimension
    def save_checkpoint(self, path_prefix: str, state: ChainState,
                        stats: RunStats, phase: int, it: int, seeds) -> str:
        """Write this rank's chains after iteration `it` of `phase`;
        `seeds` holds every chain's seed."""
        return multihost.save_sharded_checkpoint(
            path_prefix, (state, stats),
            extra={"phase": np.int32(phase), "iter": np.int32(it),
                   "seeds": np.asarray(seeds),
                   "n_chains": np.int32(self.n_chains_total)},
            spec=CHAIN_SPEC, mesh=self.mesh)

    def load_checkpoint(self, path_prefix: str):
        """(state, stats, phase, iter, seeds): this rank's chains of a
        checkpoint written on any rank count, on the engine's device;
        `seeds` holds every chain's seed."""
        with np.load(multihost.shard_files(path_prefix)[0]) as z:
            if int(z["extra_n_chains"]) != self.n_chains_total:
                raise ValueError("checkpoint chain count mismatch")
            phase, it = int(z["extra_phase"]), int(z["extra_iter"])
            seeds = np.asarray(z["extra_seeds"])
        state, stats = multihost.load_sharded_checkpoint(
            path_prefix, CHAIN_SPEC, CHAIN_SPEC, self.mesh)
        return (multihost.to_device(state, self.device),
                multihost.to_device(stats, self.device), phase, it, seeds)
