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
from ..utils import trace
from . import multihost

# the fused span's domain: the JAX package's semantic condition
MAX_SPAN_SAMPLES = 128
# and its size: the float64 rebuild operations a chain an iteration
# (span_cuda.rebuild_ops) up to which the span's iteration beats the
# per-call route's, by chain count (the first entry whose count is at
# least the program's chains; the last beyond). The span's iteration
# grows with its rebuilds, split over the CTAs of a chain's cluster -- 16
# up to 7 chains on an H100, 4 at 16 -- and its sweeps, one SM a chain;
# the per-call route's from a host floor, so its wall moves by up to
# 0.8 ms between runs. profile_iter --gate, both routes in one call on an
# NVIDIA H100 80GB HBM3 at 700.00 W, wall ms an iteration per-call :
# fused, 16 chains: GIST k=10 (5.8 M) 1.3977 : 0.5657, k=20 (18.9 M)
# 1.4983 : 1.0083; 2000x32 k=10 (30.3 M) 1.9196 : 0.7829; 5005x100 k=10
# (237 M) 1.5641 : 1.6220 (two earlier calls 1.9858 : 1.8098 and 1.8514
# : 1.7567); 6000x100 k=10 (284 M) 1.8258 : 1.9176, k=20 (926 M) 2.1929
# : 6.2081; 10000x100 k=10 (474 M) 1.7584 : 2.9157; 20000x100 (948 M)
# 1.8942 : 5.3702. 4 chains: GIST k=10 1.8684 : 0.4916; 2000x32 2.0429 :
# 0.6604; 5005x100 1.4443 : 0.9498; 6000x100 2.1152 : 1.0916, k=20
# 1.9545 : 3.2196; 10000x100 2.9392 : 1.4944; 20000x100 1.8314 : 2.5762.
# At 16 chains the two routes trade places within the per-call wall's
# spread from 237 M; the limit sits below, where the per-call route also
# keeps the card idle more (0.67 device ms an iteration against 1.51 at
# 5005x100). The operations order the k = 20 rows as the k = 10 ones, so
# k needs no term of its own.
MAX_SPAN_REBUILD_OPS = ((4, 500_000_000), (16, 200_000_000))


def max_span_rebuild_ops(n_chains: int) -> int:
    """The fused route's limit on span_cuda.rebuild_ops for a launch of
    n_chains chains (MAX_SPAN_REBUILD_OPS)."""
    for count, limit in MAX_SPAN_REBUILD_OPS:
        if n_chains <= count:
            return limit
    return MAX_SPAN_REBUILD_OPS[-1][1]


def span_size_ok(G: int, S: int, k: int, n_chains: int, B_a: int,
                 B_p: int) -> bool:
    """The size half of the fused route's gate: n_chains chains of G x S
    data at k patterns and batches B_a, B_p are cheaper in spans
    (max_span_rebuild_ops) and K3 can launch them (span_cuda.span_fits:
    above k = 88 its column groups outgrow a block)."""
    return (span_cuda.rebuild_ops(G, S, k) <= max_span_rebuild_ops(n_chains)
            and span_cuda.span_fits(G, S, k, B_a, B_p))


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
        n_samples <= 128), and span_size_ok for the program's chains: a
        table rebuild below the size where the per-call route overtakes
        the span at that chain count, and a shape K3 can launch. The
        count is the mesh's total, so that every rank takes the route
        one process would, and a chain's bits do not follow the rank
        count. Its TPU conditions (backend, mesh, <= 8 chains for the
        v5e's VMEM) have no counterpart here."""
        cfg = self.config
        return (cfg.which_matrix_fixed == "N" and self.hist.n_hist == 0
                and cfg.n_snapshots == 0 and not cfg.take_pump_samples
                and self.n_samples <= MAX_SPAN_SAMPLES
                and span_size_ok(self.n_genes, self.n_samples,
                                 cfg.n_patterns, self.n_chains_total,
                                 self.consts_a.batch, self.consts_p.batch))

    def run_phase(self, state: ChainState, stats: RunStats, rand,
                  phase: int, start_iter: int = 0,
                  stop_iter: Optional[int] = None, progress_cb=None):
        """Iterations [start, stop) of one phase: run_spans when
        _fused_ok() holds, else ChainEngine.run_phase."""
        fused = self._fused_ok()
        run = self.run_spans if fused else super().run_phase
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        with trace.span("run_phase", phase=phase,
                        iterations=stop - start_iter, route=int(fused)):
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
