"""Independent chains run as one program — the PyTorch counterpart of
cogaps_tpu/parallel/multichain.py without the device mesh.

The counterpart of the reference's process-level parallelism (one
forked C++ engine per data subset, R/DistributedCogaps.R:56-67): chains
are independent, so their state is stacked along a leading dimension.
Where the run records nothing per iteration and the data is small (the
throughput configuration on GIST), whole spans of iterations run in one
launch of the fused-span kernel (ops/span_cuda.py, the port of ops/pallas_iter.py);
otherwise each sampler's update call runs every chain in one kernel
launch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..engine import (ChainEngine, ChainState, DeviceData, RunStats,
                      _device_data)
from ..models import dense
from ..ops import span_cuda
from ..params import EngineConfig

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
    PhiloxRandom seeds follow it."""

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
