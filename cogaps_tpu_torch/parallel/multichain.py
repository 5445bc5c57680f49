"""Independent chains run as one program — the PyTorch counterpart of
cogaps_tpu/parallel/multichain.py without the device mesh and without
the fused-span kernel (ops/pallas_iter.py, still to be ported).

The counterpart of the reference's process-level parallelism (one
forked C++ engine per data subset, R/DistributedCogaps.R:56-67): chains
are independent, so their state is stacked along a leading dimension and
each sampler's update call runs every chain in one kernel launch.
"""

from __future__ import annotations

import numpy as np

from ..engine import ChainEngine, DeviceData, _device_data
from ..models import dense
from ..params import EngineConfig


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
