"""The plain PyTorch version of the fused-span kernel K3 (csrc/span.cu,
bound in ops/span_cuda.py).

K3 runs whole iterations of the dense engine; its plain version runs
them one after another through engine.run_iteration with two changes
from the per-call path: the tables follow the kernel's rule
(models/dense.exact_tables: float64 sums over the float32 operands,
rounded once) and the sweeps run the plain sweep
(sweep_cuda.run_updates_multi_plain). Statistics go through
engine.accumulate_stats. It takes the same `rand` as run_iteration, so the
CPU tests can inject the JAX package's draws; with a PhiloxRandom it draws
the numbers the kernel draws. The kernel's wrapper runs it for tensors on
the CPU, and chip_smoke.py holds the kernel to it on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import engine
from ..models import dense
from .sweep_cuda import run_updates_multi_plain


class SpanTables(NamedTuple):
    """Both samplers' tables of one state under the kernel's rule:
    A (G, k), (G*k, k), (k,) and P (S, k), (S*k, k), (k,) per chain."""

    Y_a: torch.Tensor
    SQ_a: torch.Tensor
    Z_a: torch.Tensor
    col_nz_a: torch.Tensor
    Y_p: torch.Tensor
    SQ_p: torch.Tensor
    Z_p: torch.Tensor
    col_nz_p: torch.Tensor


def run_span_plain(cfg, consts_a, consts_p, hist, phase: int,
                   data: engine.DeviceData, it0: int, n_it: int,
                   state: engine.ChainState, stats: engine.RunStats, rand):
    """Iterations [it0, it0 + n_it) of one phase; returns (state, stats)."""
    for it in range(it0, it0 + n_it):
        state, stats = engine.run_iteration(
            cfg, consts_a, consts_p, hist, phase, data, it, state, stats,
            rand, tables=dense.exact_tables, update=run_updates_multi_plain)
    return state, stats


def rebuild_tables_plain(data: engine.DeviceData, M_a: torch.Tensor,
                         M_p: torch.Tensor) -> SpanTables:
    """The tables the kernel builds for each sampler from (M_a, M_p),
    without sweeping (the kernel's rebuild-only entry point)."""
    cache_a, phase_a = dense.exact_tables(data.D, data.invS2, M_a, M_p)
    cache_p, phase_p = dense.exact_tables(data.D_t, data.invS2_t, M_p, M_a)
    return SpanTables(Y_a=cache_a.Y, SQ_a=phase_a.SQ, Z_a=phase_a.Z,
                      col_nz_a=phase_a.col_nz, Y_p=cache_p.Y,
                      SQ_p=phase_p.SQ, Z_p=phase_p.Z,
                      col_nz_p=phase_p.col_nz)
