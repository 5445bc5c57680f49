"""Checkpoint-side atom-table normalization — the PyTorch counterpart of
cogaps_tpu/utils/atoms_compat.py (numpy, copied: the JAX package cannot
be imported where the port runs).

The sweep requires a COMPACT atom table (live atoms in slots [0, n) —
ops/atoms.py). Checkpoints written by earlier hole-based versions may
carry holes; normalize on load. Compaction preserves slot order, so a
resumed run is identical to an uninterrupted one whenever the saved table
was already compact (always true for checkpoints written by this
version).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.atoms import AtomTable


def load_table(mass, elem, n, device="cpu") -> AtomTable:
    """One chain's table, (C,) mass and elem and a scalar n, compacted."""
    mass = np.asarray(mass)
    elem = np.asarray(elem)
    live = elem >= 0
    k = int(live.sum())
    if k and not live[:k].all():  # holes present: stable-compact
        order = np.argsort(~live, kind="stable")
        mass, elem = mass[order], elem[order]
    return AtomTable(mass=torch.tensor(mass, dtype=torch.float32,
                                       device=device),
                     elem=torch.tensor(elem, dtype=torch.int32,
                                       device=device),
                     n=torch.tensor(np.int32(n), device=device))
