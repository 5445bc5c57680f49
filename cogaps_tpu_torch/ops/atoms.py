"""Compact atom table — the PyTorch counterpart of cogaps_tpu/ops/atoms.py.

Atoms are stored as a fixed-capacity table of (matrix element, mass)
pairs. The table is COMPACT: live atoms occupy slots [0, n), so a
uniform rank over the live atoms is a slot index (the reference keeps an
unsorted vector for the same O(1) uniform pick, AtomicDomain.cpp:24-29).
Births append at the top and every killed slot below the new boundary is
refilled from the tail — the analog of the reference's swap-with-back
erase (AtomicDomain.cpp:80-111). The module docstring of
cogaps_tpu/ops/atoms.py gives the argument for storing elements instead
of 2^64 positions.

Tables carry any leading shape: (C,) for one chain in the plain sweep,
(NCH, C) with n of shape (NCH,) in the engine.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AtomTable:
    mass: torch.Tensor  # (..., C) float32, 0 where empty
    elem: torch.Tensor  # (..., C) int32, matrix element index, -1 where empty
    n: torch.Tensor  # (...) int32, number of live atoms

    @property
    def capacity(self) -> int:
        return self.mass.shape[-1]

    def chain(self, c: int) -> "AtomTable":
        return AtomTable(mass=self.mass[c], elem=self.elem[c], n=self.n[c])


def init_atoms(capacity: int, n_chains: int, device) -> AtomTable:
    return AtomTable(
        mass=torch.zeros((n_chains, capacity), dtype=torch.float32,
                         device=device),
        elem=torch.full((n_chains, capacity), -1, dtype=torch.int32,
                        device=device),
        n=torch.zeros((n_chains,), dtype=torch.int32, device=device))


def stack_atoms(tables) -> AtomTable:
    return AtomTable(mass=torch.stack([t.mass for t in tables]),
                     elem=torch.stack([t.elem for t in tables]),
                     n=torch.stack([t.n for t in tables]))


def total_mass_per_element(atoms: AtomTable, n_elements: int) -> torch.Tensor:
    """Sum of atom masses per matrix element, for a one-chain table —
    the debug 'drift' oracle (reference: AsynchronousGibbsSampler.h:
    237-270 maximumDrift)."""
    idx = torch.where(atoms.elem >= 0, atoms.elem,
                      n_elements).to(torch.int64)
    out = torch.zeros(n_elements + 1, dtype=torch.float32,
                      device=atoms.mass.device)
    return out.index_add_(0, idx, atoms.mass)[:n_elements]
