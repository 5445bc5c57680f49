"""State carried between the JAX package and the port.

The JAX side is given as numpy arrays — what ``jax.device_get`` returns —
either as the JAX objects themselves (ChainState, SparseChainState,
AtlasState, RunStats, DeviceData, SparseDeviceData) or as plain name ->
array mappings with the same names. A state of one
chain (the single-chain engine) gains a leading chain dimension of 1;
a vmapped state keeps its own. JAX's base-2^30 update counter
(upd_lo, upd_hi) folds into one int64.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .engine import ChainState, DeviceData, RunStats
from .models import sparse
from .ops.atoms import AtomTable
from .ops.sweep import MassParams
from .sparse_engine import SparseDeviceData


def _get(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(x, device, lead: bool, dtype=None):
    a = np.asarray(x)
    if lead:
        a = a[None]
    t = torch.tensor(a, device=device)  # a copy: JAX arrays are read-only
    return t if dtype is None else t.to(dtype)


def _atoms(tree, device, lead: bool) -> AtomTable:
    return AtomTable(
        mass=_tensor(_get(tree, "mass"), device, lead, torch.float32),
        elem=_tensor(_get(tree, "elem"), device, lead, torch.int32),
        n=_tensor(_get(tree, "n"), device, lead, torch.int32))


def chain_state_from_numpy(tree, device="cpu") -> ChainState:
    lead = np.ndim(_get(tree, "M_a")) == 2
    return ChainState(
        atoms_a=_atoms(_get(tree, "atoms_a"), device, lead),
        atoms_p=_atoms(_get(tree, "atoms_p"), device, lead),
        M_a=_tensor(_get(tree, "M_a"), device, lead, torch.float32),
        M_p=_tensor(_get(tree, "M_p"), device, lead, torch.float32))


# a SparseChainState has the fields of a ChainState
sparse_chain_state_from_numpy = chain_state_from_numpy


def atlas_state_from_numpy(tree, k: int, device="cpu") -> ChainState:
    """The JAX atlas engine's AtlasState as a one-chain ChainState: the
    factors are lanes [0, k) of the M mirrors (the planes are not
    carried: the port has none)."""
    mirrors = {"M_a": np.asarray(_get(tree, "mmir_a"))[:, :k],
               "M_p": np.asarray(_get(tree, "mmir_p"))[:, :k],
               "atoms_a": _get(tree, "atoms_a"),
               "atoms_p": _get(tree, "atoms_p")}
    return chain_state_from_numpy(mirrors, device)


def _ell_to_coo(idx: np.ndarray, val: np.ndarray):
    rows, slots = np.nonzero(idx >= 0)
    return rows, idx[rows, slots], val[rows, slots]


def sparse_data_from_numpy(tree, device="cpu") -> SparseDeviceData:
    """The JAX SparseDeviceData (ELL rows of one chain, or chain-stacked)
    as the port's: the ELL rows become CSR rows in the same order, the
    mass parameters and the optional dense weights (Wd_a, D1_a) carry
    over."""
    ell_a, ell_p = _get(tree, "ell_a"), _get(tree, "ell_p")
    idx_a = np.asarray(_get(ell_a, "idx"))
    lead = idx_a.ndim == 2

    def csr(ell):
        idx = np.asarray(_get(ell, "idx"))
        val = np.asarray(_get(ell, "val"))
        if lead:
            idx, val = idx[None], val[None]
        return sparse.stack_csr([_ell_to_coo(i, v) for i, v in zip(idx, val)],
                                idx.shape[1])

    def mass(name):
        m = _get(tree, name)
        return MassParams(
            lam=_tensor(_get(m, "lam"), device, lead, torch.float32),
            max_gibbs_mass=_tensor(_get(m, "max_gibbs_mass"), device, lead,
                                   torch.float32))

    def weights(name):
        w = _get(tree, name)
        return None if w is None else _tensor(w, device, lead,
                                              torch.float32)

    return SparseDeviceData(
        csr_a=csr(ell_a).to(device), csr_p=csr(ell_p).to(device),
        mass_a=mass("mass_a"), mass_p=mass("mass_p"),
        Wd_a=weights("Wd_a"), D1_a=weights("D1_a"))


def run_stats_from_numpy(tree, device="cpu") -> RunStats:
    lead = np.ndim(_get(tree, "a_sum")) == 2
    fields = {}
    for f in dataclasses.fields(RunStats):
        if f.name == "upd":
            continue
        fields[f.name] = _tensor(_get(tree, f.name), device, lead)
    upd = (np.asarray(_get(tree, "upd_hi"), np.int64) * (1 << 30)
           + np.asarray(_get(tree, "upd_lo"), np.int64))
    return RunStats(upd=_tensor(upd, device, lead), **fields)


def device_data_from_numpy(tree, device="cpu") -> DeviceData:
    lead = np.ndim(_get(tree, "D")) == 2

    def mass(name):
        m = _get(tree, name)
        return MassParams(
            lam=_tensor(_get(m, "lam"), device, lead, torch.float32),
            max_gibbs_mass=_tensor(_get(m, "max_gibbs_mass"), device, lead,
                                   torch.float32))

    return DeviceData(
        **{k: _tensor(_get(tree, k), device, lead, torch.float32)
           for k in ("D", "invS2", "D_t", "invS2_t")},
        mass_a=mass("mass_a"), mass_p=mass("mass_p"))


def to_numpy(obj):
    """A port dataclass or tuple of tensors as nested name -> numpy
    mappings (RunStats keeps its single int64 `upd`)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    return obj
