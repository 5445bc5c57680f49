"""Checkpoint / resume — the PyTorch counterpart of
cogaps_tpu/utils/checkpoint.py.

The reference serializes the complete sampler state (params, RNG seeder,
both samplers' factor matrices and atomic domains, statistics
accumulators, phase, iteration) to a versioned binary Archive with a
.backup rename during the write (reference: src/GapsRunner.cpp:225-270,
src/utils/Archive.h:16-17). A resume reproduces the run exactly even if
another seed argument is passed (tests/testthat/test_checkpoints.R:9-15).

Here the state of an engine's chains is a handful of tensors (factors,
atom tables, statistics sums) plus phase, iteration and the chains'
seeds: the counter-based Philox streams (engine.PhiloxRandom) need no
stored stream state, so the seed alone restores them. The file is the
JAX package's npz — the same keys, magic and version, the same .backup
rename — with two differences:
  * the update counter is written both as the port's int64 `upd` and as
    the JAX package's base-2^30 `upd_lo`/`upd_hi`;
  * `config_hash` is a digest of the EngineConfig's fields
    (config_digest), the same in every process. The JAX package stores
    hash(config), which Python salts per process for str fields, so it
    refuses a checkpoint written by another process. The digest leaves
    out sparse_table_mode: the sparse engines resolve it from the
    device's free memory, and every mode runs the same model, so a
    sparse run may resume on another device or card.
A one-chain engine's arrays are stored without the chain dimension, as
the JAX package's single-chain engine stores them; a multichain engine's
keep it, and `seed` then holds one seed a chain.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Tuple

import numpy as np
import torch

from ..engine import ChainState, RunStats
from ..ops.atoms import stack_atoms
from .atoms_compat import load_table

MAGIC = 0xB123AA4D  # the reference's archive magic (Archive.h:16)
VERSION = 1
_LO_BITS = 30  # the JAX package's split of the update counter


def config_digest(config) -> int:
    """A fingerprint of an EngineConfig that every process computes
    alike: the first 63 bits of the sha256 of its fields' sorted repr,
    sparse_table_mode left out."""
    fields = dataclasses.asdict(config)
    fields.pop("sparse_table_mode")
    text = repr(sorted(fields.items()))
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


def save_checkpoint(path: str, engine, state: ChainState, stats: RunStats,
                    phase: int, iteration: int, seed) -> None:
    """Write the engine's chains after `iteration` iterations of `phase`;
    `seed` is an int, or one per chain."""
    one = engine.n_chains == 1

    def host(t):
        a = t.detach().cpu().numpy()
        return a[0] if one else a

    upd = stats.upd.detach().cpu().numpy().astype(np.int64)
    seeds = np.asarray(seed, np.int64)
    payload = {
        "magic": np.uint32(MAGIC),
        "version": np.uint32(VERSION),
        "phase": np.int32(phase),
        "iteration": np.int32(iteration),
        "seed": seeds.reshape(-1)[0] if one else seeds,
        "n_genes": np.int32(engine.n_genes),
        "n_samples": np.int32(engine.n_samples),
        "n_patterns": np.int32(engine.config.n_patterns),
        "config_hash": np.int64(config_digest(engine.config)),
        "M_a": host(state.M_a), "M_p": host(state.M_p),
        "atoms_a_mass": host(state.atoms_a.mass),
        "atoms_a_elem": host(state.atoms_a.elem),
        "atoms_a_n": host(state.atoms_a.n),
        "atoms_p_mass": host(state.atoms_p.mass),
        "atoms_p_elem": host(state.atoms_p.elem),
        "atoms_p_n": host(state.atoms_p.n),
        "sparse": np.bool_(engine.sparse_model),
    }
    for f in dataclasses.fields(RunStats):
        payload[f.name] = host(getattr(stats, f.name))
    lo = (upd & ((1 << _LO_BITS) - 1)).astype(np.int32)
    hi = (upd >> _LO_BITS).astype(np.int32)
    payload["upd_lo"] = lo[0] if one else lo
    payload["upd_hi"] = hi[0] if one else hi
    # .backup rename during the write (reference: GapsRunner.cpp:232-243)
    backup = path + ".backup"
    if os.path.exists(path):
        os.replace(path, backup)
    with open(path, "wb") as f:
        np.savez(f, **payload)
    if os.path.exists(backup):
        os.remove(backup)


def load_checkpoint(path: str, engine) -> Tuple[ChainState, RunStats, int,
                                                 int]:
    """(state, stats, phase, iteration) of a checkpoint, on the engine's
    device. Refuses a file of other dimensions, chain count or engine
    configuration."""
    z = np.load(path)
    if int(z["magic"]) != MAGIC:
        raise ValueError(f"corrupt checkpoint file: {path}")
    if (int(z["n_genes"]) != engine.n_genes
            or int(z["n_samples"]) != engine.n_samples
            or int(z["n_patterns"]) != engine.config.n_patterns):
        raise ValueError("checkpoint does not match data dimensions")
    one = engine.n_chains == 1
    if z["M_a"].ndim != (2 if one else 3) or (
            not one and z["M_a"].shape[0] != engine.n_chains):
        raise ValueError("checkpoint does not match the engine's chain count")
    if "config_hash" in z and int(z["config_hash"]) != config_digest(
            engine.config):
        raise ValueError(
            "checkpoint was written with different engine parameters; "
            "resume requires the identical configuration")
    device = engine.device

    def arr(name):
        a = np.asarray(z[name])
        return a[None] if one else a

    def tensor(name, dtype=None):
        t = torch.tensor(arr(name), device=device)
        return t if dtype is None else t.to(dtype)

    def atoms(side):
        mass, elem, n = (arr(f"atoms_{side}_{f}") for f in ("mass", "elem",
                                                             "n"))
        return stack_atoms([load_table(mass[c], elem[c], n[c], device)
                            for c in range(engine.n_chains)])

    state = ChainState(atoms_a=atoms("a"), atoms_p=atoms("p"),
                       M_a=tensor("M_a", torch.float32),
                       M_p=tensor("M_p", torch.float32))
    fields = {}
    for f in dataclasses.fields(RunStats):
        if f.name == "upd":
            continue
        if f.name in z:
            fields[f.name] = tensor(f.name)
        else:  # counters absent from older files
            shape = (engine.n_chains,) + ((2,) if f.name == "sweep_counts"
                                          else (2, 4))
            fields[f.name] = torch.zeros(shape, dtype=torch.int32,
                                         device=device)
    if "upd" in z:
        upd = tensor("upd", torch.int64)
    else:  # a file of the JAX package
        upd = (tensor("upd_hi", torch.int64) * (1 << _LO_BITS)
               + tensor("upd_lo", torch.int64))
    stats = RunStats(upd=upd, **fields)
    return state, stats, int(z["phase"]), int(z["iteration"])


def checkpoint_seed(path: str) -> int:
    """The original run's seed, restored on resume regardless of the seed
    argument (reference: GapsRunner.cpp:100-106 reloads params and the
    random state before anything else); a multichain file's first."""
    return checkpoint_seeds(path)[0]


def checkpoint_seeds(path: str) -> List[int]:
    """Every chain's seed."""
    return [int(s) for s in np.atleast_1d(np.load(path)["seed"])]
