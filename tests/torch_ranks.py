"""The ranks of the multi-process CPU tests (test_torch_sharded.py,
test_torch_sparse_sharded.py, test_torch_multihost.py), and the runs they
share with the one-process side.

Each rank is a process spawned by cogaps_tpu_torch.parallel.launch and
joined in a gloo group; it runs one engine over the group's mesh and
writes its result as a per-rank checkpoint (the engine's own
save_checkpoint), which the test reads back whole. This module imports no
jax and nothing of the JAX package, and every rank asserts before it
exits that it has loaded none of them."""

import sys

import numpy as np

from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import multihost
from cogaps_tpu_torch.parallel.multichain import (CHAIN_SPEC,
                                                  MultichainEngine,
                                                  stack_device_data)
from cogaps_tpu_torch.parallel.sharded import (STATE_SPEC, STATS_SPEC,
                                               ShardedGapsEngine,
                                               ShardedRandom)
from cogaps_tpu_torch.parallel.sparse_sharded import SparseShardedEngine

FORBIDDEN = ("jax", "jaxlib", "flax", "cogaps_tpu")
AXIS = {"dense": "genes", "sparse": "genes", "chains": "chains"}
SPEC = {"dense": (STATE_SPEC, STATS_SPEC), "sparse": (STATE_SPEC, STATS_SPEC),
        "chains": CHAIN_SPEC}


def make_engine(kind, data, params, kw, mesh, device="cpu"):
    """(engine, its random source, its checkpoint seed) of one kind:
    "dense" (ShardedGapsEngine of the matrix `data`), "sparse"
    (SparseShardedEngine of the CooMatrix `data`) or "chains"
    (MultichainEngine of kw["n_chains"] copies of `data`, chain c seeded
    params["seed"] + c)."""
    cfg = CogapsParams(**params).engine_config(*data.shape)
    seed = params["seed"]
    if kind == "dense":
        eng = ShardedGapsEngine(data, None, cfg, mesh=mesh, device=device,
                                **kw)
        return eng, ShardedRandom(seed, device), seed
    if kind == "sparse":
        eng = SparseShardedEngine(data, cfg, mesh=mesh, device=device, **kw)
        return eng, ShardedRandom(seed, device), seed
    n = kw["n_chains"]
    eng = MultichainEngine(stack_device_data([data] * n, None, cfg, "cpu"),
                           cfg, device, mesh=mesh)
    seeds = [seed + c for c in range(n)]
    return (eng, PhiloxRandom([seeds[c] for c in eng.chains], device),
            np.asarray(seeds))


def drive(eng, rand, state, stats, start=(EQUILIBRATION, 0), save=None,
          seed=None):
    """Both phases from `start` (phase, iteration) to the end; `save` =
    (prefix, phase, iteration) writes a checkpoint there on the way."""
    n = eng.config.n_iterations
    for phase in (EQUILIBRATION, SAMPLING):
        if phase < start[0]:
            continue
        it = start[1] if phase == start[0] else 0
        if save is not None and save[1] == phase:
            state, stats = eng.run_phase(state, stats, rand, phase, it,
                                         save[2])
            eng.save_checkpoint(save[0], state, stats, phase, save[2], seed)
            it = save[2]
        state, stats = eng.run_phase(state, stats, rand, phase, it, n)
    return state, stats


def run(kind, data, params, kw, out, mesh=None, resume=None, save=None,
        device="cpu"):
    """A whole run of one kind on `mesh` (from a checkpoint `resume`, if
    given), its end written as a checkpoint to `out`; returns (engine,
    state, stats)."""
    eng, rand, seed = make_engine(kind, data, params, kw, mesh, device)
    start = (EQUILIBRATION, 0)
    if resume is None:
        state, stats = eng.init_state(), eng.init_stats()
    else:
        state, stats, phase, it, _ = eng.load_checkpoint(resume)
        start = (phase, it)
    state, stats = drive(eng, rand, state, stats, start, save, seed)
    eng.save_checkpoint(out, state, stats, SAMPLING, eng.config.n_iterations,
                        seed)
    return eng, state, stats


def rank_run(rank, n, kind, data, params, kw, out, resume=None, save=None,
             device="cpu"):
    """One rank of `run` on the process group's mesh; rank 0 of a
    "chains" run then reassembles every rank's file (the counterpart of
    tools/multihost_demo.py). Fails if the rank loaded jax."""
    mesh = multihost.global_mesh(AXIS[kind])
    assert mesh.size == n and mesh.rank == rank
    run(kind, data, params, kw, out, mesh, resume, save, device)
    if kind == "chains" and rank == 0:
        state, _ = multihost.load_sharded_checkpoint(out, CHAIN_SPEC)
        assert state.M_a.shape[0] == kw["n_chains"]
        assert np.abs(state.M_a).sum() > 0
        with open(out + ".restored", "w") as f:
            f.write(f"{state.M_a.shape[0]} chains from {n} ranks\n")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        raise AssertionError(f"rank {rank} loaded {loaded}")


def result(kind, out) -> list:
    """The leaves of a run's final checkpoint, in full."""
    spec = SPEC[kind]
    return multihost.flatten(multihost.load_sharded_checkpoint(out, spec))


def assert_same_bits(a: list, b: list, what: str) -> None:
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: leaf {i}")


def assert_replicas_equal(out) -> int:
    """Every rank's copy of each replicated leaf (the P sampler's factor
    and atom table, the counters, the chi^2 history) in a run's per-rank
    files is the same bits; returns how many leaves were compared."""
    zs = [np.load(f) for f in multihost.shard_files(out)]
    keys = [k for k in zs[0].files if k.endswith("_shard_full")]
    for k in keys:
        for z in zs[1:]:
            np.testing.assert_array_equal(z[k], zs[0][k], err_msg=k)
    return len(keys)
