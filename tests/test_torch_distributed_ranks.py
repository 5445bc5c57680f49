"""GWCoGAPS and dense scCoGAPS across the ranks of a process group: the
subset chains on a mesh of ranks (cogaps_tpu_torch/parallel/
distributed.subset_mesh, the JAX package's device-mesh rule of
cogaps_tpu/parallel/distributed.py:279-289, ranks for devices).

Every rank of a gloo group on the CPU (spawned by parallel/launch.py)
makes the same call and must return the one-process result (no process
group, mesh=None) bit for bit: Amean, Asd, Pmean, Psd, meanChiSq, the
consensus, and each stage's updates and launches. The cases: 4 sets on
1, 2 and 4 ranks (a rank a chain at 4), 4 sets on 3 ranks, where 3 does
not divide 4 and every rank runs every chain, and 2 sets on 3 ranks,
where ranks 0-1 form a sub-group and rank 2 receives the stage's
statistics by broadcast. The one-process port is held to the JAX package
by tests/test_torch_distributed.py; this file holds the mesh to the
one-process port."""

import numpy as np
import pytest
import torch

import torch_ranks
from cogaps_tpu_torch.bench_harness import synthetic_dense
from cogaps_tpu_torch.parallel import distributed, launch, multihost

torch.set_num_threads(1)

ENTRIES = {"GWCoGAPS": {}, "scCoGAPS": {"sparse_optimization": False}}
CASES = [("GWCoGAPS", 4, 1), ("GWCoGAPS", 4, 2), ("GWCoGAPS", 4, 4),
         ("GWCoGAPS", 4, 3), ("GWCoGAPS", 2, 3), ("scCoGAPS", 4, 1),
         ("scCoGAPS", 4, 2), ("scCoGAPS", 4, 4)]


def params(entry, n_sets):
    return dict(n_patterns=3, n_iterations=20, seed=11, n_sets=n_sets,
                output_frequency=0, **ENTRIES[entry])


@pytest.fixture(scope="module")
def data():
    return synthetic_dense(200, 24, 3, 1, 7)[0]


# the cases' groups run in waves of at most 7 rank processes (~0.25 GiB
# each), the one-process runs beside the first
WAVES = [CASES[:3], CASES[3:5], CASES[5:]]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Every case's ranks, a wave at a time; meanwhile each one-process
    run here. Returns ({case: path prefix}, {(entry, n_sets): arrays})."""
    tmp = tmp_path_factory.mktemp("ranks")
    outs, one = {}, {}
    for wave in WAVES:
        groups = []
        try:
            for entry, n_sets, n in wave:
                out = str(tmp / f"{entry}-{n_sets}-{n}")
                groups.append(launch.start(torch_ranks.distributed_rank, n,
                                           entry, data,
                                           params(entry, n_sets), out))
                outs[(entry, n_sets, n)] = out
            if not one:
                one = {(e, s): torch_ranks.distributed_run(e, data,
                                                           params(e, s))
                       for e, s in sorted({(e, s) for e, s, _ in CASES})}
            for g in groups:
                launch.join(g, timeout=240)
        finally:
            for g in groups:
                launch.kill(g)
    return outs, one


@pytest.mark.parametrize("entry,n_sets,n_ranks", CASES,
                         ids=[f"{e}-{s}sets-{n}ranks" for e, s, n in CASES])
def test_ranks_match_one_process(runs, entry, n_sets, n_ranks):
    outs, one = runs
    want = one[(entry, n_sets)]
    free = want["Amean" if entry == "GWCoGAPS" else "Pmean"]
    assert np.isfinite(free).all() and np.abs(free).sum() > 0
    for rank in range(n_ranks):
        with np.load(f"{outs[(entry, n_sets, n_ranks)]}.rank{rank}.npz") as z:
            assert sorted(z.files) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(
                    z[k], v, err_msg=f"{entry} on {n_ranks} ranks, rank "
                    f"{rank}: {k}")


def test_subset_mesh_without_a_group():
    """One process: no mesh, whatever the sets (every chain here)."""
    assert multihost.process_count() == 1
    for n_sets in (1, 2, 3, 4, 7):
        assert distributed.subset_mesh(n_sets) is None


@pytest.mark.parametrize("n_sets,world,want", [
    (4, 2, "all"), (4, 4, "all"), (8, 4, "all"), (4, 3, None),
    (6, 4, None), (2, 3, "sub"), (2, 4, "sub"), (1, 4, "sub")])
def test_subset_mesh_rule(monkeypatch, n_sets, world, want):
    """The JAX rule on a group of `world` ranks, seen from each rank: the
    whole group's mesh, a sub-group of the first min(n_sets, world) ranks
    (made on every rank, OUTSIDE on the others), or none."""
    made = []
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    monkeypatch.setattr(multihost, "global_mesh", lambda axis="chains": (
        multihost.ProcessMesh(axis, "world", world, rank, "gloo")))
    monkeypatch.setattr(torch.distributed, "new_group",
                        lambda ranks: made.append(ranks) or "sub")
    monkeypatch.setattr(torch.distributed, "get_backend", lambda g: "gloo")
    for rank in range(world):
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        mesh = distributed.subset_mesh(n_sets)
        if want is None:
            assert mesh is None
        elif want == "all":
            assert mesh.group == "world" and mesh.size == world
        elif rank < n_sets:
            assert mesh == ("chains", "sub", n_sets, rank, "gloo")
        else:
            assert mesh is distributed.OUTSIDE
    assert made == ([list(range(n_sets))] * world if want == "sub" else [])
