"""The port's multi-process pieces (cogaps_tpu_torch/parallel/multihost.py,
launch.py, and MultichainEngine's chain mesh and checkpoints) against
tests/test_multihost.py and tests/test_checkpoints.py:89-119.

The shard files keep the JAX package's layout: one <prefix>.shard<rank>
.npz per rank, the keys n_leaves, process_id and num_processes,
leaf{i}_shard<repr of the index's slices> with leaf{i}_shape for a
sharded leaf, leaf{i}_shard_full for a replicated one, extra_*; files of
either package load in the other. The 2-process run is the counterpart
of tools/multihost_demo.py: two gloo ranks on the CPU each run half the
chains of a MultichainEngine and write their shard files, rank 0
reassembles both, and the result equals a one-process run bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cogaps_tpu.parallel import multihost as jmultihost
from cogaps_tpu_torch import engine
from cogaps_tpu_torch.parallel import launch, multihost
from cogaps_tpu_torch.parallel.multichain import CHAIN_SPEC
import torch_ranks

torch.set_num_threads(1)

CHAINS = dict(n_patterns=3, n_iterations=40, seed=3, output_frequency=0)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """tests/test_multihost.py::test_sharded_checkpoint_roundtrip: a tree
    with a sharded and a replicated leaf, saved and restored in one
    process."""
    tree = {"x": torch.arange(32.0).reshape(8, 4), "y": torch.tensor(7.0)}
    prefix = str(tmp_path / "ck")
    path = multihost.save_sharded_checkpoint(prefix, tree,
                                             extra={"tag": np.int32(3)},
                                             spec={"x": 0, "y": None})
    assert path == prefix + ".shard0.npz"
    with np.load(path) as z:
        assert sorted(z.files) == sorted([
            "n_leaves", "process_id", "num_processes",
            "leaf0_shard(slice(0, 8, None), slice(None, None, None))",
            "leaf0_shape", "leaf1_shard_full", "extra_tag"])
        assert int(z["n_leaves"]) == 2 and int(z["num_processes"]) == 1
    restored = multihost.load_sharded_checkpoint(prefix, {"x": 0, "y": 0})
    np.testing.assert_array_equal(restored["x"],
                                  np.arange(32.0).reshape(8, 4))
    assert float(restored["y"]) == 7.0
    # the JAX package reads the port's file, and the port JAX's
    theirs = jmultihost.load_sharded_checkpoint(prefix, {"x": 0, "y": 0})
    np.testing.assert_array_equal(theirs["x"], restored["x"])
    mesh = Mesh(np.array(jax.devices()[:4]), ("chains",))
    x = jax.device_put(jnp.arange(32.0).reshape(8, 4),
                       NamedSharding(mesh, P("chains")))
    jprefix = str(tmp_path / "jck")
    jmultihost.save_sharded_checkpoint(jprefix, {"x": x,
                                                 "y": jnp.float32(7.0)})
    ours = multihost.load_sharded_checkpoint(jprefix, {"x": 0, "y": 0})
    np.testing.assert_array_equal(ours["x"], restored["x"])
    assert float(ours["y"]) == 7.0


def test_initialize_single_process(monkeypatch):
    """tests/test_multihost.py::test_initialize_single_process: without a
    coordinator the process is one rank, and no group is started."""
    monkeypatch.delenv(multihost.ENV_COORDINATOR, raising=False)
    assert multihost.initialize_distributed() == 0
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.is_coordinator()
    mesh = multihost.global_mesh("chains")
    assert (mesh.axis_name, mesh.size, mesh.rank) == ("chains", 1, 0)
    assert not torch.distributed.is_initialized()
    assert list(multihost.local_units(8, mesh)) == list(range(8))
    assert multihost.default_backend(2) in ("gloo", "nccl")
    # the collectives of one rank are the local operations
    parts = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(multihost.ordered_sum(parts, None),
                       ((parts[0] + parts[1]) + parts[2]) + parts[3])
    with pytest.raises(TypeError):
        multihost.sum_ints(parts, None)


@pytest.fixture(scope="module")
def chain_runs(modsim, tmp_path_factory):
    """4 chains (CHAINS, the fused span's plain version) on 2 gloo ranks,
    leaving a checkpoint after 20 equilibration iterations, and,
    meanwhile, on this process with mesh=None."""
    D = modsim[0]
    tmp = tmp_path_factory.mktemp("chains")
    ranks = launch.start(torch_ranks.rank_run, 2, "chains", D, CHAINS,
                         {"n_chains": 4}, str(tmp / "ranks2"), None,
                         (str(tmp / "mid"), engine.EQUILIBRATION, 20))
    eng, state, _ = torch_ranks.run("chains", D, CHAINS, {"n_chains": 4},
                                    str(tmp / "one"))
    launch.join(ranks, timeout=120)
    return D, tmp, eng, state


def test_two_process_chain_run(chain_runs):
    """Two gloo ranks, each with two of the four chains, wrote their shard
    files; rank 0 reassembled all four (and loaded no jax); the result is
    the one-process run's, bit for bit."""
    _, tmp, eng, state = chain_runs
    assert eng._fused_ok()
    assert (tmp / "ranks2.restored").read_text().startswith(
        "4 chains from 2 ranks")
    files = multihost.shard_files(str(tmp / "ranks2"))
    with np.load(files[1]) as z:
        assert int(z["process_id"]) == 1 and int(z["num_processes"]) == 2
        assert ("leaf6_shard(slice(2, 4, None), slice(None, None, None), "
                "slice(None, None, None))") in z.files  # M_a, chains 2-3
    torch_ranks.assert_same_bits(torch_ranks.result("chains",
                                                    str(tmp / "ranks2")),
                                 torch_ranks.result("chains",
                                                    str(tmp / "one")),
                                 "2 ranks")
    chisq = eng.chisq(state)
    assert bool(torch.isfinite(chisq).all()) and len(set(chisq.tolist())) == 4


def test_multichain_resume_exact(chain_runs, tmp_path):
    """tests/test_checkpoints.py::test_multichain_checkpoint_resume_exact:
    the 2-rank checkpoint after 20 equilibration iterations, resumed on
    one process, ends bit-equal to the unbroken run; the chains' seeds
    come back with it."""
    D, tmp, _, _ = chain_runs
    out = str(tmp_path / "resumed")
    eng, _, _ = torch_ranks.run("chains", D, CHAINS, {"n_chains": 4}, out,
                                resume=str(tmp / "mid"))
    _, _, phase, it, seeds = eng.load_checkpoint(str(tmp / "mid"))
    assert (phase, it) == (engine.EQUILIBRATION, 20)
    np.testing.assert_array_equal(seeds, [3, 4, 5, 6])
    torch_ranks.assert_same_bits(torch_ranks.result("chains", out),
                                 torch_ranks.result("chains",
                                                    str(tmp / "one")),
                                 "resumed")
    full, _ = multihost.load_sharded_checkpoint(str(tmp / "mid"), CHAIN_SPEC)
    assert full.M_a.shape[0] == 4
