"""The port's gene-sharded sparse chain (cogaps_tpu_torch/parallel/
sparse_sharded.py) against cogaps_tpu/parallel/sparse_sharded.py on the
CPU, and the contracts of tests/test_sparse_sharded.py: convergence, mass
drift, padding, the memory plan, resumes on the same and on another shard
count, and bitwise equality of mesh=None and 2 gloo ranks.

Lockstep: JAX's SparseShardedEngine runs on a 4-device mesh, the port
with n_shards=4 and mesh=None; JAX's warmed state is carried into the
port (convert.py) and both run the same iterations with JAX's draws
(each device's budget poisson(kpa, max(n, 10)), its sweep blocks from
fold_in(kua, device); P's from kpp and kup). JAX runs jitted (its
shard_map does not run under jax.disable_jit). The port's P sampler
reads tables summed over shards where JAX psums each sweep's alpha terms:
equal sums in another order, held as tests/test_torch_sparse.py holds
the sparse closed forms: decision-exact (equal elem, n, counters and
atom histories), mass and M within rtol 1e-4, the running sums within
1e-4, chi^2 within 1e-4."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cogaps_tpu.io.h5 import CooMatrix as JCoo
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu.parallel import sparse_sharded as jsparse_sharded
from cogaps_tpu_torch import convert, engine
from cogaps_tpu_torch.io.coo import CooMatrix
from cogaps_tpu_torch.ops.atoms import total_mass_per_element
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import launch, multihost, sparse_sharded
from cogaps_tpu_torch.parallel.sharded import ShardedRandom
from test_torch_sharded import ShardedJaxDraws, assert_sharded_same
import torch_ranks

torch.set_num_threads(1)

LOCK = dict(n_patterns=3, n_iterations=40, seed=5, output_frequency=2)
WARMUP = 16
STEPS = [(engine.EQUILIBRATION, WARMUP), (engine.EQUILIBRATION, WARMUP + 1),
         (engine.SAMPLING, 0)]
RUN = dict(n_patterns=3, n_iterations=100, seed=5, output_frequency=50)


def _coo(n_genes=96, n_samples=30, k=3, seed=2, keep=0.4):
    """tests/test_sparse_sharded.py's data: structural zeros of a rank-3
    nonnegative factorization."""
    rng = np.random.default_rng(seed)
    A = (rng.gamma(2, 1, (n_genes, k)) * (rng.random((n_genes, k)) < keep)
         ).astype(np.float32)
    P = (rng.gamma(2, 1, (n_samples, k)) * (rng.random((n_samples, k)) < keep)
         ).astype(np.float32)
    D = (A @ P.T).astype(np.float32)
    rows, cols = np.nonzero(D)
    return CooMatrix(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                     vals=D[rows, cols], shape=D.shape)


@pytest.fixture(scope="module")
def jax_run():
    coo = _coo()
    cfg = JParams(**LOCK).engine_config(*coo.shape)
    jeng = jsparse_sharded.SparseShardedEngine(
        JCoo(*coo), cfg, Mesh(np.array(jax.devices()[:4]), ("genes",)))
    key = jax.random.PRNGKey(LOCK["seed"])
    warm = jeng.run_phase(jeng.init_state(), jeng.init_stats(), key,
                          engine.EQUILIBRATION, 0, WARMUP)
    return coo, jeng, key, warm


@pytest.mark.parametrize("mode", ["dense", "ell", "xla"])
def test_sparse_sharded_lockstep_with_jax(jax_run, mode):
    """Each A-side mode (K2 on dense-weight or ELL tables, K4 on CSR rows:
    their plain versions here) against JAX, the P side on summed
    tables."""
    coo, jeng, key, (jstate, jstats) = jax_run
    cfg = dataclasses.replace(CogapsParams(**LOCK).engine_config(*coo.shape),
                              sparse_table_mode=mode)
    port = sparse_sharded.SparseShardedEngine(coo, cfg, n_shards=4,
                                              device="cpu")
    assert port.mode == mode and port.n_genes == jeng.n_genes
    # the per-shard rows are JAX's per-device ELL rows
    for ours, idx, val in ((port.csr_a, jeng.ell_a_idx, jeng.ell_a_val),
                           (port.csr_p, jeng.ell_p_idx, jeng.ell_p_val)):
        theirs = convert.shard_csr_from_numpy(idx, val, device="cpu")
        for f in ("indptr", "idx", "val"):
            assert torch.equal(getattr(ours, f), getattr(theirs, f)), f
    for ours, theirs in ((port.consts_a, jeng.consts_a),
                         (port.consts_p, jeng.consts_p)):
        for f in vars(ours):
            assert getattr(ours, f) == getattr(theirs, f), f
    for ours, theirs in ((port.mass_a, jeng.mass_a),
                         (port.mass_p, jeng.mass_p)):
        assert float(ours.lam[0]) == float(theirs.lam)
        assert float(ours.max_gibbs_mass[0]) == float(theirs.max_gibbs_mass)

    pstate = convert.sharded_state_from_numpy(jax.device_get(jstate),
                                              device="cpu")
    pstats = convert.sharded_stats_from_numpy(jax.device_get(jstats), 4,
                                              device="cpu")
    assert bool((pstate.atoms_a.n > 0).all()) and int(pstate.atoms_p.n) > 5
    for phase, it in STEPS:
        draws = ShardedJaxDraws(key, phase, it, jax.device_get(jstate),
                                port.consts_a.batch, port.consts_p.batch,
                                fold_units=False)
        jstate, jstats = jeng.run_phase(jstate, jstats, key, phase, it,
                                        it + 1)
        pstate, pstats = port.iteration(pstate, pstats, draws, phase, it)
        assert_sharded_same(pstate, pstats, jstate, jstats, rtol=1e-4,
                            exact_mass=False)
    assert int(pstats.n_stat[0]) == 1


def test_atlas_memory_plan_equals_jax():
    args = dict(n_cells=1_000_000, n_genes=30_000, k=50, density=0.05,
                n_devices=8)
    plan = sparse_sharded.atlas_memory_plan(**args)
    assert plan == jsparse_sharded.atlas_memory_plan(**args)
    assert plan["A_shard"] == 125_000 * 50 * 4
    assert plan["total_per_device"] < 4 * 2**30, plan


def test_sparse_sharded_pads_uneven_genes():
    """Uneven gene counts pad to a shard multiple; results trim back."""
    coo = _coo(n_genes=90)
    cfg = CogapsParams(n_patterns=3, n_iterations=30,
                       seed=1).engine_config(*coo.shape)
    eng = sparse_sharded.SparseShardedEngine(coo, cfg, n_shards=4,
                                             device="cpu")
    assert eng.n_genes == 92 and eng.g_local == 23
    state, _ = eng.run_phase(eng.init_state(), eng.init_stats(),
                             ShardedRandom(0, "cpu"),
                             engine.EQUILIBRATION)
    assert eng.trim(state.M_a.numpy()).shape == (90, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """RUN on 2 gloo ranks (n_shards = 4, a checkpoint left at sampling
    iteration 50) and, meanwhile, on this process with mesh=None."""
    coo = _coo()
    tmp = tmp_path_factory.mktemp("sparse_sharded")
    ranks = launch.start(torch_ranks.rank_run, 2, "sparse", coo, RUN,
                         {"n_shards": 4}, str(tmp / "ranks2"), None,
                         (str(tmp / "mid"), engine.SAMPLING, 50))
    eng, state, stats = torch_ranks.run("sparse", coo, RUN, {"n_shards": 4},
                                        str(tmp / "one"))
    launch.join(ranks, timeout=120)
    return coo, tmp, eng, state, stats


def test_sparse_sharded_converges(runs):
    coo, _, eng, state, stats = runs
    hist = stats.chisq_hist[0].numpy()
    assert hist[0] > 0 and hist[-1] < 0.5 * hist[0]
    M_a = eng.trim(state.M_a.numpy())
    assert M_a.shape == (96, 3) and (M_a >= 0).all()
    # the drift oracle on the replicated P table
    mp = total_mass_per_element(state.atoms_p.chain(0),
                                coo.shape[1] * 3).reshape(-1, 3)
    assert float((mp - state.M_p[0]).abs().max()) < 0.01


def test_sparse_sharded_mesh_none_equals_two_ranks(runs):
    _, tmp, _, _, _ = runs
    torch_ranks.assert_same_bits(
        torch_ranks.result("sparse", str(tmp / "ranks2")),
        torch_ranks.result("sparse", str(tmp / "one")), "2 ranks")
    # the replicated P sampler ran identically on both ranks
    assert torch_ranks.assert_replicas_equal(str(tmp / "ranks2")) == 16


def test_sparse_sharded_resume_exact(runs, tmp_path):
    """Resumed on one process from the 2-rank checkpoint at sampling
    iteration 50: bit-equal to the unbroken run."""
    coo, tmp, _, _, _ = runs
    out = str(tmp_path / "resumed")
    torch_ranks.run("sparse", coo, RUN, {"n_shards": 4}, out,
                    resume=str(tmp / "mid"))
    torch_ranks.assert_same_bits(torch_ranks.result("sparse", out),
                                 torch_ranks.result("sparse",
                                                    str(tmp / "one")),
                                 "resumed")


def test_sparse_sharded_resume_other_shard_count(runs):
    """The 4-shard checkpoint resumed with 2 shards: A atoms re-binned
    through global element ids, mass conserved, M_a as saved, and the
    resumed chain's P masses track M_p."""
    coo, tmp, _, _, _ = runs
    saved, _ = multihost.load_sharded_checkpoint(
        str(tmp / "mid"), (sparse_sharded.STATE_SPEC,
                           sparse_sharded.STATS_SPEC))
    cfg = CogapsParams(**RUN).engine_config(*coo.shape)
    eng2 = sparse_sharded.SparseShardedEngine(coo, cfg, n_shards=2,
                                              device="cpu")
    st, ss, phase, it, seed = eng2.load_checkpoint(str(tmp / "mid"))
    assert (phase, it, seed) == (engine.SAMPLING, 50, RUN["seed"])
    assert st.atoms_a.mass.shape == (2, eng2.cap_a_local)
    assert float(st.atoms_a.mass.sum()) == pytest.approx(
        float(saved.atoms_a.mass.sum()), rel=1e-6)
    np.testing.assert_array_equal(eng2.trim(st.M_a.numpy()),
                                  eng2.trim(saved.M_a))
    for d in range(2):  # every re-binned atom lies on its shard's M
        ma = total_mass_per_element(st.atoms_a.chain(d),
                                    eng2.g_local * 3).reshape(-1, 3)
        assert float((ma - st.M_a[d]).abs().max()) < 0.01
    st, ss = eng2.run_phase(st, ss, ShardedRandom(
        seed, "cpu"), phase, it, it + 20)
    mp = total_mass_per_element(st.atoms_p.chain(0),
                                coo.shape[1] * 3).reshape(-1, 3)
    assert float((mp - st.M_p[0]).abs().max()) < 0.01
