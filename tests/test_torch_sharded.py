"""The port's gene-sharded dense chain (cogaps_tpu_torch/parallel/
sharded.py) against cogaps_tpu/parallel/sharded.py on the CPU, and its
contracts: convergence, padding, chi^2, mass drift, bitwise invariance
across gloo groups of 1, 2 and 4 ranks, and a resume on another rank
count.

Lockstep: JAX's ShardedGapsEngine runs on a 1-device and a 4-device mesh
(n_blocks = 8, modsim); its warmed state is carried into the port
(convert.py, mesh=None), and both run the same iterations with JAX's
draws handed to the port: per block the budget jax.random.poisson(
fold_in(kpa, block), max(n, 10)) and the sweep blocks uniform(fold_in(
fold_in(kua, block), i), (16, B)); for P poisson(kpp, ...) and kup's
blocks. The JAX side runs jitted (its shard_map does not run under
jax.disable_jit), so the comparison holds over few enough iterations
that no float32 threshold decision differs. Tolerances are
tests/test_torch_engine.py's: equal elem, n, counters and atom
histories; mass, M and the running sums within 1e-5; chi^2 within
1e-4.

The multi-rank runs are spawned processes (torch.multiprocessing, spawn)
joined in a gloo group on the CPU (tests/torch_ranks.py); their results
must equal the one-process run bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cogaps_tpu.ops import rng as jrng
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu.parallel.sharded import ShardedGapsEngine as JSharded
from cogaps_tpu_torch import convert, engine
from cogaps_tpu_torch.ops.atoms import total_mass_per_element
from cogaps_tpu_torch.params import CogapsParams
from cogaps_tpu_torch.parallel import multihost, sharded
from test_torch_engine import close, jax_blocks
import torch_ranks

torch.set_num_threads(1)

LOCK = dict(n_patterns=3, n_iterations=40, seed=5, output_frequency=2)
WARMUP = 16
STEPS = [(engine.EQUILIBRATION, WARMUP), (engine.EQUILIBRATION, WARMUP + 1),
         (engine.SAMPLING, 0)]


class ShardedJaxDraws:
    """The draws JAX's sharded _iteration makes at (phase, it), in the
    interface of sharded.ShardedRandom. `fold_units` says whether JAX
    keys each unit's budget by its id (the dense engine) or draws every
    device's budget under kpa itself (parallel/sparse_sharded.py)."""

    def __init__(self, key, phase, it, jstate, batch_a, batch_p,
                 fold_units=True):
        key_it = jax.random.fold_in(jax.random.fold_in(key, phase), it)
        kpa, kpp, kua, self.kup = jax.random.split(key_it, 4)
        n_units = np.asarray(jstate.atoms_a.n)
        self.n_a = [int(jrng.poisson(
            jax.random.fold_in(kpa, u) if fold_units else kpa,
            jnp.float32(max(int(n), 10)))) for u, n in enumerate(n_units)]
        self.n_p = int(jrng.poisson(
            kpp, jnp.float32(max(int(jstate.atoms_p.n), 10))))
        self.kua = [jax.random.fold_in(kua, u) for u in range(len(n_units))]
        self.batch = (batch_a, batch_p)

    def budgets(self, phase, it, n_a, n_p, units):
        return (torch.tensor([self.n_a[u] for u in units], dtype=torch.int32),
                torch.tensor([self.n_p], dtype=torch.int32))

    def sweeps(self, phase, it, sampler, units=None):
        if sampler == engine.SAMPLER_A:
            return lambda c, first, n: jax_blocks(self.kua[units[c]], first,
                                                  n, self.batch[0])
        return lambda c, first, n: jax_blocks(self.kup, first, n,
                                              self.batch[1])


def assert_sharded_same(pstate, pstats, jstate, jstats, rtol=1e-5,
                        exact_mass=True):
    """The port's unit-stacked state and statistics against JAX's."""
    js, jt = jax.device_get(jstate), jax.device_get(jstats)
    ps = convert.to_numpy(pstate)
    pt = convert.to_numpy(pstats)
    U = ps["atoms_a"]["n"].shape[0]
    ja = convert.to_numpy(convert.sharded_state_from_numpy(js, device="cpu"))
    jt_u = convert.to_numpy(convert.sharded_stats_from_numpy(jt, U,
                                                             device="cpu"))
    for side in ("atoms_a", "atoms_p"):
        np.testing.assert_array_equal(ps[side]["elem"], ja[side]["elem"],
                                      side)
        np.testing.assert_array_equal(ps[side]["n"], ja[side]["n"], side)
        if exact_mass:
            close(ps[side]["mass"], ja[side]["mass"], rtol, side)
        else:
            np.testing.assert_allclose(ps[side]["mass"], ja[side]["mass"],
                                       rtol=rtol, atol=1e-5)
    for name in ("M_a", "M_p"):
        if exact_mass:
            close(ps[name], ja[name], rtol, name)
        else:
            np.testing.assert_allclose(ps[name], ja[name], rtol=rtol,
                                       atol=1e-5)
    assert int(pt["upd"][0]) == int(jt.upd_hi) * (1 << 30) + int(jt.upd_lo)
    for name in ("n_stat", "prop_counts", "acc_counts", "sweep_counts",
                 "atom_hist_a", "atom_hist_p"):
        np.testing.assert_array_equal(pt[name], jt_u[name], name)
    for name in ("a_sum", "a_sumsq", "p_sum", "p_sumsq"):
        close(pt[name], jt_u[name], rtol, name)
    close(pt["chisq_hist"], jt_u["chisq_hist"], 1e-4, "chisq_hist")


@pytest.fixture(scope="module")
def lock_engines(modsim):
    D = modsim[0]
    jcfg = JParams(**LOCK).engine_config(*D.shape)
    cfg = CogapsParams(**LOCK).engine_config(*D.shape)
    assert vars(cfg) == vars(jcfg)
    jengs = [JSharded(D, None, jcfg, Mesh(np.array(jax.devices()[:n]),
                                          ("genes",)), n_blocks=8)
             for n in (1, 4)]
    port = sharded.ShardedGapsEngine(D, None, cfg, n_blocks=8, device="cpu")
    return D, jengs, port


def test_blocks_equal_jax(lock_engines):
    """The port's padded, blocked data and constants are JAX's."""
    D, jengs, port = lock_engines
    jdata = jax.device_get(jengs[1].data)
    S = D.shape[1]
    np.testing.assert_array_equal(port.D.reshape(-1, S).numpy(), jdata.D)
    np.testing.assert_array_equal(port.invS2.reshape(-1, S).numpy(),
                                  jdata.invS2)
    assert port.n_genes == 32 and port.g_blk == 4
    assert (port.cap_blk, port.batch_blk) == (jengs[1].cap_blk,
                                              jengs[1].batch_blk)
    for ours, theirs in ((port.consts_a, jengs[1].consts_a),
                         (port.consts_p, jengs[1].consts_p)):
        for f in vars(ours):
            assert getattr(ours, f) == getattr(theirs, f), f
    for ours, theirs in ((port.mass_a, jdata.mass_a),
                         (port.mass_p, jdata.mass_p)):
        assert float(ours.lam[0]) == float(theirs.lam)
        assert float(ours.max_gibbs_mass[0]) == float(theirs.max_gibbs_mass)


def test_sharded_lockstep_with_jax(lock_engines):
    D, jengs, port = lock_engines
    key = jax.random.PRNGKey(LOCK["seed"])
    runs = [e.run_phase(e.init_state(), e.init_stats(), key,
                        engine.EQUILIBRATION, 0, WARMUP) for e in jengs]
    jstate, jstats = runs[0]
    pstate = convert.sharded_state_from_numpy(jax.device_get(jstate),
                                              device="cpu")
    pstats = convert.sharded_stats_from_numpy(jax.device_get(jstats), 8,
                                              device="cpu")
    for js, jt in runs:
        assert_sharded_same(pstate, pstats, js, jt)
    assert bool((np.asarray(jstate.atoms_a.n) > 0).all())
    for phase, it in STEPS:
        draws = ShardedJaxDraws(key, phase, it, jax.device_get(runs[0][0]),
                                port.batch_blk, port.config.batch_p)
        runs = [e.run_phase(s, t, key, phase, it, it + 1)
                for e, (s, t) in zip(jengs, runs)]
        pstate, pstats = port.iteration(pstate, pstats, draws, phase, it)
        for js, jt in runs:
            assert_sharded_same(pstate, pstats, js, jt)
    assert int(pstats.n_stat[0]) == 1


# ----------------------------------------------------------------------
# the contracts of tests/test_parallel.py and tests/test_checkpoints.py
# ----------------------------------------------------------------------
INVARIANCE = dict(n_patterns=3, n_iterations=120, seed=9, output_frequency=40)
RANK_COUNTS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs(modsim, tmp_path_factory):
    """Gloo groups of 1, 2 and 4 ranks running the same chain
    (INVARIANCE, n_blocks = 8; the 2-rank group also leaves a checkpoint
    at sampling iteration 60), started together; meanwhile this process
    runs a 100 + 100-iteration chain (the JAX tests' config, n_blocks
    defaulting to 8) and keeps its state after equilibration."""
    from cogaps_tpu_torch.parallel import launch
    D = modsim[0]
    tmp = tmp_path_factory.mktemp("sharded")
    groups = {}
    for n in RANK_COUNTS:
        save = ((str(tmp / "mid"), engine.SAMPLING, 60) if n == 2 else None)
        groups[n] = launch.start(torch_ranks.rank_run, n, "dense", D,
                                 INVARIANCE, {"n_blocks": 8},
                                 str(tmp / f"ranks{n}"), None, save)
    cfg = CogapsParams(n_patterns=3, n_iterations=100, seed=3,
                       output_frequency=50).engine_config(*D.shape)
    eng = sharded.ShardedGapsEngine(D, None, cfg, device="cpu")
    rand = sharded.ShardedRandom(3, "cpu")
    st, ss = eng.run_phase(eng.init_state(), eng.init_stats(), rand,
                           engine.EQUILIBRATION)
    equil = (st, ss)
    st, ss = eng.run_phase(st, ss, rand, engine.SAMPLING)
    for n in RANK_COUNTS:
        launch.join(groups[n], timeout=120)
    return D, tmp, eng, equil, (st, ss)


def test_sharded_chain_converges(runs):
    D, _, eng, _, (state, stats) = runs
    assert eng.n_blocks == 8 and eng.n_genes == 32  # 25 genes pad to 32
    hist = stats.chisq_hist[0].numpy()
    assert hist[-1] < 0.5 * hist[0]
    assert bool((state.atoms_a.n > 0).all())  # every block holds atoms
    assert bool(torch.isfinite(state.M_a).all())
    assert eng.trim(state.M_a.numpy()).shape == (25, 3)
    # padded rows (invS2 = 0) are exact no-ops: no chi^2 from them
    assert float(eng.invS2.reshape(-1, D.shape[1])[25:].abs().sum()) == 0.0


def test_sharded_mass_drift(runs):
    """The replicated P atom table's masses track M_p (the drift oracle,
    AsynchronousGibbsSampler.h:237-270); so do each block's."""
    D, _, eng, (state, _), _ = runs
    k = 3
    mp = total_mass_per_element(state.atoms_p.chain(0),
                                D.shape[1] * k).reshape(-1, k)
    assert float((mp - state.M_p[0]).abs().max()) < 0.01
    for b in range(eng.n_blocks):
        ma = total_mass_per_element(state.atoms_a.chain(b),
                                    eng.g_blk * k).reshape(-1, k)
        assert float((ma - state.M_a[b]).abs().max()) < 0.01


def test_sharded_chisq_matches_manual(runs):
    D, _, eng, (state, stats), _ = runs
    S = np.maximum(0.1 * D, 0.1)
    ap = eng.trim(state.M_a.numpy()) @ state.M_p[0].numpy().T
    manual = float(np.sum(((D - ap) / S) ** 2))
    n_hist = stats.chisq_hist.shape[1]
    reported = float(stats.chisq_hist[0, n_hist // 2 - 1])
    assert reported == pytest.approx(manual, rel=0.02)


def test_sharded_rank_count_invariance(runs):
    """The determinism contract (tests/test_parallel.py::
    test_sharded_device_count_invariance): the same seed gives bitwise
    the same trajectory — atom tables, factors, statistics and the chi^2
    history — on gloo groups of 1, 2 and 4 ranks, with n_blocks = 8; and
    every rank holds the same M_p, P atom table and counters."""
    _, tmp, _, _, _ = runs
    ref = torch_ranks.result("dense", str(tmp / "ranks1"))
    for n in RANK_COUNTS[1:]:
        torch_ranks.assert_same_bits(
            torch_ranks.result("dense", str(tmp / f"ranks{n}")), ref,
            f"{n} ranks")
        # the replicated P sampler ran identically on every rank
        assert torch_ranks.assert_replicas_equal(str(tmp / f"ranks{n}")) == 16
    hist = multihost.load_sharded_checkpoint(
        str(tmp / "ranks1"), (sharded.STATE_SPEC, sharded.STATS_SPEC))[
            1].chisq_hist
    assert np.isfinite(hist).all() and hist[0, -1] < hist[0, 0]


def test_sharded_resume_on_other_rank_count(runs, tmp_path):
    """tests/test_checkpoints.py::test_sharded_checkpoint_resume_exact: a
    checkpoint written by 2 ranks at sampling iteration 60, resumed by
    one process (mesh=None), ends bit-equal to the unbroken 2-rank run;
    the files are named and keyed as the JAX package's."""
    D, tmp, _, _, _ = runs
    files = multihost.shard_files(str(tmp / "mid"))
    assert [f.rsplit(".", 2)[-2] for f in files] == ["shard0", "shard1"]
    with np.load(files[1]) as z:
        assert int(z["process_id"]) == 1 and int(z["num_processes"]) == 2
        assert "leaf0_shard(slice(4, 8, None), slice(None, None, None))" in (
            z.files)
        assert int(z["extra_n_blocks"]) == 8 and int(z["extra_iter"]) == 60
    out = str(tmp_path / "resumed")
    torch_ranks.run("dense", D, INVARIANCE, {"n_blocks": 8}, out,
                    resume=str(tmp / "mid"))
    torch_ranks.assert_same_bits(torch_ranks.result("dense", out),
                                 torch_ranks.result("dense",
                                                    str(tmp / "ranks2")),
                                 "resumed on 1 rank")
    eng = sharded.ShardedGapsEngine(D, None, CogapsParams(
        **INVARIANCE).engine_config(*D.shape), n_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="n_blocks"):
        eng.load_checkpoint(str(tmp / "mid"))


def test_convert_defaults_to_the_card():
    """Every *_from_numpy function of convert.py puts its tensors on the
    card unless asked otherwise, as the port's other entry points do."""
    import inspect
    names = [n for n in dir(convert) if n.endswith("_from_numpy")]
    assert len(names) >= 8
    for name in names:
        default = inspect.signature(getattr(convert, name)).parameters[
            "device"].default
        assert default == "cuda", name
