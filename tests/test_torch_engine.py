"""The port's iteration (cogaps_tpu_torch/engine.run_iteration) against
cogaps_tpu/engine.run_iteration on the CPU (the XLA sweep path).

The JAX engine runs 16 equilibration iterations on modsim, with both
factors free and with A fixed to the true factor; its state is
carried into the port through convert.py, and then both packages run
the same iterations in lockstep. The port gets the JAX draws: the
budgets rng.poisson_fast(kpa/kpp, max(n, 10)) and the sweep blocks
uniform(fold_in(kua/kup, i), (16, B)) (engine.py:140-155). The JAX side
runs op by op (jax.disable_jit), as tests/test_torch_sweep.py explains.
Tolerances: equal atom tables (elem, n), counters, histories of atom
counts and PUMP; mass, M and the running sums within 1e-5; chi^2 within
1e-4 (a matrix product summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu import engine as jengine
from cogaps_tpu.ops import rng as jrng
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu_torch import convert, engine
from cogaps_tpu_torch.params import CogapsParams

torch.set_num_threads(1)

PARAMS = dict(n_patterns=3, n_iterations=40, seed=5, output_frequency=2,
              n_snapshots=20, snapshot_phase="all", take_pump_samples=True)
WARMUP = 16  # JAX equilibration iterations before the lockstep
LOCKSTEP = [(jengine.EQUILIBRATION, WARMUP), (jengine.SAMPLING, 0),
            (jengine.SAMPLING, 1)]


def jax_blocks(key, first, n, B):
    return torch.from_numpy(np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, first + i), (16, B), jnp.float32))
        for i in range(n)]))


class JaxDraws:
    """The draws JAX's run_iteration makes at (phase, it), handed to the
    port's run_iteration (engine.py:140-155)."""

    def __init__(self, base_key, phase, it, jstate, cfg):
        key_it = jax.random.fold_in(jax.random.fold_in(base_key, phase), it)
        kpa, kpp, self.kua, self.kup = jax.random.split(key_it, 4)
        self.n_a = int(jrng.poisson_fast(
            kpa, jnp.maximum(jstate.atoms_a.n, 10).astype(jnp.float32)))
        self.n_p = int(jrng.poisson_fast(
            kpp, jnp.maximum(jstate.atoms_p.n, 10).astype(jnp.float32)))
        self.cfg = cfg

    def budgets(self, phase, it, n_a, n_p):
        return (torch.tensor([self.n_a], dtype=torch.int32),
                torch.tensor([self.n_p], dtype=torch.int32))

    def sweeps(self, phase, it, sampler):
        key = self.kua if sampler == engine.SAMPLER_A else self.kup
        B = self.cfg.batch_a if sampler == engine.SAMPLER_A else self.cfg.batch_p

        def source(chain, first, n):
            assert chain == 0
            return jax_blocks(key, first, n, B)

        return source


def close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(float(np.abs(b).max()), 1.0),
                               err_msg=what)


def assert_same(pstate, pstats, jstate, jstats):
    ps, pt = convert.to_numpy(pstate), convert.to_numpy(pstats)
    js, jt = jax.device_get(jstate), jax.device_get(jstats)
    for side in ("atoms_a", "atoms_p"):
        ja = getattr(js, side)
        np.testing.assert_array_equal(ps[side]["elem"][0], ja.elem, side)
        np.testing.assert_array_equal(ps[side]["n"][0], ja.n, side)
        close(ps[side]["mass"][0], ja.mass, 1e-5, side)
    close(ps["M_a"][0], js.M_a, 1e-5, "M_a")
    close(ps["M_p"][0], js.M_p, 1e-5, "M_p")
    assert int(pt["upd"][0]) == int(jt.upd_hi) * (1 << 30) + int(jt.upd_lo)
    for name in ("n_stat", "n_pump", "prop_counts", "acc_counts",
                 "sweep_counts", "atom_hist_a", "atom_hist_p", "pump"):
        np.testing.assert_array_equal(pt[name][0], getattr(jt, name), name)
    for name in ("a_sum", "a_sumsq", "p_sum", "p_sumsq", "snap_a", "snap_p"):
        close(pt[name][0], getattr(jt, name), 1e-5, name)
    close(pt["chisq_hist"][0], jt.chisq_hist, 1e-4, "chisq_hist")


def run_params(fixed, A_true):
    """PARAMS, with the A matrix fixed to the true factor for "A"."""
    if fixed == "N":
        return dict(PARAMS)
    return dict(PARAMS, which_matrix_fixed="A", fixed_patterns=A_true)


@pytest.fixture(scope="module", params=["N", "A"],
                ids=["free", "fixed_A"])
def warm(modsim, request):
    D, A_true, _ = modsim
    prm = run_params(request.param, A_true)
    jcfg = JParams(**prm).engine_config(*D.shape)
    jeng = jengine.GapsEngine(D, None, jcfg)
    key = jax.random.PRNGKey(PARAMS["seed"])
    jstate, jstats = jeng.run_span(
        jeng.init_state(prm.get("fixed_patterns")), jeng.init_stats(), key,
        jengine.EQUILIBRATION, 0, WARMUP)
    return D, prm, jcfg, jeng, key, jstate, jstats


def test_engine_config_is_the_same(warm):
    D, prm, jcfg, *_ = warm
    cfg = CogapsParams(**prm).engine_config(*D.shape)
    assert vars(cfg) == vars(jcfg)


def test_run_iteration_matches_jax_in_lockstep(warm):
    D, prm, jcfg, jeng, key, jstate, jstats = warm
    cfg = CogapsParams(**prm).engine_config(*D.shape)
    hist = engine.derive_hist(cfg)
    consts_a, consts_p = engine.build_consts(cfg, *D.shape)
    data = convert.device_data_from_numpy(jax.device_get(jeng.data),
                                          device="cpu")
    pstate = convert.chain_state_from_numpy(jax.device_get(jstate),
                                            device="cpu")
    pstats = convert.run_stats_from_numpy(jax.device_get(jstats), device="cpu")
    assert_same(pstate, pstats, jstate, jstats)
    assert int(jstate.atoms_p.n) > 10
    assert int(jstate.atoms_a.n) > 10 or cfg.which_matrix_fixed == "A"

    for phase, it in LOCKSTEP:
        draws = JaxDraws(key, phase, it, jstate, cfg)
        with jax.disable_jit():
            jstate, jstats = jengine.run_iteration(
                jcfg, jeng.consts_a, jeng.consts_p, jeng.hist, phase,
                jeng.data, jnp.asarray(it, jnp.int32), jstate, jstats, key)
        pstate, pstats = engine.run_iteration(
            cfg, consts_a, consts_p, hist, phase, data, it, pstate, pstats,
            draws)
        assert_same(pstate, pstats, jstate, jstats)
    # the lockstep exercised the sampling statistics and the histories
    # (PUMP counts only when both factors are sampled)
    assert int(pstats.n_stat[0]) == 2
    assert int(pstats.n_pump[0]) == (2 if cfg.which_matrix_fixed == "N"
                                     else 0)
    assert (pstats.chisq_hist[0] > 0).sum() >= 2
    assert (pstats.snap_a[0].abs().sum(dim=(1, 2)) > 0).sum() >= 2


def test_convert_round_trip(warm):
    _, _, _, jeng, _, jstate, jstats = warm
    pstate = convert.chain_state_from_numpy(jax.device_get(jstate),
                                            device="cpu")
    as_map = convert.to_numpy(pstate)
    again = convert.chain_state_from_numpy(as_map, device="cpu")
    for side in ("atoms_a", "atoms_p"):
        for f in ("mass", "elem", "n"):
            assert torch.equal(getattr(getattr(again, side), f),
                               getattr(getattr(pstate, side), f))
    pstats = convert.run_stats_from_numpy(jax.device_get(jstats), device="cpu")
    total = int(jstats.upd_hi) * (1 << 30) + int(jstats.upd_lo)
    assert pstats.upd.dtype == torch.int64 and int(pstats.upd[0]) == total
    data = convert.device_data_from_numpy(jax.device_get(jeng.data),
                                          device="cpu")
    assert data.D.shape == (1,) + tuple(jeng.data.D.shape)
    assert torch.equal(data.D_t[0], data.D[0].T)


def test_philox_engine_is_deterministic(modsim):
    """Multi-chain runs with PhiloxRandom repeat for the same seeds, and
    the chains of one run differ."""
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    D, _, _ = modsim
    cfg = CogapsParams(n_patterns=3, n_iterations=6,
                       output_frequency=3).engine_config(*D.shape)

    def run(seeds, chain_index):
        data = stack_device_data([D] * len(seeds), None, cfg, "cpu")
        eng = MultichainEngine(data, cfg, "cpu")
        rand = engine.PhiloxRandom(seeds, "cpu")
        st, ss = eng.init_state(), eng.init_stats()
        for ph in (engine.EQUILIBRATION, engine.SAMPLING):
            st, ss = eng.run_phase(st, ss, rand, ph)
        return st.M_a[chain_index], ss.chisq_hist[chain_index]

    m3, h3 = run([3, 4, 5], 0)
    again, h_again = run([3, 4, 5], 0)
    assert torch.equal(m3, again) and torch.equal(h3, h_again)
    other, _ = run([3, 4, 5], 1)
    assert not torch.equal(m3, other)
