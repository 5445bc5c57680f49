"""The port's subset chains (parallel/distributed.py's multichain
programs) in lockstep with the JAX package's on the CPU.

JAX's padded multichain data of unequal modsim subsets (12 and 13 genes,
genome-wide; 9 and 11 samples, single-cell) and a warmed JAX state are
carried into the port (convert.py), and both run three iterations with
JAX's draws handed to the port chain by chain, in the free and in the
fixed stage, the JAX side op by op (jax.disable_jit). Where the subsets
take the fused span, its plain version (ops/span.py) runs the same
iterations too, so the fused and the per-call routes are held to each
other on padded subsets. Tolerances are tests/test_torch_engine.py's:
equal elem, n and counters; mass, M and the sums within 1e-5; chi^2
within 1e-4. The sparse model's are tests/test_torch_sparse.py's (mass
and M within rtol 1e-4: each package forms the sparse closed forms
itself)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu import engine as jengine
from cogaps_tpu import sparse_engine as jsparse_engine
from cogaps_tpu.parallel import multichain as jmultichain
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu_torch import convert, engine, sparse_engine
from cogaps_tpu_torch.ops import span
from cogaps_tpu_torch.parallel import distributed
from cogaps_tpu_torch.params import CogapsParams
from test_torch_distributed import (GW_SETS, SC_SETS, _fixed_consensus,
                                    _pads, _subsets)
from test_torch_engine import JaxDraws, close, jax_blocks

torch.set_num_threads(1)

LOCK = dict(n_patterns=3, n_iterations=40, seed=5, output_frequency=2)
WARMUP = 16
STEPS = [(engine.EQUILIBRATION, WARMUP), (engine.EQUILIBRATION, WARMUP + 1),
         (engine.SAMPLING, 0)]


class ChainDraws:
    """JAX's draws of every chain at (phase, it) — each chain's
    run_iteration with its own (here the same) key — handed to the
    port's run_iteration, which runs the chains together."""

    def __init__(self, key, phase, it, jstates, cfg):
        self.per_chain = [JaxDraws(key, phase, it, js, cfg) for js in jstates]
        self.cfg = cfg

    def budgets(self, phase, it, n_a, n_p):
        return (torch.tensor([d.n_a for d in self.per_chain],
                             dtype=torch.int32),
                torch.tensor([d.n_p for d in self.per_chain],
                             dtype=torch.int32))

    def sweeps(self, phase, it, sampler):
        a = sampler == engine.SAMPLER_A
        B = self.cfg.batch_a if a else self.cfg.batch_p

        def source(chain, first, n):
            d = self.per_chain[chain]
            return jax_blocks(d.kua if a else d.kup, first, n, B)

        return source


def _chain(tree, c):
    return jax.tree.map(lambda x: x[c], tree)


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def assert_chains_same(pstate, pstats, jstate, jstats, sparse_model):
    ps, pt = convert.to_numpy(pstate), convert.to_numpy(pstats)
    js, jt = jax.device_get(jstate), jax.device_get(jstats)
    rtol = 1e-4 if sparse_model else 1e-5
    for c in range(ps["M_a"].shape[0]):
        for side in ("atoms_a", "atoms_p"):
            ja = getattr(js, side)
            np.testing.assert_array_equal(ps[side]["elem"][c], ja.elem[c],
                                          side)
            np.testing.assert_array_equal(ps[side]["n"][c], ja.n[c], side)
            if sparse_model:
                np.testing.assert_allclose(ps[side]["mass"][c], ja.mass[c],
                                           rtol=rtol, atol=1e-5)
            else:
                close(ps[side]["mass"][c], ja.mass[c], rtol, side)
        for name in ("M_a", "M_p"):
            if sparse_model:
                np.testing.assert_allclose(ps[name][c], getattr(js, name)[c],
                                           rtol=rtol, atol=1e-5)
            else:
                close(ps[name][c], getattr(js, name)[c], rtol, name)
        assert int(pt["upd"][c]) == (int(jt.upd_hi[c]) * (1 << 30)
                                     + int(jt.upd_lo[c]))
        for name in ("n_stat", "prop_counts", "acc_counts", "sweep_counts",
                     "atom_hist_a", "atom_hist_p"):
            np.testing.assert_array_equal(pt[name][c],
                                          getattr(jt, name)[c], name)
        for name in ("a_sum", "a_sumsq", "p_sum", "p_sumsq"):
            close(pt[name][c], getattr(jt, name)[c], rtol, name)
        close(pt["chisq_hist"][c], jt.chisq_hist[c], 1e-4, "chisq_hist")


LOCK_CASES = [("genome-wide", False, False), ("genome-wide", False, True),
              ("single-cell", False, True), ("single-cell", True, False),
              ("single-cell", True, True)]


@pytest.mark.parametrize(
    "mode,sparse_model,fixed", LOCK_CASES,
    ids=[f"{m}-{'sparse' if s else 'dense'}-{'fixed' if f else 'free'}"
         for m, s, f in LOCK_CASES])
def test_subset_chains_lockstep_with_jax(modsim, mode, sparse_model, fixed):
    genome_wide = mode == "genome-wide"
    D = modsim[0]
    if sparse_model:
        D = D * (np.random.default_rng(0).random(D.shape) < 0.6)
    sets = GW_SETS if genome_wide else SC_SETS
    params = CogapsParams(**LOCK)
    consensus = _fixed_consensus(modsim, genome_wide) if fixed else None
    p = distributed._stage_params(params, genome_wide, consensus)
    jp = JParams(**LOCK)
    if fixed:
        jp.n_patterns = 3
        jp.fixed_patterns = consensus
        jp.which_matrix_fixed = p.which_matrix_fixed
    subs = _subsets(D, sets, genome_wide)
    G, S = _pads(subs)
    jcfg = jp.engine_config(G, S)
    pad = distributed._pad_fixed(consensus, S if genome_wide else G)
    key = jax.random.PRNGKey(LOCK["seed"])
    keys = jnp.stack([key] * len(sets))
    if sparse_model:
        jdata, _ = jsparse_engine.stack_sparse_device_data(
            subs, jcfg, pad_rows=G, pad_cols=S)
        jeng = jsparse_engine.SparseMultichainEngine(jdata, jcfg)
        step = jsparse_engine.run_iteration_sparse
    else:
        jdata = jmultichain.stack_device_data(subs, None, jcfg, pad_rows=G,
                                              pad_cols=S)
        jeng = jmultichain.MultichainEngine(jdata, jcfg)
        step = jengine.run_iteration
    jstate, jstats = jeng.run_phase(jeng.init_state(pad), jeng.init_stats(),
                                    keys, engine.EQUILIBRATION, 0, WARMUP)

    cfg = p.engine_config(G, S)
    assert vars(cfg) == vars(jcfg)
    if sparse_model:
        cfg = dataclasses.replace(cfg, sparse_table_mode="xla")
        data = convert.sparse_data_from_numpy(jax.device_get(jeng.data))
        run = sparse_engine.run_iteration_sparse
    else:
        data = convert.device_data_from_numpy(jax.device_get(jeng.data))
        run = engine.run_iteration
    hist = engine.derive_hist(cfg)
    consts_a, consts_p = engine.build_consts(cfg, G, S)
    pstate = convert.chain_state_from_numpy(jax.device_get(jstate))
    pstats = convert.run_stats_from_numpy(jax.device_get(jstats))
    fused = not sparse_model and not fixed
    if fused:  # the fused span's plain version, from the same state
        fstate, fstats = pstate, pstats
    assert_chains_same(pstate, pstats, jstate, jstats, sparse_model)
    for side, free in (("atoms_a", p.which_matrix_fixed != "A"),
                       ("atoms_p", p.which_matrix_fixed != "P")):
        assert bool((getattr(jstate, side).n > 5).all()) == free, side

    for phase, it in STEPS:
        n = len(sets)
        draws = ChainDraws(key, phase, it, [_chain(jstate, c)
                                            for c in range(n)], cfg)
        outs = []
        with jax.disable_jit():
            for c in range(n):
                outs.append(step(jeng.config, jeng.consts_a, jeng.consts_p,
                                 jeng.hist, phase, _chain(jeng.data, c),
                                 jnp.asarray(it, jnp.int32),
                                 _chain(jstate, c), _chain(jstats, c), key))
        jstate = _stack([o[0] for o in outs])
        jstats = _stack([o[1] for o in outs])
        pstate, pstats = run(cfg, consts_a, consts_p, hist, phase, data, it,
                             pstate, pstats, draws)
        assert_chains_same(pstate, pstats, jstate, jstats, sparse_model)
        if fused:
            fstate, fstats = span.run_span_plain(
                cfg, consts_a, consts_p, hist, phase, data, it, 1, fstate,
                fstats, draws)
            assert_chains_same(fstate, fstats, jstate, jstats, False)
    assert int(pstats.n_stat[0]) == 1
    if fixed:  # the fixed factor survives the padding intact
        M = pstate.M_p if genome_wide else pstate.M_a
        for c in range(len(sets)):
            assert torch.equal(M[c], torch.from_numpy(pad))
