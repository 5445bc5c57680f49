"""The fused-span path of the port (ops/span.py, ops/span_cuda.py and
MultichainEngine's span route) against the JAX package on the CPU.

The JAX fused-span kernel (cogaps_tpu/ops/pallas_iter.py::_kernel_span)
draws its budgets from the TPU's on-core generator, which gives zeros in
interpret mode, so it is held to the port through its pure-lax pieces and
through the path it replaces:

(a) the port's tables under the kernel's rule (float64 sums rounded once)
    equal JAX's _rebuild_A/_rebuild_P/_colnz_from_slab on slab inputs
    within float32 rounding: |port - jax| <= 1e-6 * max|jax| (the A pair
    term, which the TPU kernel forms on the fly, against JAX's
    models/dense.make_phase Z);
(b) the budget formula from normals equals JAX's _budget with its
    uniforms injected, exactly, including lam = 10 floors and .5 ties;
(c) ops/span.py run over iterations across the equilibration -> sampling
    boundary with JAX's draws injected equals cogaps_tpu/engine.
    run_iteration run op by op (jax.disable_jit) as many times: equal atom
    tables (elem, n) and counters, mass, M and the running sums within
    1e-5 (the lockstep tolerances of tests/test_torch_engine.py);
(d) MultichainEngine takes the span route exactly when the JAX package's
    semantic conditions hold (16 chains allowed), and on it equals
    ops/span.py called directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu import engine as jengine
from cogaps_tpu.models import dense as jdense
from cogaps_tpu.ops import pallas_iter, pallas_sweep
from cogaps_tpu.ops import rng as jrng
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu_torch import convert, engine
from cogaps_tpu_torch.ops import rng, span, span_cuda
from cogaps_tpu_torch.parallel import multichain
from cogaps_tpu_torch.params import CogapsParams
from test_torch_engine import close, jax_blocks

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# (a) tables
# ----------------------------------------------------------------------
def tables_case(G, S, k):
    """Two chains' data and factors (a dead column on each side), and the
    JAX package's tables of them: _rebuild_A/_rebuild_P/_colnz_from_slab,
    and models/dense.make_phase's Z for the A side."""
    rs = np.random.default_rng(G + S)
    Ds = [rs.gamma(2.0, 2.0, (G, S)).astype(np.float32) for _ in range(2)]
    cfg = CogapsParams(n_patterns=k, n_iterations=10,
                       output_frequency=0).engine_config(G, S)
    data = multichain.stack_device_data(Ds, None, cfg, "cpu")
    M_a = rs.gamma(2.0, 1.0, (2, G, k)).astype(np.float32)
    M_p = rs.gamma(2.0, 1.0, (2, S, k)).astype(np.float32)
    M_p[1, :, 1] = 0.0  # a dead column: col_nz false on the A side
    M_a[0, :, 2] = 0.0  # and on the P side

    D, inv = data.D.numpy(), data.invS2.numpy()
    sd = pallas_iter.prepare_span_data(jnp.asarray(D), jnp.asarray(inv))
    RH, _ = pallas_sweep.slab_shape(G, k)
    M2a = pallas_sweep.to_slab(jnp.asarray(M_a))
    M2p = pallas_sweep.to_slab(jnp.asarray(M_p))
    SQ2a, Y2a = pallas_iter._rebuild_A(M2a, M2p, sd.D2pad, sd.inv2pad, RH,
                                       k, S)
    SQ2p, Y2p, Z2p = pallas_iter._rebuild_P(M2a, M2p, sd.D2pad, sd.inv2pad,
                                            RH, k, S)
    jax_tables = {
        "Y_a": pallas_sweep.from_slab(Y2a, G, k),
        "SQ_a": pallas_sweep.from_slab(SQ2a, G, k),
        "Z_a": jnp.stack([jdense.make_phase(jnp.asarray(inv[c]),
                                            jnp.asarray(M_p[c])).Z
                          for c in range(2)]),
        "Y_p": Y2p[:, :S], "SQ_p": SQ2p[:, :S],
        "Z_p": Z2p[:, :S].reshape(2, S * k, k),
        "col_nz_a": jnp.max(M2p[:, :S, :], axis=1) > 0.0,
        "col_nz_p": pallas_iter._colnz_from_slab(M2a, RH, k)[:, :, 0] > 0,
    }
    return (data, torch.from_numpy(M_a), torch.from_numpy(M_p),
            {name: np.asarray(x) for name, x in jax_tables.items()})


def assert_tables_match_jax(port, jax_tables):
    for name, want in jax_tables.items():
        got = getattr(port, name).numpy()
        assert got.shape == want.shape, name
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, name)
            continue
        got, want = got.astype(np.float64), want.astype(np.float64)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name


@pytest.mark.parametrize("G,S,k", [(40, 9, 3), (130, 7, 4)])
def test_tables_match_jax_rebuilds(G, S, k):
    data, M_a, M_p, jax_tables = tables_case(G, S, k)
    port = span_cuda.rebuild_tables(data, M_a, M_p)
    assert_tables_match_jax(port, jax_tables)
    assert not jax_tables["col_nz_a"][1, 1]
    assert not jax_tables["col_nz_p"][0, 2]


# ----------------------------------------------------------------------
# (a') the kernel's split of the rebuild over a thread-block cluster
# ----------------------------------------------------------------------
# clusters of 1024-thread CTAs resident at once: 16 only where a GPC
# holds 16 SMs
H100_ACTIVE = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("nch,active,want", [
    (1, H100_ACTIVE, 16), (4, H100_ACTIVE, 16), (7, H100_ACTIVE, 16),
    (8, H100_ACTIVE, 8), (16, H100_ACTIVE, 8), (32, H100_ACTIVE, 4),
    (64, H100_ACTIVE, 2), (200, H100_ACTIVE, 1),
    # fewer clusters resident than chains: the next size down
    (4, {16: 3, 8: 16, 4: 33, 2: 66, 1: 132}, 8),
    (16, {16: 7, 8: 14, 4: 33, 2: 66, 1: 132}, 4),
    (16, {16: 7, 8: 15, 4: 15, 2: 66, 1: 132}, 2),
    (64, {16: 7, 8: 16, 4: 33, 2: 63, 1: 132}, 1),
    (1, {16: 0, 8: 0, 4: 0, 2: 0, 1: 0}, 1),
    # small CTAs: many resident a cluster size, still one CTA an SM
    (8, {16: 32, 8: 64, 4: 128, 2: 256, 1: 528}, 16),
    (9, {16: 32, 8: 64, 4: 128, 2: 256, 1: 528}, 8),
    (20, {16: 32, 8: 64, 4: 128, 2: 256, 1: 528}, 4),
])
def test_cluster_size_rule(nch, active, want):
    asked = []

    def max_active(cl):
        asked.append(cl)
        return active[cl]

    cl = span_cuda.cluster_size(nch, 132, max_active)
    assert cl == want
    assert cl in span_cuda.CLUSTER_SIZES and (cl == 1 or nch * cl <= 132)
    assert all(c > cl for c in asked[:-1]) and 1 not in asked


def covered(NR, m, k, threads, cl):
    """How often the kernel's loops (csrc/span.cu::rebuild, as planned)
    reach each (row, partner, column tile): ranks' runs of units, passes
    over the column blocks, partner tiles, and each warp's item (16 rows
    by a column block)."""
    plan = span_cuda.rebuild_plan(NR, m, k, threads, cl)
    ny, nt = span_cuda.column_tiles(k)
    assert plan.tile_rows % 16 == 0 and plan.tile_j % 8 == 0
    assert plan.cj % 4 == 0
    nsub, warps = plan.tile_rows // 16, threads // 32
    assert nsub * plan.cb_wave <= warps  # every item has a warp
    assert -(-nt // plan.ncb) <= span_cuda.NTW  # and fits its registers
    hits = np.zeros((NR, m, nt), np.int64)
    n_rt = -(-NR // plan.tile_rows)
    n_units = n_rt * plan.nchunk
    for rank in range(cl):
        for u in range(rank * n_units // cl, (rank + 1) * n_units // cl):
            ch, rt = divmod(u, n_rt)
            r0, j0 = rt * plan.tile_rows, ch * plan.cj
            nr, nj_ch = min(plan.tile_rows, NR - r0), min(plan.cj, m - j0)
            for cb0 in range(0, plan.ncb, plan.cb_wave):
                cb1 = min(plan.ncb, cb0 + plan.cb_wave)
                for warp in range(warps):
                    sub, cb = warp % nsub, cb0 + warp // nsub
                    if warp // nsub >= plan.cb_wave or cb >= cb1:
                        continue
                    cols = slice(span_cuda.block_start(nt, plan.ncb, cb),
                                 span_cuda.block_start(nt, plan.ncb, cb + 1))
                    rows = slice(r0 + 16 * sub, r0 + min(16 * sub + 16, nr))
                    for jt in range(0, nj_ch, plan.tile_j):
                        js = slice(j0 + jt, j0 + min(jt + plan.tile_j, nj_ch))
                        hits[rows, js, cols] += 1
    return plan, hits


@pytest.mark.parametrize("cl", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("NR,m,k,threads", [
    (1363, 9, 7, 1024), (9, 1363, 7, 1024), (30, 8, 3, 32), (8, 30, 3, 32),
    (5, 3, 1, 32), (3, 700, 2, 64), (600, 5, 3, 1024), (130, 7, 4, 256),
    (12, 20, 2, 32), (20, 12, 2, 32), (2, 41, 16, 160)])
def test_rebuild_plan_covers_each_entry_once(NR, m, k, threads, cl):
    plan, hits = covered(NR, m, k, threads, cl)
    assert (hits == 1).all()
    # the order of the sums: chunks from the shape alone
    assert (plan.cj, plan.nchunk) == span_cuda.chunks(NR, m)
    # within the card's 227 KB a CTA beside the sweep's own shared memory
    assert span_cuda.rebuild_bytes(plan, k) <= span_cuda.TILE_BYTES


def test_rebuild_plan_at_the_main_path_shapes():
    """GIST and 20000x100 k=10: the A side's sums (9 or 100 partners) in
    one chunk, each in partner order; the P side's over the genes in
    chunks, at most 256 partners each, their partials added in order."""
    for cl in (16, 8, 4):
        a = span_cuda.rebuild_plan(1363, 9, 7, 1024, cl)
        p = span_cuda.rebuild_plan(9, 1363, 7, 1024, cl)
        assert (a.cj, a.nchunk, a.tile_j) == (12, 1, 16)  # staged once
        assert (p.cj, p.nchunk) == (172, 8) and p.tile_rows == 16
        n_rt = -(-1363 // a.tile_rows)
        assert n_rt >= cl - 1 and -(-n_rt // cl) <= 3  # 1-3 row tiles a CTA
    wide_a = span_cuda.rebuild_plan(20000, 100, 10, 1024, 4)
    wide_p = span_cuda.rebuild_plan(100, 20000, 10, 1024, 4)
    assert (wide_a.cj, wide_a.nchunk) == (100, 1)
    assert wide_a.tile_j < wide_a.cj  # more partners than a tile
    assert (wide_p.cj, wide_p.nchunk) == (256, 79)
    assert wide_a.ncb == wide_a.cb_wave == 3  # 9 column tiles, one pass
    assert span_cuda.block_threads(1024, 32, 7) == 1024
    assert span_cuda.block_threads(32, 32, 16) == 64  # 4 + 34 groups


@pytest.mark.parametrize("cl", [1, 2, 8])
@pytest.mark.parametrize("G,S,k", [(40, 9, 3), (130, 7, 4), (2100, 5, 3)])
def test_split_tables_match_plain_and_jax(G, S, k, cl):
    """The kernel's order of sums (chunk partials added in order) gives
    the plain tables bit for bit, and JAX's within float32 rounding;
    (2100, 5, 3) has more P-side partners than a chunk holds."""
    data, M_a, M_p, jax_tables = tables_case(G, S, k)
    split = span_cuda.rebuild_tables_split(data, M_a, M_p, cl)
    plain = span.rebuild_tables_plain(data, M_a, M_p)
    for name, x, y in zip(split._fields, split, plain):
        assert torch.equal(x, y), name
    assert_tables_match_jax(split, jax_tables)
    if G == 2100:  # the P side's chunks, added in chunk order
        p = span_cuda.rebuild_plan(S, G, k, 1024, cl)
        assert p.nchunk > 1


# ----------------------------------------------------------------------
# (b) budgets
# ----------------------------------------------------------------------
def test_budget_formula_matches_jax_budget(monkeypatch):
    rs = np.random.default_rng(3)
    n_atoms = np.array([0, 3, 9, 10, 11, 57, 1000, 3500, 2 ** 20, 2 ** 22,
                        2 ** 22 + 1, 2 ** 23 - 1], np.int32)
    u = np.concatenate([rs.random((200, n_atoms.size), dtype=np.float32),
                        np.float32([[1e-9], [0.5], [1.0 - 1e-9]])
                        * np.ones((1, n_atoms.size), np.float32)])
    n = np.broadcast_to(n_atoms, u.shape).copy()
    monkeypatch.setattr(pallas_iter, "_prng_uniform",
                        lambda shape: jnp.asarray(u).reshape(shape))
    lam = jnp.maximum(jnp.asarray(n), 10).astype(jnp.float32)
    want = np.asarray(pallas_iter._budget(lam)).astype(np.int64)
    z = np.array(pallas_sweep._ndtri(jnp.clip(jnp.asarray(u), 1e-7,
                                                1.0 - 1e-7)))
    got = rng.budget(torch.from_numpy(z), torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, want)
    # the draws held .5 ties (lam + sqrt(lam) z exactly half an integer)
    lam32 = np.maximum(n, 10).astype(np.float32)
    x = lam32 + np.sqrt(lam32) * z
    assert ((x - np.floor(x)) == 0.5).sum() > 10
    assert (got[:, :3] >= 0).all() and (want == 0).any()


# ----------------------------------------------------------------------
# (c) a multi-iteration span against JAX's run_iteration, op by op
# ----------------------------------------------------------------------
PARAMS = dict(n_patterns=3, n_iterations=20, seed=5, output_frequency=0)
WARMUP = 18  # JAX equilibration iterations before the span
SPANS = [(jengine.EQUILIBRATION, WARMUP, 2), (jengine.SAMPLING, 0, 2)]


class JaxSpanDraws:
    """The draws JAX's run_iteration makes at each (phase, it), from the
    atom counts the port's span passes (cogaps_tpu/engine.py:140-155)."""

    def __init__(self, base_key, cfg):
        self.base_key = base_key
        self.cfg = cfg

    def _keys(self, phase, it):
        key_it = jax.random.fold_in(jax.random.fold_in(self.base_key, phase),
                                    it)
        return jax.random.split(key_it, 4)

    def budgets(self, phase, it, n_a, n_p):
        kpa, kpp, _, _ = self._keys(phase, it)

        def draw(k, n):
            return torch.tensor([int(jrng.poisson_fast(
                k, jnp.maximum(int(n[0]), 10).astype(jnp.float32)))],
                dtype=torch.int32)

        return draw(kpa, n_a), draw(kpp, n_p)

    def sweeps(self, phase, it, sampler):
        _, _, kua, kup = self._keys(phase, it)
        a = sampler == engine.SAMPLER_A
        key, B = (kua, self.cfg.batch_a) if a else (kup, self.cfg.batch_p)
        return lambda chain, first, n: jax_blocks(key, first, n, B)


def assert_span_same(pstate, pstats, jstate, jstats):
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
    for name in ("n_stat", "prop_counts", "acc_counts", "sweep_counts"):
        np.testing.assert_array_equal(pt[name][0], getattr(jt, name), name)
    for name in ("a_sum", "a_sumsq", "p_sum", "p_sumsq"):
        close(pt[name][0], getattr(jt, name), 1e-5, name)


def test_span_matches_jax_iterations(modsim):
    D, _, _ = modsim
    jcfg = JParams(**PARAMS).engine_config(*D.shape)
    jeng = jengine.GapsEngine(D, None, jcfg)
    key = jax.random.PRNGKey(PARAMS["seed"])
    jstate, jstats = jeng.run_span(jeng.init_state(), jeng.init_stats(), key,
                                   jengine.EQUILIBRATION, 0, WARMUP)
    assert int(jstate.atoms_a.n) > 10 and int(jstate.atoms_p.n) > 10

    cfg = CogapsParams(**PARAMS).engine_config(*D.shape)
    hist = engine.derive_hist(cfg)
    consts_a, consts_p = engine.build_consts(cfg, *D.shape)
    data = convert.device_data_from_numpy(jax.device_get(jeng.data),
                                          device="cpu")
    pstate = convert.chain_state_from_numpy(jax.device_get(jstate),
                                            device="cpu")
    pstats = convert.run_stats_from_numpy(jax.device_get(jstats), device="cpu")
    draws = JaxSpanDraws(key, cfg)
    for phase, it0, n_it in SPANS:
        pstate, pstats = span.run_span_plain(cfg, consts_a, consts_p, hist,
                                             phase, data, it0, n_it, pstate,
                                             pstats, draws)
        for it in range(it0, it0 + n_it):
            with jax.disable_jit():
                jstate, jstats = jengine.run_iteration(
                    jcfg, jeng.consts_a, jeng.consts_p, jeng.hist, phase,
                    jeng.data, jnp.asarray(it, jnp.int32), jstate, jstats,
                    key)
        assert_span_same(pstate, pstats, jstate, jstats)
    assert int(pstats.n_stat[0]) == 2
    assert int(pstats.acc_counts[0].sum()) > 0


# ----------------------------------------------------------------------
# (d) the engine's route
# ----------------------------------------------------------------------
GATE = [  # (CogapsParams changes, n_samples, chains, takes the span)
    ({}, 20, 2, True),
    ({}, 20, 16, True),
    ({}, 128, 2, True),
    ({}, 129, 2, False),
    ({"output_frequency": 3}, 20, 2, False),
    ({"n_snapshots": 2}, 20, 2, False),
    ({"take_pump_samples": True}, 20, 2, False),
    ({"which_matrix_fixed": "A"}, 20, 2, False),
]


def small_engine(changes, n_samples, n_chains, n_iterations=6, n_genes=12):
    rs = np.random.default_rng(n_samples)
    D = rs.gamma(2.0, 2.0, (n_genes, n_samples)).astype(np.float32)
    prm = dict(n_patterns=2, n_iterations=n_iterations, output_frequency=0)
    prm.update(changes)
    if prm.get("which_matrix_fixed") == "A":
        prm["fixed_patterns"] = rs.gamma(2.0, 1.0, (n_genes, 2))
    p = CogapsParams(**prm)
    cfg = p.engine_config(*D.shape)
    data = multichain.stack_device_data([D] * n_chains, None, cfg, "cpu")
    eng = multichain.MultichainEngine(data, cfg, "cpu")
    return eng, p.fixed_patterns


@pytest.mark.parametrize("changes,n_samples,n_chains,fused", GATE)
def test_engine_takes_the_span_route_when_jax_would(monkeypatch, changes,
                                                    n_samples, n_chains,
                                                    fused):
    eng, fixed = small_engine(changes, n_samples, n_chains)
    assert eng._fused_ok() is fused
    calls = []
    real = span_cuda.run_span

    def spy(*args):
        calls.append(args[6:8])  # (it0, n_it)
        return real(*args)

    monkeypatch.setattr(span_cuda, "run_span", spy)
    rand = engine.PhiloxRandom(range(n_chains), "cpu")
    st, ss = eng.init_state(fixed), eng.init_stats()
    st, ss = eng.run_phase(st, ss, rand, engine.EQUILIBRATION, 0, 2)
    assert bool(calls) is fused
    if not fused:  # the per-call route, as before
        st2, ss2 = engine.ChainEngine.run_phase(
            eng, eng.init_state(fixed), eng.init_stats(),
            engine.PhiloxRandom(range(n_chains), "cpu"),
            engine.EQUILIBRATION, 0, 2)
        assert torch.equal(st.M_a, st2.M_a) and torch.equal(ss.upd, ss2.upd)


@pytest.mark.parametrize("slack,fused", [(0, True), (-1, False)])
def test_engine_gate_bounds_the_rebuild_work(monkeypatch, slack, fused):
    eng, _ = small_engine({}, 20, 2)
    ops = span_cuda.rebuild_ops(eng.n_genes, eng.n_samples,
                                eng.config.n_patterns)
    assert ops == 2 * 12 * 20 * (7 * 2 + 2 + 3 * 3)
    monkeypatch.setattr(multichain, "MAX_SPAN_REBUILD_OPS",
                        ((1, 0), (2, ops + slack), (16, 10 ** 12)))
    assert multichain.max_span_rebuild_ops(2) == ops + slack
    assert eng._fused_ok() is fused


@pytest.mark.parametrize("G,S,k,fused16,fused4", [
    (2000, 32, 7, True, True),        # 17.3 M rebuild operations
    (4000, 64, 7, True, True),        # 69.1 M
    (5005, 100, 10, False, True),     # 237 M
    (6000, 100, 10, False, True),     # 284 M
    (10000, 100, 10, False, True),    # 474 M
    (20000, 100, 10, False, False),   # 948 M
])
def test_engine_gate_at_the_measured_shapes(G, S, k, fused16, fused4):
    """profile_iter's shapes of wide data with few samples: the span route
    below the crossover measured at the program's chain count, per-call
    beyond it (16 chains: 200 M; up to 4: 500 M); a one-chain engine
    takes the few-chains limit; 2000x32 lies between the first design's
    10 M gate and these."""
    cfg = CogapsParams(n_patterns=k, n_iterations=2,
                       output_frequency=0).engine_config(G, S)
    for n, fused in ((16, fused16), (4, fused4)):
        assert multichain.span_size_ok(G, S, k, n, cfg.batch_a,
                                       cfg.batch_p) is fused
    data = multichain.stack_device_data([np.ones((G, S), np.float32)], None,
                                        cfg, "cpu")
    eng = multichain.MultichainEngine(data, cfg, "cpu")
    assert eng._fused_ok() is fused4
    if G == 2000:
        assert 10_000_000 < span_cuda.rebuild_ops(G, S, k)


def test_engine_span_route_equals_plain_span(monkeypatch):
    """run_phase in chunks (CHUNK set to 4 here) with progress at chunk
    ends equals one plain span per phase."""
    monkeypatch.setattr(span_cuda, "CHUNK", 4)
    eng, _ = small_engine({}, 20, 3, n_iterations=10)
    progress = []
    rand = engine.PhiloxRandom([7, 8, 9], "cpu")
    st, ss = eng.init_state(), eng.init_stats()
    for ph in (engine.EQUILIBRATION, engine.SAMPLING):
        st, ss = eng.run_phase(st, ss, rand, ph,
                               progress_cb=lambda p, i, s: progress.append(
                                   (p, i)))
    assert progress == [(0, 4), (0, 8), (0, 10), (1, 4), (1, 8), (1, 10)]

    rand = engine.PhiloxRandom([7, 8, 9], "cpu")
    st2, ss2 = eng.init_state(), eng.init_stats()
    for ph in (engine.EQUILIBRATION, engine.SAMPLING):
        st2, ss2 = span.run_span_plain(eng.config, eng.consts_a,
                                       eng.consts_p, eng.hist, ph, eng.data,
                                       0, 10, st2, ss2, rand)
    for a, b in ((st.M_a, st2.M_a), (st.M_p, st2.M_p),
                 (st.atoms_a.elem, st2.atoms_a.elem), (ss.upd, ss2.upd),
                 (ss.a_sum, ss2.a_sum), (ss.p_sumsq, ss2.p_sumsq),
                 (ss.prop_counts, ss2.prop_counts)):
        assert torch.equal(a, b)
    assert (ss.n_stat == 10).all() and (ss.upd > 0).all()
    assert not torch.equal(st.M_a[0], st.M_a[1])


@pytest.mark.parametrize("changes", [
    {"output_frequency": 3}, {"n_snapshots": 2}, {"take_pump_samples": True},
    {"which_matrix_fixed": "A"}])
def test_span_wrapper_refuses_what_the_kernel_does_not_do(changes):
    eng, fixed = small_engine(changes, 20, 2)
    with pytest.raises(ValueError, match="samples both factors"):
        span_cuda.run_span(eng.config, eng.consts_a, eng.consts_p, eng.hist,
                           0, eng.data, 0, 1, eng.init_state(fixed),
                           eng.init_stats(), engine.PhiloxRandom([1, 2], "cpu"))


def test_span_wrappers_take_cpu_and_cuda_tensors_only():
    eng, _ = small_engine({}, 20, 2)
    state, stats = eng.init_state(), eng.init_stats()
    meta = state.M_a.to("meta")
    with pytest.raises(ValueError, match="no fused span"):
        span_cuda.run_span(eng.config, eng.consts_a, eng.consts_p, eng.hist,
                           0, eng.data, 0, 1,
                           engine.ChainState(state.atoms_a, state.atoms_p,
                                             meta, state.M_p), stats,
                           engine.PhiloxRandom([1, 2], "cpu"))
    with pytest.raises(ValueError, match="no table rebuild"):
        span_cuda.rebuild_tables(eng.data, meta, state.M_p)
