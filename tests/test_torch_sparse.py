"""The port's sparse model (cogaps_tpu_torch/models/sparse.py), its table
mode on the sweep kernel's plain version (K2), its plain sparse sweep and
its engine (sparse_engine.py) against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX side
runs as its own tests run it on the CPU (the XLA sweep op by op under
jax.disable_jit, as tests/test_torch_sweep.py explains, and the Pallas
tables kernel in interpret mode). Tolerances:
  * layouts (ELL, CSR) equal;
  * alphaParameters, noise floors and tables to float32 rounding: the two
    packages sum the same terms in another order (matmul/einsum), so
    each value within 1e-5 of the largest magnitude it is summed from;
  * chi^2 to 1e-5 relative;
  * sweeps and iterations decision-exact (equal done, sweeps, counts,
    elem); mass and M within 1e-5 where both packages read the same
    tables (K2 against the Pallas kernel), within rtol 1e-4 where each
    forms the sparse closed forms itself: their float32 rounding (the
    line above) carries into the Gibbs draws, measured at 4e-5 relative
    on one mass of test_plain_sparse_sweep_matches_jax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu import sparse_engine as jsparse_engine
from cogaps_tpu.models import sparse as jsparse
from cogaps_tpu.ops.atoms import AtomTable as JAtoms
from cogaps_tpu.ops.atoms import total_mass_per_element as j_total_mass
from cogaps_tpu.ops.pallas_sweep import run_updates_pallas_tables
from cogaps_tpu.ops.sweep import AddrBatch as JAddr
from cogaps_tpu.ops.sweep import MassParams as JMass
from cogaps_tpu.ops.sweep import make_consts as j_make_consts
from cogaps_tpu.ops.sweep import run_updates as j_run_updates
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu_torch import convert, engine, sparse_engine
from cogaps_tpu_torch.api import CoGAPS
from cogaps_tpu_torch.io.coo import CooMatrix
from cogaps_tpu_torch.models import dense, sparse
from cogaps_tpu_torch.ops import sweep, sweep_cuda
from cogaps_tpu_torch.ops.atoms import AtomTable
from cogaps_tpu_torch.params import CogapsParams
from test_torch_engine import JaxDraws, jax_blocks

torch.set_num_threads(1)


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


@pytest.fixture(scope="module")
def sparse_data():
    """tests/test_sparse.py's data: structural zeros of a rank-3
    nonnegative factorization, 30 x 20; and its true factors."""
    rng = np.random.default_rng(5)
    A = (rng.gamma(2.0, 1.0, (30, 3)) * (rng.random((30, 3)) < 0.45)
         ).astype(np.float32)
    P = (rng.gamma(2.0, 1.0, (20, 3)) * (rng.random((20, 3)) < 0.45)
         ).astype(np.float32)
    return (A @ P.T).astype(np.float32), A, P


def csr_of(D):
    r, c = np.nonzero(D)
    return sparse.coo_to_csr(r, c, D[r, c], D.shape[0])


def close_to_scale(a, b, what, rel=1e-5):
    """|a - b| <= rel * (largest |b| of the batch): float32 rounding of
    sums taken in another order, cancellation included."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rel,
                               atol=rel * max(float(np.abs(b).max()), 1.0),
                               err_msg=what)


def test_ell_layouts_equal_jax(sparse_data):
    D = sparse_data[0]
    ours, theirs = sparse.to_ell(D), jsparse.to_ell(D)
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(theirs.idx))
    np.testing.assert_array_equal(ours.val.numpy(), np.asarray(theirs.val))
    r, c = np.nonzero(D.T)
    ours = sparse.coo_to_ell(r.astype(np.int32), c.astype(np.int32),
                             D.T[r, c], D.shape[1])
    theirs = jsparse.coo_to_ell(r.astype(np.int32), c.astype(np.int32),
                                D.T[r, c], D.shape[1])
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(theirs.idx))
    np.testing.assert_array_equal(ours.val.numpy(), np.asarray(theirs.val))
    # the CSR rows, as ELL, are coo_to_ell's layout
    ell = csr_of(D).ell()
    np.testing.assert_array_equal(ell.idx.numpy(),
                                  np.asarray(jsparse.to_ell(D).idx))
    np.testing.assert_array_equal(ell.val.numpy(),
                                  np.asarray(jsparse.to_ell(D).val))


def random_addresses(rng, G, k, B=64):
    r1 = rng.integers(0, G, B)
    r2 = rng.integers(0, G, B)
    r2[:24] = r1[:24]  # same-row pairs
    return r1, rng.integers(0, k, B), r2, rng.integers(0, k, B)


@pytest.mark.parametrize("seed", [7, 8])
def test_make_model_alpha_equals_jax(sparse_data, seed):
    D = sparse_data[0]
    rng = np.random.default_rng(seed)
    k = 3
    M = rng.gamma(1.0, 1.0, (D.shape[0], k)).astype(np.float32)
    other = rng.gamma(1.0, 1.0, (D.shape[1], k)).astype(np.float32)
    r1, c1, r2, c2 = random_addresses(rng, D.shape[0], k)
    jab = jsparse.make_model(jsparse.to_ell(D), jsparse.make_sparse_phase(
        jnp.asarray(other))).alpha((), jnp.asarray(M), JAddr(
            *(jnp.asarray(x, jnp.int32) for x in (r1, c1, r2, c2))))
    ab = sparse.make_model(csr_of(D).ell(), sparse.make_sparse_phase(
        t(other))).alpha((), t(M), sweep.AddrBatch(
            *(t(x, torch.int64) for x in (r1, c1, r2, c2))))
    for name in ("s1", "smu1", "s_pair", "smu_pair", "err1", "err_pair"):
        close_to_scale(getattr(ab, name), getattr(jab, name), name)
    assert float(ab.err1.min()) > 0.0  # the sparse model's floors are real


def test_kernel_tables_equal_jax(sparse_data):
    D = sparse_data[0]
    rng = np.random.default_rng(9)
    k = 3
    M = rng.gamma(1.0, 1.0, (D.shape[0], k)).astype(np.float32)
    other = rng.gamma(2.0, 1.0, (D.shape[1], k)).astype(np.float32)
    jell = jsparse.to_ell(D)
    jWd, jD1 = jsparse.dense_weights(jell, D.shape[1])
    Wd, D1 = sparse.dense_weights(csr_of(D), D.shape[1])
    np.testing.assert_array_equal(Wd[0].numpy(), np.asarray(jWd))
    np.testing.assert_array_equal(D1[0].numpy(), np.asarray(jD1))
    want = jsparse.kernel_tables(jWd, jD1, jnp.asarray(other),
                                 jnp.asarray(M))
    got_dense = sparse.kernel_tables(Wd[0], D1[0], t(other), t(M))
    got_ell = sparse.kernel_tables_ell(csr_of(D).ell(), t(other), t(M),
                                       row_chunk=7)
    want_ell = jsparse.kernel_tables_ell(jell, jnp.asarray(other),
                                         jnp.asarray(M), row_chunk=8)
    for name, a, b in zip(("SQ", "Y0", "G"), got_dense, want):
        close_to_scale(a, b, f"dense {name}")
    for name, a, b in zip(("SQ", "Y0", "G"), got_ell, want_ell):
        close_to_scale(a, b, f"ell {name}")


def test_sparse_chisq_equals_jax(sparse_data, monkeypatch):
    D = sparse_data[0]
    rng = np.random.default_rng(11)
    M_a = rng.gamma(1.0, 1.0, (D.shape[0], 3)).astype(np.float32)
    M_p = rng.gamma(1.0, 1.0, (D.shape[1], 3)).astype(np.float32)
    want = float(jsparse.sparse_chisq(jsparse.to_ell(D), jnp.asarray(M_a),
                                      jnp.asarray(M_p)))
    got = float(sparse.sparse_chisq(csr_of(D), t(M_a), t(M_p)))
    assert got == pytest.approx(want, rel=1e-5)
    monkeypatch.setattr(sparse, "_CHISQ_CHUNK", 17)  # chunked the same
    assert float(sparse.sparse_chisq(csr_of(D), t(M_a), t(M_p))) == \
        pytest.approx(want, rel=1e-5)


def fitted_state(sparse_data, C=512):
    """Atoms at the true factor A (one atom per nonzero of A) against the
    true P: the residual is zero, so s_mu is rounding noise and the noise
    floors refuse Gibbs draws on many rows."""
    D, A, P = sparse_data
    k = A.shape[1]
    flat = A.reshape(-1)
    nz = np.flatnonzero(flat)
    elem = np.full(C, -1, np.int32)
    mass = np.zeros(C, np.float32)
    elem[:len(nz)] = nz
    mass[:len(nz)] = flat[nz]
    return elem, mass, len(nz), k


@pytest.mark.parametrize("seed,n_steps,temp", [(3, 90, 1.0), (4, 120, 0.6)])
def test_plain_sparse_sweep_matches_jax(sparse_data, seed, n_steps, temp):
    D, A, P = sparse_data
    elem, mass, n0, k = fitted_state(sparse_data)
    C, B = elem.shape[0], 32
    jconsts = j_make_consts(D.shape[0], D.shape[1], k, C, B, 0.01)
    consts = sweep.make_consts(D.shape[0], D.shape[1], k, C, B, 0.01)
    lam = 0.01 * float(np.sqrt(k / D[D != 0].mean()))
    jatoms = JAtoms(mass=jnp.asarray(mass), elem=jnp.asarray(elem),
                    n=jnp.asarray(n0, jnp.int32))
    M = np.asarray(j_total_mass(jatoms, D.shape[0] * k)).reshape(
        D.shape[0], k)
    jmodel = jsparse.make_model(jsparse.to_ell(D), jsparse.make_sparse_phase(
        jnp.asarray(P)))
    model = sparse.make_model(csr_of(D).ell(),
                              sparse.make_sparse_phase(t(P)))
    # the floors bite at this state
    r1, c1, r2, c2 = random_addresses(np.random.default_rng(0), D.shape[0],
                                      k)
    ab = model.alpha((), t(M), sweep.AddrBatch(
        *(t(x, torch.int64) for x in (r1, c1, r2, c2))))
    assert int((ab.smu1.abs() <= ab.err1).sum()) > 5
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        a1, M1, _, done1, ns1, cnt1 = j_run_updates(
            key, jatoms, jnp.asarray(M), (), jnp.float32(temp),
            jnp.asarray(n_steps, jnp.int32), jconsts,
            JMass(jnp.float32(lam), jnp.float32(100.0 / lam)), model=jmodel)
    a2, M2, _, done2, ns2, cnt2 = sweep.run_updates(
        lambda i: jax_blocks(key, i, 1, B),
        AtomTable(mass=t(mass), elem=t(elem), n=torch.tensor(n0,
                                                             dtype=torch.int32)),
        t(M), (), temp, n_steps, consts,
        sweep.MassParams(t(np.float32(lam)), t(np.float32(100.0 / lam))),
        model=model)
    assert done2 == int(done1) == n_steps and ns2 == int(ns1)
    np.testing.assert_array_equal(cnt2.processed.numpy(),
                                  np.asarray(cnt1.processed))
    np.testing.assert_array_equal(cnt2.accepted.numpy(),
                                  np.asarray(cnt1.accepted))
    np.testing.assert_array_equal(a2.elem.numpy(), np.asarray(a1.elem))
    np.testing.assert_allclose(a2.mass.numpy(), np.asarray(a1.mass),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(M2.numpy(), np.asarray(M1), rtol=1e-4,
                               atol=1e-5)


def test_tables_plain_matches_pallas_interpret(sparse_data):
    """K2's plain version (the sweep wrapper on CPU tensors, fed the
    sparse tables) against the Pallas tables kernel in interpret mode,
    one update call on the same tables and uniforms. B = 128, the width
    the JAX engine gives the kernel (engine._pallas_batch): at B = 64 the
    Pallas kernel departs from JAX's own XLA sweep on these tables
    (ROADMAP.md, Queue 3)."""
    D = sparse_data[0]
    rng = np.random.default_rng(2)
    G_, S_, k, C, B = D.shape[0], D.shape[1], 3, 512, 128
    jell = jsparse.to_ell(D)
    Wd, D1 = jsparse.dense_weights(jell, S_)
    other = jnp.asarray(rng.gamma(2.0, 1.0, (S_, k)), jnp.float32)
    n0 = 40
    elem = np.where(np.arange(C) < n0, rng.integers(0, G_ * k, C), -1
                    ).astype(np.int32)
    mass = np.where(np.arange(C) < n0, rng.gamma(2.0, 1.0, C), 0.0
                    ).astype(np.float32)
    jatoms = JAtoms(mass=jnp.asarray(mass), elem=jnp.asarray(elem),
                    n=jnp.asarray(n0, jnp.int32))
    M = j_total_mass(jatoms, G_ * k).reshape(G_, k)
    SQ, Y0, Gf = jsparse.kernel_tables(Wd, D1, other, M)
    key = jax.random.PRNGKey(3)
    a1, M1, done1, ns1, cnt1 = run_updates_pallas_tables(
        key, jatoms, M, jnp.float32(1.0), jnp.asarray(150, jnp.int32),
        j_make_consts(G_, S_, k, C, B, 0.01),
        JMass(jnp.float32(0.05), jnp.float32(100.0 / 0.05)),
        SQ=SQ, Y0=Y0, Z_flat=Gf, other_M=other, s_max=16, interpret=True)
    phase = dense.DensePhase(SQ=t(SQ)[None], Z=t(Gf)[None],
                             col_nz=t(np.asarray(other).max(axis=0) > 0)[None])
    a2, M2, _, done2, ns2, cnt2 = sweep_cuda.run_updates_multi(
        AtomTable(mass=t(mass)[None], elem=t(elem)[None],
                  n=torch.tensor([n0], dtype=torch.int32)),
        t(M)[None], t(Y0)[None], phase, 1.0,
        torch.tensor([150], dtype=torch.int32),
        sweep.make_consts(G_, S_, k, C, B, 0.01),
        sweep.MassParams(torch.tensor([0.05]),
                         torch.tensor([np.float32(100.0 / 0.05)])),
        lambda c, first, n: jax_blocks(key, first, n, B))
    assert int(done2[0]) == int(done1) == 150 and int(ns2[0]) == int(ns1)
    np.testing.assert_array_equal(cnt2.processed[0].numpy(),
                                  np.asarray(cnt1.processed))
    np.testing.assert_array_equal(cnt2.accepted[0].numpy(),
                                  np.asarray(cnt1.accepted))
    np.testing.assert_array_equal(a2.elem[0].numpy(), np.asarray(a1.elem))
    np.testing.assert_allclose(a2.mass[0].numpy(), np.asarray(a1.mass),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(M2[0].numpy(), np.asarray(M1), rtol=1e-5,
                               atol=1e-5)


PARAMS = dict(n_patterns=3, n_iterations=40, seed=5, output_frequency=2)
WARMUP = 12


def test_run_iteration_sparse_lockstep_with_jax(sparse_data):
    """JAX's sparse engine warms up; its data and state are carried into
    the port (convert.py), and both run the same iterations in lockstep
    with JAX's draws, the port in "xla" mode (the plain sparse sweep, the
    path JAX's CPU engine takes)."""
    D = sparse_data[0]
    jcfg = JParams(**PARAMS).engine_config(*D.shape)
    jeng = jsparse_engine.SparseGapsEngine(D, jcfg)
    key = jax.random.PRNGKey(PARAMS["seed"])
    jstate, jstats = jeng.run_span(jeng.init_state(), jeng.init_stats(),
                                   key, jsparse_engine.EQUILIBRATION, 0,
                                   WARMUP)
    cfg = dataclasses.replace(CogapsParams(**PARAMS).engine_config(*D.shape),
                              sparse_table_mode="xla")
    hist = engine.derive_hist(cfg)
    consts_a, consts_p = engine.build_consts(cfg, *D.shape)
    data = convert.sparse_data_from_numpy(jax.device_get(jeng.data),
                                          device="cpu")
    pstate = convert.sparse_chain_state_from_numpy(jax.device_get(jstate),
                                                   device="cpu")
    pstats = convert.run_stats_from_numpy(jax.device_get(jstats), device="cpu")
    assert int(jstate.atoms_a.n) > 5 and int(jstate.atoms_p.n) > 5
    for phase, it in [(engine.EQUILIBRATION, WARMUP),
                      (engine.EQUILIBRATION, WARMUP + 1),
                      (engine.SAMPLING, 0)]:
        draws = JaxDraws(key, phase, it, jstate, cfg)
        with jax.disable_jit():
            jstate, jstats = jsparse_engine.run_iteration_sparse(
                jeng.config, jeng.consts_a, jeng.consts_p, jeng.hist, phase,
                jeng.data, jnp.asarray(it, jnp.int32), jstate, jstats, key)
        pstate, pstats = sparse_engine.run_iteration_sparse(
            cfg, consts_a, consts_p, hist, phase, data, it,
            pstate, pstats, draws)
        js, jt = jax.device_get(jstate), jax.device_get(jstats)
        ps, pt = convert.to_numpy(pstate), convert.to_numpy(pstats)
        for side in ("atoms_a", "atoms_p"):
            np.testing.assert_array_equal(ps[side]["elem"][0],
                                          getattr(js, side).elem)
            np.testing.assert_allclose(ps[side]["mass"][0],
                                       getattr(js, side).mass, rtol=1e-4,
                                       atol=1e-5)
        for name in ("M_a", "M_p"):
            np.testing.assert_allclose(ps[name][0], getattr(js, name),
                                       rtol=1e-4, atol=1e-5)
        assert int(pt["upd"][0]) == int(jt.upd_hi) * (1 << 30) + int(
            jt.upd_lo)
        for name in ("prop_counts", "acc_counts", "sweep_counts",
                     "atom_hist_a", "atom_hist_p"):
            np.testing.assert_array_equal(pt[name][0], getattr(jt, name),
                                          name)
        np.testing.assert_allclose(pt["chisq_hist"][0], jt.chisq_hist,
                                   rtol=1e-4, err_msg="chisq_hist")
    assert int(pstats.n_stat[0]) == 1


def test_sparse_data_converts_from_jax(sparse_data):
    D = sparse_data[0]
    jcfg = JParams(**PARAMS).engine_config(*D.shape)
    jeng = jsparse_engine.SparseGapsEngine(D, jcfg)
    jdata = jax.device_get(jeng.data)
    data = convert.sparse_data_from_numpy(jdata, device="cpu")
    for ours, theirs in ((data.csr_a, jdata.ell_a), (data.csr_p, jdata.ell_p)):
        np.testing.assert_array_equal(ours.ell().idx.numpy(), theirs.idx)
        np.testing.assert_array_equal(ours.ell().val.numpy(), theirs.val)
    np.testing.assert_array_equal(data.Wd_a[0].numpy(), jdata.Wd_a)
    assert float(data.mass_a.lam[0]) == float(jdata.mass_a.lam)
    # the port's own engine builds the same data
    ours = sparse_engine.SparseGapsEngine(
        D, dataclasses.replace(CogapsParams(**PARAMS).engine_config(*D.shape),
                               sparse_table_mode="dense"), "cpu")
    assert torch.equal(ours.data.csr_a.idx, data.csr_a.idx)
    assert torch.equal(ours.data.Wd_a, data.Wd_a)
    for a, b in ((ours.data.mass_a, data.mass_a),
                 (ours.data.mass_p, data.mass_p)):
        assert torch.equal(a.lam, b.lam)
        assert torch.equal(a.max_gibbs_mass, b.max_gibbs_mass)


def test_sparse_cogaps_converges(sparse_data):
    """tests/test_sparse.py::test_sparse_run_converges, in the default
    mode (the tables path on the CPU)."""
    D = sparse_data[0]
    res = CoGAPS(D, n_patterns=3, n_iterations=300, seed=1, messages=False,
                 sparse_optimization=True, output_frequency=100,
                 device="cpu")
    h = res.diagnostics["chisqHistory"]
    assert h[-1] < 0.2 * h[0]
    assert res.Amean.shape == (30, 3) and (res.Amean >= 0).all()
    S = np.maximum(0.1 * D, 0.1)
    want = float(np.sum(((D - res.Amean.astype(np.float64)
                          @ res.Pmean.astype(np.float64).T) / S) ** 2))
    assert res.mean_chi_sq == pytest.approx(want, rel=1e-12)


def test_sparse_cogaps_inputs(sparse_data):
    D = sparse_data[0]
    with pytest.raises(ValueError, match="default uncertainty"):
        CoGAPS(D, n_patterns=3, n_iterations=10, messages=False,
               sparse_optimization=True, uncertainty=np.full_like(D, 0.5),
               device="cpu")
    r, c = np.nonzero(D)
    coo = CooMatrix(r.astype(np.int32), c.astype(np.int32), D[r, c],
                    D.shape)
    with pytest.raises(ValueError, match="COO"):
        CoGAPS(coo, n_patterns=3, n_iterations=10, messages=False,
               uncertainty=np.ones_like(D), device="cpu")
    # COO input runs the sparse engine, transposed on request, and its
    # meanChiSq is the closed form over the nonzeros (the dense formula
    # with S = 0.1 d at nonzeros and 0.1 at zeros)
    res = CoGAPS(coo, n_patterns=3, n_iterations=20, seed=2, messages=False,
                 transpose_data=True, device="cpu")
    assert res.Amean.shape == (20, 3) and res.Pmean.shape == (30, 3)
    Dt = D.T
    S = np.where(Dt > 0, 0.1 * Dt, 0.1)
    want = float(np.sum(((Dt - res.Amean.astype(np.float64)
                          @ res.Pmean.astype(np.float64).T) / S) ** 2))
    assert res.mean_chi_sq == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("mode", sparse_engine.SPARSE_MODES)
def test_every_mode_runs_on_the_cpu(sparse_data, mode):
    """Each mode's plain path: a short run whose chi^2 falls."""
    D = sparse_data[0]
    cfg = dataclasses.replace(
        CogapsParams(n_patterns=3, n_iterations=60, seed=4,
                     output_frequency=20).engine_config(*D.shape),
        sparse_table_mode=mode)
    eng = sparse_engine.SparseGapsEngine(D, cfg, "cpu")
    assert (eng.data.Wd_a is not None) == (mode == "dense")
    st, ss = eng.init_state(), eng.init_stats()
    rand = engine.PhiloxRandom([4], "cpu")
    for ph in (engine.EQUILIBRATION, engine.SAMPLING):
        st, ss = eng.run_phase(st, ss, rand, ph)
    h = ss.chisq_hist[0].numpy()
    assert np.isfinite(h).all() and h[-1] < 0.5 * h[0]
    assert float(eng.chisq(st)[0]) == pytest.approx(
        float(sparse.sparse_chisq(eng.data.csr_a, st.M_a[0], st.M_p[0])))


def test_mode_rule_follows_memory(monkeypatch):
    need = sparse_engine.mode_bytes(4, 2000, 10000, 10)
    assert need["xla"] < need["ell"] < need["dense"]
    for budget, want in ((need["dense"], "dense"), (need["ell"], "ell"),
                         (need["ell"] - 1, "xla")):
        monkeypatch.setattr(sparse_engine, "device_memory_bytes",
                            lambda device, b=budget: b
                            / sparse_engine.MEMORY_SHARE)
        assert sparse_engine.resolve_sparse_mode(4, 2000, 10000, 10,
                                                 "cpu") == want


def test_dense_path_keeps_zero_floors():
    """The dense model's alphaParameters carry floors 0, so the floors
    added to the plain sweep change nothing on the dense path."""
    ab = dense.AlphaBatch(*(torch.ones(2) for _ in range(4)))
    assert ab.err1 == 0.0 and ab.err_pair == 0.0
    rs = np.random.default_rng(0)
    SQ = t(rs.random((5, 2)).astype(np.float32))
    phase = dense.DensePhase(SQ=SQ, Z=t(rs.random((10, 2)).astype(
        np.float32)), col_nz=torch.ones(2, dtype=torch.bool))
    addr = sweep.AddrBatch(r1=torch.tensor([0, 3]), c1=torch.tensor([1, 0]),
                           r2=torch.tensor([0, 4]), c2=torch.tensor([0, 1]))
    got = dense.make_model(phase).alpha(
        dense.DenseCache(Y=SQ), None, addr)
    assert got.err1 == 0.0 and got.err_pair == 0.0
