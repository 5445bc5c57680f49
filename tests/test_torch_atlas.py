"""The port's atlas engine (cogaps_tpu_torch/parallel/atlas_engine.py) on
the CPU, against the JAX package.

The CSR sweep kernel (csrc/atlas.cu) has no CPU mode; its plain version
(ops/atlas_cuda.run_updates_atlas_multi on CPU tensors: ops/sweep.py
with models/sparse.make_model) is what runs here. It is held to the JAX
package's XLA sparse sweep per update call on the engine's own
trajectory, as tests/test_atlas_engine.py:167-227 holds the Pallas atlas
kernel to it, on that file's 64 x 48, k = 3 toy: every call of a few
port iterations is replayed through cogaps_tpu/ops/sweep.run_updates
(op by op, on the same uniforms) with its make_model; one call is also
held to the Pallas atlas kernel itself in interpret mode. Tolerance: that
test's per-call contract — equal done, sweeps and counts (and here the
elem table) — and M and mass within atol 5e-3, rtol 1e-4 (the two
packages round the closed forms' sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu.models import sparse as jsparse
from cogaps_tpu.ops import pallas_atlas
from cogaps_tpu.ops.atoms import AtomTable as JAtoms
from cogaps_tpu.ops.sweep import MassParams as JMass
from cogaps_tpu.ops.sweep import make_consts as j_make_consts
from cogaps_tpu.ops.sweep import run_updates as j_run_updates
from cogaps_tpu.parallel import atlas_engine as jatlas
from cogaps_tpu.params import CogapsParams as JParams
from cogaps_tpu_torch import convert, engine
from cogaps_tpu_torch.io.coo import CooMatrix
from cogaps_tpu_torch.ops.atlas_cuda import run_updates_atlas_multi
from cogaps_tpu_torch.ops.atoms import AtomTable, total_mass_per_element
from cogaps_tpu_torch.parallel import atlas_engine
from cogaps_tpu_torch.params import CogapsParams
from test_torch_engine import jax_blocks

torch.set_num_threads(1)


def toy_coo(G=64, S=48, k=3, seed=3, density=0.5):
    """tests/test_atlas_engine.py::_toy_coo."""
    rng = np.random.default_rng(seed)
    A = rng.gamma(2.0, 1.0, (G, k)) * (rng.random((G, k)) < 0.6)
    P = rng.gamma(2.0, 1.0, (k, S)) * (rng.random((k, S)) < 0.6)
    D = A @ P + rng.normal(0, 0.3, (G, S))
    D = np.maximum(np.round(D), 0.0)
    D *= rng.random((G, S)) < density
    r, c = np.nonzero(D)
    return CooMatrix(rows=r.astype(np.int64), cols=c.astype(np.int64),
                     vals=D[r, c].astype(np.float32), shape=(G, S)), D


def make_engine(coo, n_iter=60, seed=11, k=3, **kw):
    cfg = CogapsParams(n_patterns=k, n_iterations=n_iter, seed=seed,
                       sparse_optimization=True,
                       output_frequency=5).engine_config(*coo.shape)
    return atlas_engine.AtlasEngine(coo, cfg, **dict(
        dict(batch=128, capacity=2048, chisq_every=1, device="cpu"), **kw))


def test_build_side_round_trip():
    coo, D = toy_coo()
    side = atlas_engine.build_side(coo.rows, coo.cols, coo.vals, 64)
    ptr = side.indptr[0].numpy()
    for r in range(64):
        cols = np.flatnonzero(D[r])
        np.testing.assert_array_equal(side.idx[ptr[r]:ptr[r + 1]].numpy(),
                                      cols)
        np.testing.assert_array_equal(side.val[ptr[r]:ptr[r + 1]].numpy(),
                                      D[r, cols].astype(np.float32))
    # as ELL it is the JAX package's coo_to_ell layout
    ell = jsparse.coo_to_ell(np.asarray(coo.rows, np.int32),
                             np.asarray(coo.cols, np.int32), coo.vals, 64)
    np.testing.assert_array_equal(side.ell().idx.numpy(), np.asarray(ell.idx))
    np.testing.assert_array_equal(side.ell().val.numpy(), np.asarray(ell.val))


class JaxStreamDraws:
    """Fixed budgets and JAX-stream uniforms per (iteration, sampler), in
    exact mode, so each call can be replayed through the JAX sweep."""

    def __init__(self, budgets, B):
        self.n = budgets
        self.B = B

    def budgets(self, phase, it, n_a, n_p):
        return (torch.tensor([self.n[0]], dtype=torch.int32),
                torch.tensor([self.n[1]], dtype=torch.int32))

    def key(self, it, sampler):
        return jax.random.PRNGKey(1000 + 2 * it + sampler)

    def sweeps(self, phase, it, sampler):
        key = self.key(it, sampler)
        return lambda c, first, n: jax_blocks(key, first, n, self.B)


def test_plain_atlas_calls_match_jax_xla_sweep(monkeypatch):
    coo, _ = toy_coo()
    eng = make_engine(coo)
    calls = []
    orig = atlas_engine.run_updates_atlas_multi

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, out))
        return out

    monkeypatch.setattr(atlas_engine, "run_updates_atlas_multi", spy)
    ells = [jsparse.coo_to_ell(np.asarray(r, np.int32),
                               np.asarray(c, np.int32), coo.vals, n)
            for r, c, n in ((coo.rows, coo.cols, 64),
                            (coo.cols, coo.rows, 48))]
    state, stats = eng.init_state(), eng.init_stats()
    draws = JaxStreamDraws((60, 45), 128)
    for it in range(4):
        calls.clear()
        state, stats = eng.iteration(state, stats, draws,
                                     engine.EQUILIBRATION, it, False)
        for sampler, ((atoms, M, _, other, temp, n_steps, consts, mass,
                       _), out) in enumerate(calls):
            with jax.disable_jit():
                a1, M1, _, done1, ns1, cnt1 = j_run_updates(
                    draws.key(it, sampler),
                    JAtoms(mass=jnp.asarray(atoms.mass[0].numpy()),
                           elem=jnp.asarray(atoms.elem[0].numpy()),
                           n=jnp.asarray(int(atoms.n[0]), jnp.int32)),
                    jnp.asarray(M[0].numpy()), (), jnp.float32(temp),
                    jnp.asarray(int(n_steps[0]), jnp.int32),
                    j_make_consts(consts.n_rows, consts.m, consts.k,
                                  consts.capacity, consts.batch,
                                  consts.alpha,
                                  local_moves=consts.local_moves),
                    JMass(jnp.float32(float(mass.lam[0])),
                          jnp.float32(float(mass.max_gibbs_mass[0]))),
                    model=jsparse.make_model(
                        ells[sampler], jsparse.make_sparse_phase(
                            jnp.asarray(other[0].numpy()))))
            a2, M2, done2, ns2, cnt2 = out
            what = f"iteration {it} sampler {'AP'[sampler]}"
            assert int(done2[0]) == int(done1), what
            assert int(ns2[0]) == int(ns1), what
            np.testing.assert_array_equal(cnt2.processed[0].numpy(),
                                          np.asarray(cnt1.processed), what)
            np.testing.assert_array_equal(cnt2.accepted[0].numpy(),
                                          np.asarray(cnt1.accepted), what)
            np.testing.assert_array_equal(a2.elem[0].numpy(),
                                          np.asarray(a1.elem), what)
            np.testing.assert_allclose(a2.mass[0].numpy(),
                                       np.asarray(a1.mass), atol=5e-3,
                                       rtol=1e-4, err_msg=what)
            np.testing.assert_allclose(M2[0].numpy(), np.asarray(M1),
                                       atol=5e-3, rtol=1e-4, err_msg=what)
    assert int(state.atoms_a.n[0]) > 10 and int(state.atoms_p.n[0]) > 10


def test_plain_atlas_call_matches_pallas_interpret():
    """One A update call of the port's plain version against
    cogaps_tpu/ops/pallas_atlas.run_updates_atlas(interpret=True) on the
    same random state, planes built from the same partner factor, and
    the same uniforms."""
    coo, _ = toy_coo()
    k, C = 3, 2048
    eng = make_engine(coo)
    jcfg = JParams(n_patterns=k, n_iterations=60, seed=11,
                   sparse_optimization=True).engine_config(*coo.shape)
    jeng = jatlas.AtlasEngine(coo, jcfg, batch=128, group=16, seg=8,
                              capacity=C, s_max=24)
    rng = np.random.default_rng(6)
    n0 = 60
    elem = np.where(np.arange(C) < n0, rng.integers(0, 64 * k, C), -1
                    ).astype(np.int32)
    mass = np.where(np.arange(C) < n0, rng.gamma(2.0, 0.5, C), 0.0
                    ).astype(np.float32)
    M = np.zeros(64 * k, np.float32)
    np.add.at(M, elem[:n0], mass[:n0])
    M = M.reshape(64, k)
    partner = rng.gamma(2.0, 1.0, (48, k)).astype(np.float32)
    jpartner = jnp.asarray(partner)
    plane = jatlas.rebuild_plane(
        jnp.zeros((jeng.ap_a.prows, 128), jnp.float32),
        jeng._arrs["idx_a"], jeng._arrs["dr_a"], jpartner, k)
    key = jax.random.PRNGKey(5)
    a1, mmir, done1, ns1, cnt1 = pallas_atlas.run_updates_atlas(
        key, JAtoms(mass=jnp.asarray(mass), elem=jnp.asarray(elem),
                    n=jnp.asarray(n0, jnp.int32)),
        jatlas.make_mirror(jeng.side_a, jnp.asarray(M), k), plane,
        jnp.zeros((128, 128), jnp.float32).at[:k, :k].set(
            jpartner.T @ jpartner),
        jnp.zeros((1, 128), jnp.float32).at[0, :k].set(
            (partner.max(axis=0) > 0).astype(np.float32)),
        jnp.float32(1.0), jnp.asarray(60, jnp.int32), jeng.consts_a,
        jeng.mass_a, jeng.ap_a, s_max=24, interpret=True)
    a2, M2, done2, ns2, cnt2 = run_updates_atlas_multi(
        AtomTable(mass=torch.from_numpy(mass)[None],
                  elem=torch.from_numpy(elem)[None],
                  n=torch.tensor([n0], dtype=torch.int32)),
        torch.from_numpy(M)[None], eng.side_a,
        torch.from_numpy(partner)[None], 1.0,
        torch.tensor([60], dtype=torch.int32), eng.consts_a, eng.mass_a,
        lambda c, first, n: jax_blocks(key, first, n, 128))
    assert int(done2[0]) == int(done1) == 60 and int(ns2[0]) == int(ns1)
    np.testing.assert_array_equal(cnt2.processed[0].numpy(),
                                  np.asarray(cnt1.processed))
    np.testing.assert_array_equal(cnt2.accepted[0].numpy(),
                                  np.asarray(cnt1.accepted))
    np.testing.assert_array_equal(a2.elem[0].numpy(), np.asarray(a1.elem))
    np.testing.assert_allclose(a2.mass[0].numpy(), np.asarray(a1.mass),
                               atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose(M2[0].numpy(), np.asarray(mmir)[:, :k],
                               atol=5e-3, rtol=1e-4)
    assert int(cnt2.accepted[0].sum()) > 10


def test_atlas_engine_keeps_m_equal_to_atom_masses():
    """tests/test_atlas_engine.py::test_atlas_engine_runs_and_mass_
    invariant on the port: M is the atom masses summed per element."""
    coo, _ = toy_coo(G=96, S=64, k=4, seed=0, density=0.3)
    eng = make_engine(coo, n_iter=30, k=4)
    state, stats = eng.init_state(), eng.init_stats()
    state, stats = eng.run_phase(state, stats,
                                 atlas_engine.AtlasRandom(7, "cpu"),
                                 engine.EQUILIBRATION)
    for atoms, M, nr in ((state.atoms_a, state.M_a, 96),
                         (state.atoms_p, state.M_p, 64)):
        per_elem = total_mass_per_element(atoms.chain(0), nr * 4)
        np.testing.assert_allclose(M[0].numpy(),
                                   per_elem.reshape(nr, 4).numpy(),
                                   rtol=2e-4, atol=2e-4)
    assert int(state.atoms_a.n[0]) > 0 and int(state.atoms_p.n[0]) > 0
    # the history holds the closed-form chi^2 of every output tick
    h = stats.chisq_hist[0].numpy()[:6]
    assert np.isfinite(h).all() and (h > 0).all() and h[-1] < h[0]


def test_run_atlas_result():
    """run_atlas gives a CogapsResult whose meanChiSq (from the CSR rows)
    equals the dense formula with the implied uncertainty."""
    coo, D = toy_coo()
    res = atlas_engine.run_atlas(coo, n_patterns=3, n_iterations=40, seed=2,
                                 messages=False, device="cpu", batch=128,
                                 capacity=2048)
    assert res.Amean.shape == (64, 3) and res.Pmean.shape == (48, 3)
    assert res.diagnostics["engine"] == "AtlasEngine"
    assert res.diagnostics["totalUpdates"] > 0
    S = np.where(D > 0, 0.1 * D, 0.1)
    want = float(np.sum(((D - res.Amean.astype(np.float64)
                          @ res.Pmean.astype(np.float64).T) / S) ** 2))
    assert res.mean_chi_sq == pytest.approx(want, rel=1e-9)
    assert res.mean_chi_sq < 100.0 * len(coo.vals)  # below zero factors


def test_atlas_state_converts_from_jax():
    coo, _ = toy_coo()
    cfg = JParams(n_patterns=3, n_iterations=10, seed=1,
                  sparse_optimization=True).engine_config(*coo.shape)
    jeng = jatlas.AtlasEngine(coo, cfg, batch=128, group=16, seg=8,
                              capacity=2048, s_max=24)
    jstate = jeng.init_state()
    rng = np.random.default_rng(4)
    M_a = rng.gamma(2.0, 1.0, (64, 3)).astype(np.float32)
    jstate = jstate._replace(mmir_a=jstate.mmir_a.at[:, :3].set(M_a))
    state = convert.atlas_state_from_numpy(jax.device_get(jstate), 3)
    np.testing.assert_array_equal(state.M_a[0].numpy(), M_a)
    assert state.M_p.shape == (1, 48, 3)
    assert state.atoms_a.mass.shape == (1, 2048)
    assert int(state.atoms_p.n[0]) == 0
