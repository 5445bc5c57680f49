"""The port's dense model (cogaps_tpu_torch/models/dense.py) against
cogaps_tpu/models/dense.py at modsim (25x20, k=3) and GIST (1363x9, k=7)
shapes, on both samplers' orientations, with inputs made from a numpy
seed.

Tolerances are float32 rounding of the matrix products, which the two
libraries sum in different orders: 1e-5 of the float64 magnitude of the
summed terms (for Y, of |D|*invS2 + |M O^T|*invS2 against |O|, since Y
cancels). The gathers and the row updates are the same float operations
on both sides and agree to 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu.models import dense as jdense
from cogaps_tpu.ops.sweep import AddrBatch as JAddr
from cogaps_tpu.ops.sweep import ApplyBatch as JApply
from cogaps_tpu_torch.models import dense
from cogaps_tpu_torch.ops.sweep import AddrBatch, ApplyBatch

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def dataset(name):
    if name == "modsim":
        return np.asarray(np.load(os.path.join(DATA, "modsim.npz"))["D"]), 3
    return np.asarray(np.load(os.path.join(DATA, "gist.npz"))["D"]), 7


@pytest.fixture(params=[("modsim", "A"), ("modsim", "P"), ("gist", "A"),
                        ("gist", "P")], ids=lambda p: "-".join(p))
def tables(request):
    name, side = request.param
    D, k = dataset(name)
    if side == "P":
        D = D.T
    D = np.ascontiguousarray(D, np.float32)
    rs = np.random.default_rng(17)
    inv = (1.0 / np.maximum(0.1 * D, 0.1) ** 2).astype(np.float32)
    M = rs.gamma(1.0, 1.0, (D.shape[0], k)).astype(np.float32)
    M[rs.random(M.shape) < 0.3] = 0.0
    O = rs.gamma(2.0, 1.0, (D.shape[1], k)).astype(np.float32)
    O[:, -1] = 0.0  # one empty column: canUseGibbs false
    return D, inv, M, O, k


def t(x):
    return torch.from_numpy(np.array(x))


def test_make_phase_matches_jax(tables):
    D, inv, M, O, k = tables
    jp = jdense.make_phase(jnp.asarray(inv), jnp.asarray(O))
    tp = dense.make_phase(t(inv), t(O))
    inv64, O64 = inv.astype(np.float64), O.astype(np.float64)
    sq_scale = inv64 @ (O64 * O64)
    np.testing.assert_array_less(np.abs(tp.SQ.numpy() - np.asarray(jp.SQ)),
                                 1e-5 * sq_scale + 1e-30)
    oo = (O64[:, :, None] * O64[:, None, :]).reshape(O.shape[0], k * k)
    z_scale = (inv64 @ oo).reshape(-1, k)
    np.testing.assert_array_less(np.abs(tp.Z.numpy() - np.asarray(jp.Z)),
                                 1e-5 * z_scale + 1e-30)
    np.testing.assert_array_equal(tp.col_nz.numpy(), np.asarray(jp.col_nz))
    assert not tp.col_nz[-1]


def test_rebuild_cache_and_chisq_match_jax(tables):
    D, inv, M, O, k = tables
    jY = np.asarray(jdense.rebuild_cache(jnp.asarray(D), jnp.asarray(inv),
                                         jnp.asarray(M), jnp.asarray(O)).Y)
    tY = dense.rebuild_cache(t(D), t(inv), t(M), t(O)).Y.numpy()
    D64, inv64 = D.astype(np.float64), inv.astype(np.float64)
    M64, O64 = M.astype(np.float64), O.astype(np.float64)
    scale = (np.abs(D64) * inv64 + np.abs(M64 @ O64.T) * inv64) @ np.abs(O64)
    np.testing.assert_array_less(np.abs(tY - jY), 1e-5 * scale + 1e-30)

    jc = float(jdense.chisq_from_state(jnp.asarray(D), jnp.asarray(inv),
                                       jnp.asarray(M), jnp.asarray(O)))
    tc = float(dense.chisq_from_state(t(D), t(inv), t(M), t(O)))
    exact = float(np.sum((D64 - M64 @ O64.T) ** 2 * inv64))
    assert abs(tc - exact) <= 1e-4 * exact
    assert abs(jc - exact) <= 1e-4 * exact


@pytest.mark.parametrize("lead", ["chains", "shared-data", "shared-P",
                                  "one-chain"])
def test_chisq_of_chains_is_each_chain_alone(tables, lead):
    """With a leading chain dimension on any of its arguments, each
    chain's chi^2 is the bits of that chain's chi^2 computed alone, and
    within 1e-4 of the JAX package's chi^2 of that chain."""
    D, inv, M, O, _ = tables
    rs = np.random.default_rng(5)
    n = 1 if lead == "one-chain" else 3
    Ms = np.stack([M * rs.gamma(4.0, 0.25, M.shape).astype(np.float32)
                   for _ in range(n)])
    Os = np.stack([O * rs.gamma(4.0, 0.25, O.shape).astype(np.float32)
                   for _ in range(n)])
    Ds, invs = np.stack([D] * n), np.stack([inv] * n)
    if lead == "shared-data":
        Ds, invs = D, inv
    if lead == "shared-P":
        Os = Os[:1]
    got = dense.chisq_from_state(t(Ds), t(invs), t(Ms), t(Os))
    assert got.shape == (n,)
    for c in range(n):
        Oc = Os[min(c, len(Os) - 1)]
        alone = dense.chisq_from_state(t(D), t(inv), t(Ms[c]), t(Oc))
        assert torch.equal(got[c], alone), c
        jc = float(jdense.chisq_from_state(*(jnp.asarray(x) for x in (
            D, inv, Ms[c], Oc))))
        assert abs(float(got[c]) - jc) <= 1e-4 * abs(jc)


def test_alpha_batch_and_apply_updates_match_jax(tables):
    """Given the same tables, the gathers, pair terms and row updates are
    the same float operations on both sides."""
    D, inv, M, O, k = tables
    jp = jdense.make_phase(jnp.asarray(inv), jnp.asarray(O))
    jc = jdense.rebuild_cache(jnp.asarray(D), jnp.asarray(inv),
                              jnp.asarray(M), jnp.asarray(O))
    tp = dense.DensePhase(SQ=t(jp.SQ), Z=t(jp.Z), col_nz=t(jp.col_nz))
    tc = dense.DenseCache(Y=t(jc.Y))
    rs = np.random.default_rng(3)
    B = 64
    NR = D.shape[0]
    r1 = rs.integers(0, NR, B)
    r2 = np.where(rs.random(B) < 0.3, r1, rs.integers(0, NR, B))
    c1, c2 = rs.integers(0, k, B), rs.integers(0, k, B)
    ja = jdense.alpha_batch(jc, jp, None, JAddr(*(jnp.asarray(x, jnp.int32)
                                                  for x in (r1, c1, r2, c2))))
    ta = dense.alpha_batch(tc, tp, AddrBatch(*(torch.from_numpy(x)
                                               for x in (r1, c1, r2, c2))))
    for name in ("s1", "smu1", "s_pair", "smu_pair"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)),
                                   rtol=1e-6, atol=0, err_msg=name)

    # one applied change per row (rows are disjoint across lanes in a
    # sweep), stream 2 on the same row as stream 1 for a third of them
    rows1 = rs.permutation(NR)[:min(B, NR)]
    n = rows1.shape[0]
    rows2 = np.where(rs.random(n) < 0.3, rows1, NR - 1 - rows1)
    rows = np.concatenate([rows1, rows2])
    cols = rs.integers(0, k, 2 * n)
    deltas = (rs.normal(0, 1, 2 * n) * (rs.random(2 * n) < 0.7)).astype(
        np.float32)
    # distinct rows across lanes: drop stream-2 changes whose row another
    # lane uses
    used = {}
    for i, r in enumerate(rows):
        used.setdefault(int(r), set()).add(i % n)
    for i in range(n, 2 * n):
        if len(used[int(rows[i])]) > 1:
            deltas[i] = 0.0
    jy = jdense.apply_updates(jc, jp, None, JApply(
        rows=jnp.asarray(rows, jnp.int32), cols=jnp.asarray(cols, jnp.int32),
        deltas=jnp.asarray(deltas)))
    ty = dense.apply_updates(tc, tp, ApplyBatch(
        rows=torch.from_numpy(rows), cols=torch.from_numpy(cols),
        deltas=torch.from_numpy(deltas)))
    np.testing.assert_allclose(ty.Y.numpy(), np.asarray(jy.Y), rtol=1e-6,
                               atol=1e-6 * float(np.abs(np.asarray(jc.Y)).max()))
