"""The port's sampling primitives (cogaps_tpu_torch/ops/rng.py) against
cogaps_tpu/ops/rng.py on fixed numpy grids, far tails included.

ndtr/ndtri: JAX uses jax.scipy.special; the port 0.5*erfc(-x/sqrt 2)
(torch.erfc) and Acklam's approximation refined by one Halley step.
Tolerances are float32 ones: a few ulps where the formulas are the same,
and where they differ, the error of each side against scipy in float64
(stated per test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as ss
import torch

from cogaps_tpu.ops import rng as jrng
from cogaps_tpu_torch.ops import rng

torch.set_num_threads(1)


def grid_u(n=4001):
    return np.concatenate([
        np.logspace(-7, -0.31, n), np.linspace(0.0, 1.0, n, endpoint=False),
        1.0 - np.logspace(-7, -0.31, n)]).astype(np.float32)


def test_ndtri_matches_scipy_in_the_tails():
    """Relative error below 1e-6 against scipy in float64 on
    [1e-7, 1-1e-7] — the same bound jax.scipy's ndtri meets there."""
    q = np.clip(grid_u(), 1e-7, 1 - 1e-7).astype(np.float32)
    exact = ss.ndtri(q.astype(np.float64))
    port = rng.ndtri(torch.from_numpy(q)).double().numpy()
    jax_v = np.asarray(jrng.ndtri(jnp.asarray(q))).astype(np.float64)
    scale = np.maximum(np.abs(exact), 1e-3)
    assert (np.abs(port - exact) / scale).max() < 1e-6
    assert (np.abs(jax_v - exact) / scale).max() < 1e-6
    np.testing.assert_allclose(port, jax_v, rtol=2e-6, atol=2e-6)


def test_ndtr_matches_jax():
    """Relative error of either side against scipy is below 5e-6 on
    [-9, 9] (both lose a few ulps in the far lower tail)."""
    x = np.linspace(-9.0, 9.0, 36001).astype(np.float32)
    exact = ss.ndtr(x.astype(np.float64))
    port = rng.ndtr(torch.from_numpy(x)).double().numpy()
    jax_v = np.asarray(jrng.ndtr(jnp.asarray(x))).astype(np.float64)
    assert (np.abs(port - exact) / exact).max() < 5e-6
    np.testing.assert_allclose(port, jax_v, rtol=1e-5, atol=0)


def _case_grid():
    rs = np.random.default_rng(0)
    n = 5000
    u = rs.random(n).astype(np.float32)
    # s spans the conditioning range of real tables, incl. s ~ epsilon
    s = (10.0 ** rs.uniform(-11, 4, n)).astype(np.float32)
    s_mu = (rs.normal(0, 1, n) * 10.0 ** rs.uniform(-3, 4, n)).astype(
        np.float32)
    a = np.where(rs.random(n) < 0.5, 0.0, -rs.gamma(2, 1, n)).astype(
        np.float32)
    b = (np.abs(a) + rs.gamma(2, 2, n)).astype(np.float32)
    return u, s, s_mu, a, b


def _gibbs_f64(u, s, s_mu, a, b, lam):
    """ops/rng.gibbs_mass evaluated in float64 with scipy's ndtr/ndtri:
    the truth both float32 implementations approximate."""
    u, s, s_mu, a, b = (x.astype(np.float64) for x in (u, s, s_mu, a, b))
    s_safe = np.maximum(s, 1e-10)
    mu = ((s_mu - lam) if lam is not None else s_mu) / s_safe
    sd = np.maximum(1.0 / np.sqrt(s_safe), 1e-30)
    pl, pu = ss.ndtr((a - mu) / sd), ss.ndtr((b - mu) / sd)
    ok = ~((pl > 0.95) | (pu < 0.05)) & (s > 1e-10)
    q = np.clip(pl + u * (pu - pl), 1e-7, 1 - 1e-7)
    return np.clip(mu + sd * ss.ndtri(q), a, b), ok


@pytest.mark.parametrize("with_lambda", [True, False])
def test_gibbs_mass_matches_jax(with_lambda):
    """Same ok flags away from the 0.05/0.95 edges. The inverse CDF
    amplifies float32 rounding of ndtr near q -> 1 by sd/phi(z), so each
    side is held to float64 truth instead of to the other: the port's
    worst error relative to the window width is at most twice JAX's."""
    u, s, s_mu, a, b = _case_grid()
    lam = np.float32(0.37) if with_lambda else None
    jv, jok = jrng.gibbs_mass(jnp.asarray(u), jnp.asarray(s),
                              jnp.asarray(s_mu), jnp.asarray(a),
                              jnp.asarray(b), lam)
    t = torch.from_numpy
    pv, pok = rng.gibbs_mass(t(u), t(s), t(s_mu), t(a), t(b),
                             None if lam is None else torch.tensor(lam))
    ev, eok = _gibbs_f64(u, s, s_mu, a, b, lam)
    jv, jok = np.asarray(jv), np.asarray(jok)
    pv, pok = pv.numpy(), pok.numpy()
    assert (jok == pok).mean() > 0.999
    both = jok & pok & eok
    assert both.sum() > 1000
    width = (b - a)[both]
    err_port = (np.abs(pv[both] - ev[both]) / width).max()
    err_jax = (np.abs(jv[both] - ev[both]) / width).max()
    assert err_port <= 2.0 * err_jax + 1e-6, (err_port, err_jax)


def test_exponential_and_log_uniform_match_jax():
    u = grid_u()
    lam = np.float32(0.123)
    np.testing.assert_allclose(
        rng.exponential(torch.from_numpy(u), torch.tensor(lam)).numpy(),
        np.asarray(jrng.exponential(jnp.asarray(u), lam)),
        rtol=2e-6, atol=0)
    np.testing.assert_allclose(
        rng.log_uniform(torch.from_numpy(u)).numpy(),
        np.asarray(jrng.log_uniform(jnp.asarray(u))), rtol=2e-6, atol=1e-7)


def _trunc_gamma2_f64(u, b):
    """The exact root of 1 - e^-y (1 + y) = u * (1 - e^-b (1 + b)) on
    [0, b], by bisection in float64."""
    b = np.maximum(b.astype(np.float64), 1e-6)
    target = u.astype(np.float64) * -np.expm1(np.log1p(b) - b)
    lo, hi = np.zeros_like(b), b.copy()
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        h = -np.expm1(np.log1p(mid) - mid)
        lo, hi = np.where(h < target, mid, lo), np.where(h < target, hi, mid)
    return 0.5 * (lo + hi)


@pytest.mark.parametrize("b_scale", [1e-1, 1.0, 30.0])
def test_trunc_gamma2_y_matches_jax(b_scale):
    """Same formula on both sides; 1 - e^-y (1 + y) cancels in float32 for
    small y, where the two exp implementations part by up to a few
    percent. Each side is held to the float64 root: the port's worst
    error relative to b is at most twice JAX's, plus 1e-6."""
    rs = np.random.default_rng(1)
    u = rs.random(4000).astype(np.float32)
    b = (rs.gamma(2.0, 1.0, 4000) * b_scale).astype(np.float32)
    j = np.asarray(jrng.trunc_gamma2_y(jnp.asarray(u), jnp.asarray(b)))
    p = rng.trunc_gamma2_y(torch.from_numpy(u), torch.from_numpy(b)).numpy()
    exact = _trunc_gamma2_f64(u, b)
    scale = np.maximum(b, 1e-6)
    err_port = (np.abs(p - exact) / scale).max()
    err_jax = (np.abs(j - exact) / scale).max()
    assert err_port <= 2.0 * err_jax + 1e-6, (err_port, err_jax)
    assert ((p >= 0) & (p <= scale * (1 + 1e-6))).all()


def test_poisson_fast_matches_jax_formula():
    """poisson_fast takes the normal draw as an argument; with the same z
    it equals JAX's max(round(lam + sqrt(lam) z), 0)."""
    rs = np.random.default_rng(2)
    lam = np.concatenate([[0.0, 10.0], rs.gamma(2, 500, 2000)]).astype(
        np.float32)
    z = rs.normal(0, 1, lam.shape).astype(np.float32)
    port = rng.poisson_fast(torch.from_numpy(z), torch.from_numpy(lam))
    ref = np.maximum(np.round(lam + np.sqrt(np.maximum(lam, 0)) * z), 0)
    np.testing.assert_array_equal(port.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expected):
    """Random123's known-answer vectors for Philox4x32-10."""
    words = rng.philox4x32(*(torch.tensor([c]) for c in ctr), *key)
    assert tuple(int(w) for w in words) == expected


def test_philox_uniforms_layout_and_range():
    slab = rng.philox_uniforms(12345, 678, chain=2, first_sweep=3,
                               n_sweeps=2, B=64)
    assert slab.shape == (32, 64) and slab.dtype == torch.float32
    assert float(slab.min()) >= 0.0 and float(slab.max()) < 1.0
    # sweep 4's block is the second half, and matches a one-sweep draw
    one = rng.philox_uniforms(12345, 678, 2, 4, 1, 64)
    assert torch.equal(slab[16:], one)
    # row 4g+j, lane l is word j of philox((l, g, sweep, chain), key)
    w = rng.philox4x32(torch.tensor([5]), torch.tensor([1]),
                       torch.tensor([4]), torch.tensor([2]), 12345, 678)
    assert float(one[4 + 2, 5]) == float(rng.to_unit(w[2])[0])
    z_a, z_p = rng.philox_normals(torch.tensor([1, 2, 3]),
                                  torch.arange(1000))
    assert z_a.shape == (3, 1000)
    for z in (z_a, z_p):
        assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 1) < 0.1
