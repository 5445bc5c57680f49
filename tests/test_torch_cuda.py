"""The CUDA sweep kernel (cogaps_tpu_torch/csrc/sweep.cu) on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where those are
absent, without the suite's conftest.py (which loads jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernel is held to its plain version (ops/sweep.py, run on the same
CUDA tensors by sweep_cuda.run_updates_multi_plain) decision for
decision: equal done, sweeps, counts and elem tables; mass and M within
1e-5 and Y within 1e-3 (the North-star tolerances; on the card both
sides use the same float32 operations and CUDA math functions, and
agree bit for bit in practice)."""

import os

import numpy as np
import pytest
import torch

from cogaps_tpu_torch.models import dense
from cogaps_tpu_torch.ops import rng, sweep, sweep_cuda
from cogaps_tpu_torch.ops.atoms import AtomTable, total_mass_per_element

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernel has no CPU mode)")
    return torch.device("cuda")


def make_states(device, NR, m, k, B, C, nch, seed=0):
    rs = np.random.default_rng(seed)
    D = rs.gamma(2.0, 2.0, (NR, m)).astype(np.float32)
    inv = (1.0 / np.maximum(0.1 * D, 0.1) ** 2).astype(np.float32)
    NB = NR * k
    mass = np.zeros((nch, C), np.float32)
    elem = np.full((nch, C), -1, np.int32)
    n = np.zeros(nch, np.int32)
    for c in range(nch):
        n[c] = min(C // 4, NB // 3, 10 + 30 * c)
        elem[c, :n[c]] = rs.integers(0, NB, n[c])
        mass[c, :n[c]] = rs.gamma(2.0, 0.5, n[c])
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    atoms = AtomTable(mass=to(mass), elem=to(elem), n=to(n))
    M = torch.stack([total_mass_per_element(atoms.chain(c), NB).reshape(NR, k)
                     for c in range(nch)])
    other = to(rs.gamma(2.0, 1.0, (nch, m, k)).astype(np.float32))
    Db = to(np.broadcast_to(D, (nch, NR, m)).copy())
    invb = to(np.broadcast_to(inv, (nch, NR, m)).copy())
    Y = dense.rebuild_cache(Db, invb, M, other).Y
    phase = dense.make_phase(invb, other)
    lam = dense.compute_lambda(D, 0.01, k)
    mass_p = sweep.MassParams(lam=to(np.full(nch, lam, np.float32)),
                              max_gibbs_mass=to(np.full(nch, 100 / lam,
                                                        np.float32)))
    consts = sweep.make_consts(NR, m, k, C, B, 0.01)
    return atoms, M, Y, phase, consts, mass_p


def assert_same(out_k, out_p):
    a_k, M_k, Y_k, done_k, ns_k, cnt_k = out_k
    a_p, M_p, Y_p, done_p, ns_p, cnt_p = out_p
    for x, y in ((done_k, done_p), (ns_k, ns_p), (a_k.n, a_p.n),
                 (a_k.elem, a_p.elem), (cnt_k.processed, cnt_p.processed),
                 (cnt_k.accepted, cnt_p.accepted)):
        assert torch.equal(x.cpu().to(torch.int64), y.cpu().to(torch.int64))
    torch.testing.assert_close(a_k.mass, a_p.mass, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(M_k, M_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(Y_k, Y_p, rtol=1e-3, atol=1e-3)


SHAPES = [  # (n_rows, m, k, B, C): the GIST A and P samplers, a toy
    (1363, 9, 7, 1024, 8192), (9, 1363, 7, 32, 1024), (25, 20, 3, 32, 512),
    (40, 30, 4, 100, 256)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_kernel_matches_plain(cuda_device, shape, mode):
    NR, m, k, B, C = shape
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, NR, m, k, B,
                                                   C, nch=3)
    budgets = torch.tensor([700, 90, 1], dtype=torch.int32,
                           device=cuda_device)
    if mode == "fast":
        rand = sweep_cuda.PhiloxKey(
            key0=torch.tensor([4, 5, 6], device=cuda_device), key1=7)
    else:
        def rand(c, first, n):
            return rng.philox_uniforms(100 + c, 3, c, first, n, B,
                                       device=cuda_device)
    before = sweep_cuda.run_updates_multi.launches
    out_k = sweep_cuda.run_updates_multi(atoms, M, Y, phase, 0.6, budgets,
                                         consts, mass, rand, s_max=8)
    assert sweep_cuda.run_updates_multi.launches > before
    out_p = sweep_cuda.run_updates_multi_plain(atoms, M, Y, phase, 0.6,
                                               budgets, consts, mass, rand)
    torch.cuda.synchronize()
    assert_same(out_k, out_p)
    assert torch.equal(out_k[3].cpu(), budgets.cpu())


@pytest.mark.parametrize("j", [1, 5])
def test_kernel_steps_like_plain(cuda_device, j):
    """max_sweeps stops kernel and plain version after the same sweep."""
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 1363, 9, 7,
                                                   1024, 8192, nch=2)
    budgets = torch.tensor([9000, 50], dtype=torch.int32, device=cuda_device)

    def rand(c, first, n):
        return rng.philox_uniforms(7 + c, 1, c, first, n, 1024,
                                   device=cuda_device)

    args = (atoms, M, Y, phase, 1.0, budgets, consts, mass, rand)
    out_k = sweep_cuda.run_updates_multi(*args, s_max=2, max_sweeps=j)
    out_p = sweep_cuda.run_updates_multi_plain(*args, max_sweeps=j)
    assert_same(out_k, out_p)
    assert int(out_k[4][0]) == j


def test_exact_and_fast_modes_agree(cuda_device):
    """Fast mode's in-kernel Philox draws are the blocks
    ops/rng.philox_uniforms gives to exact mode."""
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 1363, 9, 7,
                                                   1024, 8192, nch=2)
    budgets = torch.tensor([3000, 2500], dtype=torch.int32,
                           device=cuda_device)
    key0 = torch.tensor([21, 22], device=cuda_device)
    fast = sweep_cuda.run_updates_multi(
        atoms, M, Y, phase, 1.0, budgets, consts, mass,
        sweep_cuda.PhiloxKey(key0=key0, key1=9))
    exact = sweep_cuda.run_updates_multi(
        atoms, M, Y, phase, 1.0, budgets, consts, mass,
        lambda c, first, n: rng.philox_uniforms(21 + c, 9, c, first, n, 1024,
                                                device=cuda_device))
    assert_same(fast, exact)


def test_kernel_keeps_the_table_compact(cuda_device):
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 300, 50, 5,
                                                   256, 2048, nch=4)
    budgets = torch.full((4,), 5000, dtype=torch.int32, device=cuda_device)
    a, M2, _, done, ns, cnt = sweep_cuda.run_updates_multi(
        atoms, M, Y, phase, 1.0, budgets, consts, mass,
        sweep_cuda.PhiloxKey(key0=torch.arange(4, device=cuda_device),
                             key1=1))
    assert (done == 5000).all() and (cnt.processed.sum(dim=1) == 5000).all()
    assert (cnt.accepted <= cnt.processed).all() and (ns > 0).all()
    for c in range(4):
        ac = a.chain(c)
        n = int(ac.n)
        assert (ac.elem[:n] >= 0).all() and (ac.elem[n:] == -1).all()
        assert (ac.mass[:n] > 0).all() and (M2[c] >= 0).all()
        drift = (total_mass_per_element(ac, 300 * 5).reshape(300, 5)
                 - M2[c]).abs().max()
        assert float(drift) < 1e-2


def test_wrapper_checks_inputs(cuda_device):
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 25, 20, 3,
                                                   32, 512, nch=2)
    budgets = torch.ones(2, dtype=torch.int32, device=cuda_device)
    key = sweep_cuda.PhiloxKey(key0=torch.arange(2, device=cuda_device),
                               key1=0)
    import dataclasses
    with pytest.raises(ValueError, match="power of two"):
        sweep_cuda.run_updates_multi(
            atoms, M, Y, phase, 1.0, budgets,
            dataclasses.replace(consts, capacity=500), mass, key)
    with pytest.raises(ValueError, match="batch"):
        sweep_cuda.run_updates_multi(
            atoms, M, Y, phase, 1.0, budgets,
            dataclasses.replace(consts, batch=2048), mass, key)
    with pytest.raises(ValueError, match="is on"):
        sweep_cuda.run_updates_multi(
            atoms, M, Y, phase, 1.0, budgets, consts,
            sweep.MassParams(mass.lam.cpu(), mass.max_gibbs_mass), key)


# ----------------------------------------------------------------------
# the fast path end to end, against the reference's golden results with
# tests/test_golden.py's runs and bands
# ----------------------------------------------------------------------
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def best_perm_corr(ours, golden):
    """Greedy best-match correlation per golden pattern
    (tests/test_golden.py::best_perm_corr)."""
    k = golden.shape[1]
    cors = np.array([[np.corrcoef(golden[:, i], ours[:, j])[0, 1]
                      for j in range(k)] for i in range(k)])
    out, used = [], set()
    for i in range(k):
        j = next(jj for jj in np.argsort(-cors[i]) if jj not in used)
        used.add(j)
        out.append(cors[i, j])
    return np.asarray(out)


def test_modsim_golden_equilibrium_on_card(cuda_device):
    """tests/test_golden.py::test_modsim_golden_equilibrium on the card."""
    import cogaps_tpu_torch
    g = np.load(f"{DATA}/modsim.npz")
    res = cogaps_tpu_torch.CoGAPS(g["D"], n_patterns=3, n_iterations=1500,
                                  seed=7, messages=False,
                                  output_frequency=150, device=cuda_device)
    golden_mcs = float(g["golden_meanChiSq"].reshape(-1)[0])
    golden_eq = float(np.mean(g["golden_chisqHistory"][2:]))
    hist = res.diagnostics["chisqHistory"]
    ours_eq = float(np.mean(hist[len(hist) // 2:]))
    assert 0.6 * golden_eq < ours_eq < 1.35 * golden_eq, (ours_eq, golden_eq)
    assert res.mean_chi_sq < 1.8 * golden_mcs
    assert 10 <= res.diagnostics["atomHistoryA"][-1] <= 10 * np.mean(
        g["golden_atomsA"])
    assert 5 <= res.diagnostics["atomHistoryP"][-1] <= 10 * np.mean(
        g["golden_atomsP"])


def test_gist_golden_pattern_recovery_on_card(cuda_device):
    """tests/test_golden.py::test_gist_golden_pattern_recovery (a slow
    test on the CPU) on the card: the chi^2 plateau, meanChiSq and the
    recovered P patterns against the reference's GIST.result."""
    import cogaps_tpu_torch
    z = np.load(f"{DATA}/gist.npz")
    k = int(np.asarray(z["golden_Pmean"]).shape[1])
    res = cogaps_tpu_torch.CoGAPS(np.asarray(z["D"]), n_patterns=k,
                                  n_iterations=1500, seed=3, messages=False,
                                  output_frequency=250, device=cuda_device)
    golden_eq = float(np.mean(np.asarray(z["golden_chisqHistory"])[2:]))
    hist = res.diagnostics["chisqHistory"]
    assert float(np.mean(hist[3 * len(hist) // 4:])) < 1.15 * golden_eq
    golden_mcs = float(np.asarray(z["golden_meanChiSq"]).reshape(-1)[0])
    assert res.mean_chi_sq < 1.4 * golden_mcs
    cors = best_perm_corr(res.Pmean, np.asarray(z["golden_Pmean"]))
    assert np.median(cors) > 0.8 and (cors > 0.5).all(), cors
