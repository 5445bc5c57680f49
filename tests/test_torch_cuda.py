"""The CUDA sweep kernels (cogaps_tpu_torch/csrc/sweep.cu and atlas.cu) on
the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where those are
absent, without the suite's conftest.py (which loads jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The dense sweep kernel, on dense tables (K1) and on the sparse model's
tables (K2), is held to its plain version (ops/sweep.py, run on the
same CUDA tensors by sweep_cuda.run_updates_multi_plain) decision for
decision: equal done, sweeps, counts and elem tables; mass and M within
1e-5 and Y within 1e-3 (the North-star tolerances; on the card both
sides use the same float32 operations and CUDA math functions, and
agree bit for bit in practice), under every placement of the chains'
state in shared memory (none, the claims, the atom table, Y/SQ/M, all),
at every width class (B = 1, 31, 32, 33, 256, 257, 1024), from C = 1024
to 65536 and 1 to 200 chains, across several exact-mode slabs and with
max_sweeps stepping; two fast runs give the same bits, a block too large
for the card is refused and raises, and the one-warp class's machine
code has no block barrier. The CSR sweep kernel (K4) is held to
its plain version (ops/sweep.py with models/sparse.make_model) by the
per-call contract of tests/test_atlas_engine.py:218-227: equal done,
sweeps, counts, n and elem; mass and M within atol 5e-3, rtol 1e-4 (it
sums over a row's nonzeros in another order), also on a row of over
20,000 nonzeros, at k = 1 and 64, B = 1 and 1024, and on three chains
with budgets 0, 37 and 400; two of its fast-mode runs agree bit for bit,
and a launch the card refuses raises. The fused-span kernel
(K3, csrc/span.cu) is held to its plain version (ops/span.py) over whole
iterations in both phases, at the cluster size its rule picks and at each
of 8, 4, 2 and 1 CTAs a chain: equal atom tables and counters, mass, M and
the running sums within 1e-5; its rebuild alone to the plain tables, bit
for bit, at GIST x16, 2000 x 128 k=10, k = 1 and 12, and at 1 to 200
chains; two runs give the same bits, and a cluster launch the card
refuses raises; a fused run broken off mid-chunk and resumed from a
checkpoint gives the bits of the run without a break. Chains of one seed
draw alike in fast mode, and as a one-chain launch of that seed does
(the distributed runs' subset chains). The command line without
--device runs on the card (K1 launches; diagnostics["device"] is CUDA
in the npz and the CSV meta file), and the native parser builds with the
card host's C++ compiler into cogaps_tpu_torch/_build/ and reads GIST as
the Python parsers do. The gene-sharded engines run their kernels as
their plain versions run the same iterations (the dense engine's blocks
and replicated P on K1, the sparse engine's P sampler on summed tables
on K2: decision-exact, mass and M within 1e-5), and two ranks that share
the card over gloo give the bits of one process (mesh=None). F3
(first_wins, a shared-memory hash table a chain) equals its plain version
at the probes' and the port's shapes and on NaN, signed zeros, one key
and all-distinct keys; F7's sum is within 1e-6 of its plain version,
with 16-byte and 4-byte loads; each counts its launches and repeats its
bits. GWCoGAPS's subset chains on 2 ranks sharing the card (gloo), and
on a card a rank (NCCL, where there are two cards or more), return the
one-process result bit for bit. The per-call tables kernel
(csrc/tables.cu, through models/dense.tables) is within 1e-5 of each
entry's summed |terms| of the float64 tables rounded once and no worse
than twice the plain cuBLAS tables' own worst error, on inputs with
zeros in D, padded invS2 = 0 rows and an empty partner column, at GIST,
the subset shapes, 5000 x 2000, 20000 x 100 and k = 1 to 50 (both of its
kernels); a chain's tables are the same bits alone, as one of 4 and as
one of 16; and a chain mesh's per-call runs, through subset_engine and
through MultichainEngine(..., mesh=...) made directly, give each chain
the bits it gets beside the others, one tables launch a sampled factor
an iteration. F4's row form is exact at NR = 1, 50, 1363 and B = 1, 100,
1024 with NaN and out-of-range lanes; the dependent-load floor's chain
equals its plain version."""

import os
import re

import numpy as np
import pytest
import torch

from cogaps_tpu_torch.models import dense, sparse
from cogaps_tpu_torch.ops import (atlas_cuda, rng, span, span_cuda, sweep,
                                  sweep_cuda)
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
        lambda c, first, n: rng.philox_uniforms(21 + c, 9, 0, first, n, 1024,
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
# K2: the sweep kernel on the sparse model's tables
# ----------------------------------------------------------------------
def sparse_data(G, S, seed, density=0.4):
    rs = np.random.default_rng(seed)
    D = (rs.gamma(2.0, 1.0, (G, S)) * (rs.random((G, S)) < density))
    return D.astype(np.float32)


def sparse_states(device, D, k, B, C, nch, seed=0):
    """NCH chains' atoms, M and partner factors on the rows of D."""
    rs = np.random.default_rng(seed)
    NR, m = D.shape
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
    lam = 0.01 * float(np.sqrt(k / D[D != 0].mean()))
    mass_p = sweep.MassParams(lam=to(np.full(nch, lam, np.float32)),
                              max_gibbs_mass=to(np.full(nch, 100 / lam,
                                                        np.float32)))
    return atoms, M, other, mass_p, sweep.make_consts(NR, m, k, C, B, 0.01)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("side", ["A", "P"])
def test_tables_kernel_matches_plain(cuda_device, mode, side):
    D = sparse_data(60, 35, 1)
    D = D if side == "A" else D.T
    atoms, M, other, mass, consts = sparse_states(cuda_device, D, 4, 64,
                                                  1024, 3)
    r, c = np.nonzero(D)
    csr = sparse.coo_to_csr(r, c, D[r, c], D.shape[0])
    Wd, D1 = (w[0].to(cuda_device)
              for w in sparse.dense_weights(csr, D.shape[1]))
    SQ, Y0, G = sparse.kernel_tables(Wd, D1, other, M)
    phase = dense.DensePhase(SQ=SQ, Z=G, col_nz=other.amax(dim=1) > 0)
    budgets = torch.tensor([500, 90, 1], dtype=torch.int32,
                           device=cuda_device)
    rand = (sweep_cuda.PhiloxKey(key0=torch.tensor([4, 5, 6],
                                                   device=cuda_device),
                                 key1=2) if mode == "fast" else
            lambda c, first, n: rng.philox_uniforms(50 + c, 3, c, first, n,
                                                    64, device=cuda_device))
    out_k = sweep_cuda.run_updates_multi(atoms, M, Y0, phase, 0.8, budgets,
                                         consts, mass, rand, s_max=8)
    out_p = sweep_cuda.run_updates_multi_plain(atoms, M, Y0, phase, 0.8,
                                               budgets, consts, mass, rand)
    torch.cuda.synchronize()
    assert_same(out_k, out_p)


# ----------------------------------------------------------------------
# K1/K2: each chain's state in shared memory, width classes
# ----------------------------------------------------------------------
CLAIMS = ("rmin", "amin", "hole")
PLACEMENTS = {"none": (), "claims": CLAIMS,
              "atoms": CLAIMS + ("mass", "elem"),
              "tables": CLAIMS + ("mass", "elem", "Y", "SQ", "M"),
              "all": sweep_cuda.PLACED}
WIDTHS = [1, 31, 32, 33, 256, 257, 1024]  # each side of the classes' edges


def sweep_rand(mode, device, nch, B, seed=3):
    if mode == "fast":
        return sweep_cuda.PhiloxKey(
            key0=torch.arange(seed, seed + nch, device=device), key1=seed)
    return lambda c, first, n: rng.philox_uniforms(seed + c, seed, c, first,
                                                   n, B, device=device)


def run_placed(args, place, s_max=8, max_sweeps=None):
    """The kernel with the arrays `place` forced into shared memory."""
    return sweep_cuda._run_kernel(*args, s_max, max_sweeps, place=place)


@pytest.mark.parametrize("B", WIDTHS)
@pytest.mark.parametrize("placement", list(PLACEMENTS))
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_kernel_every_placement_and_width(cuda_device, mode, placement, B):
    """Every placement of the state, at every width class, decides as the
    plain version does (budgets 0, 37 and a few sweeps' worth)."""
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 200, 30, 5,
                                                   B, 2048, nch=3)
    budgets = torch.tensor([min(max(4 * B, 60), 2500), 37, 0],
                           dtype=torch.int32, device=cuda_device)
    args = (atoms, M, Y, phase, 0.7, budgets, consts, mass,
            sweep_rand(mode, cuda_device, 3, B))
    out_k = run_placed(args, PLACEMENTS[placement])
    out_p = sweep_cuda.run_updates_multi_plain(*args)
    torch.cuda.synchronize()
    assert_same(out_k, out_p)
    assert torch.equal(out_k[3].cpu(), budgets.cpu())


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("shape", [
    (9, 300, 7, 32, 1024, 200),  # GIST P's width, 200 chains, several an SM
    (40, 30, 4, 100, 65536, 2),  # C = 65536
    (300, 20, 10, 1024, 16384, 1),
    (2000, 40, 10, 1024, 32768, 3),  # only the claims fit
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_capacities_and_chains(cuda_device, mode, shape):
    """The plan's own placement from C = 1024 to 65536 and 1 to 200
    chains."""
    NR, m, k, B, C, nch = shape
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, NR, m, k, B,
                                                   C, nch=nch)
    budgets = torch.tensor([(37 * c) % 90 + 5 * (c % 2) for c in range(nch)],
                           dtype=torch.int32, device=cuda_device)
    args = (atoms, M, Y, phase, 1.0, budgets, consts, mass,
            sweep_rand(mode, cuda_device, nch, B))
    out_k = sweep_cuda.run_updates_multi(*args)
    out_p = sweep_cuda.run_updates_multi_plain(*args)
    torch.cuda.synchronize()
    assert_same(out_k, out_p)


@pytest.mark.parametrize("placement", ["none", "all"])
@pytest.mark.parametrize("j", [1, 3, 7, None])
def test_kernel_placed_across_slabs(cuda_device, placement, j):
    """Exact mode in slabs of 2 sweeps a launch: the staged state goes
    back to global memory and in again at each launch unchanged, and
    max_sweeps stops kernel and plain version after the same sweep."""
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 200, 30, 5,
                                                   256, 2048, nch=2)
    budgets = torch.tensor([1500, 60], dtype=torch.int32,
                           device=cuda_device)
    args = (atoms, M, Y, phase, 1.0, budgets, consts, mass,
            sweep_rand("exact", cuda_device, 2, 256))
    out_k = run_placed(args, PLACEMENTS[placement], s_max=2, max_sweeps=j)
    out_p = sweep_cuda.run_updates_multi_plain(*args, max_sweeps=j)
    assert_same(out_k, out_p)
    if j is not None:
        assert int(out_k[4][0]) == j
    else:
        assert int(out_k[4][0]) > 2 and torch.equal(out_k[3].cpu(),
                                                   budgets.cpu())


@pytest.mark.parametrize("shape", [(1363, 9, 7, 1024, 8192),
                                   (9, 1363, 7, 32, 1024)])
def test_kernel_is_deterministic(cuda_device, shape):
    NR, m, k, B, C = shape
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, NR, m, k, B,
                                                   C, nch=4)
    budgets = torch.full((4,), 3000, dtype=torch.int32, device=cuda_device)
    args = (atoms, M, Y, phase, 1.0, budgets, consts, mass,
            sweep_rand("fast", cuda_device, 4, B))
    def flat(out):
        atoms_k, M_k, Y_k, done, ns, cnt = out
        return (atoms_k.mass, atoms_k.elem, atoms_k.n, M_k, Y_k, done, ns,
                cnt.processed, cnt.accepted)

    one = flat(sweep_cuda.run_updates_multi(*args))
    two = flat(sweep_cuda.run_updates_multi(*args))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_kernel_refused_launch_raises(cuda_device):
    """Everything forced into shared memory at GIST A (Z alone is 267 KB)
    is more than a block may take: the launch is refused and raises, and
    the next launch runs."""
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 1363, 9, 7,
                                                   1024, 8192, nch=1)
    budgets = torch.full((1,), 500, dtype=torch.int32, device=cuda_device)
    args = (atoms, M, Y, phase, 1.0, budgets, consts, mass,
            sweep_rand("fast", cuda_device, 1, 1024))
    with pytest.raises(RuntimeError, match="launch failed"):
        run_placed(args, sweep_cuda.PLACED)
    out = sweep_cuda.run_updates_multi(*args)
    torch.cuda.synchronize()
    assert int(out[3][0]) == 500


def test_kernel_static_smem_within_the_plan(cuda_device):
    """smem_plan's budget leaves room for each class's static shared
    memory (sweep_common.cuh::SweepShared)."""
    lib, _ = sweep_cuda.build()
    for B in WIDTHS:
        used = lib.cogaps_sweep_static_smem(B)
        assert 0 < used <= sweep_cuda.STATIC_SMEM, (B, used)


def test_one_warp_class_issues_no_block_barrier(cuda_device):
    """The B <= 32 instantiation's machine code has no block barrier
    (BAR.*); the wider classes have them."""
    import shutil
    import subprocess
    from pathlib import Path
    from cogaps_tpu_torch.ops import cuda_build
    lib, _ = sweep_cuda.build()
    tool = (shutil.which("cuobjdump")
            or str(Path(cuda_build._nvcc()).parent / "cuobjdump"))
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    bodies = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        bodies[name.strip()] = body
    barriers = {t: [bool(re.search(r"\bBAR\.", b)) for n, b in bodies.items()
                    if f"sweep_kernelILi{t}E" in n] for t in (32, 256, 1024)}
    assert barriers == {32: [False], 256: [True], 1024: [True]}


# ----------------------------------------------------------------------
# K4: the CSR sweep kernel
# ----------------------------------------------------------------------
def assert_atlas_same(out_k, out_p):
    a_k, M_k, done_k, ns_k, cnt_k = out_k
    a_p, M_p, done_p, ns_p, cnt_p = out_p
    for x, y in ((done_k, done_p), (ns_k, ns_p), (a_k.n, a_p.n),
                 (a_k.elem, a_p.elem), (cnt_k.processed, cnt_p.processed),
                 (cnt_k.accepted, cnt_p.accepted)):
        assert torch.equal(x.cpu().to(torch.int64), y.cpu().to(torch.int64))
    torch.testing.assert_close(a_k.mass, a_p.mass, rtol=1e-4, atol=5e-3)
    torch.testing.assert_close(M_k, M_p, rtol=1e-4, atol=5e-3)


ATLAS_SHAPES = [(64, 48, 3, 128, 2048, 0.5), (300, 200, 5, 256, 4096, 0.3),
                (40, 900, 8, 32, 1024, 0.6)]  # the last: rows of ~540 nnz


@pytest.mark.parametrize("shape", ATLAS_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3])))
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_atlas_kernel_matches_plain(cuda_device, shape, mode):
    G, S, k, B, C, density = shape
    D = sparse_data(G, S, 2, density)
    atoms, M, other, mass, consts = sparse_states(cuda_device, D, k, B, C, 2)
    r, c = np.nonzero(D)
    csr = sparse.stack_csr([(r, c, D[r, c])] * 2, G).to(cuda_device)
    budgets = torch.tensor([400, 37], dtype=torch.int32, device=cuda_device)
    rand = (sweep_cuda.PhiloxKey(key0=torch.tensor([8, 9],
                                                   device=cuda_device),
                                 key1=4) if mode == "fast" else
            lambda c, first, n: rng.philox_uniforms(70 + c, 5, c, first, n,
                                                    B, device=cuda_device))
    before = atlas_cuda.run_updates_atlas_multi.launches
    out_k = atlas_cuda.run_updates_atlas_multi(
        atoms, M, csr, other, 0.7, budgets, consts, mass, rand, s_max=8)
    assert atlas_cuda.run_updates_atlas_multi.launches > before
    out_p = atlas_cuda.run_updates_atlas_multi_plain(
        atoms, M, csr, other, 0.7, budgets, consts, mass, rand)
    torch.cuda.synchronize()
    assert_atlas_same(out_k, out_p)
    assert torch.equal(out_k[2].cpu(), budgets.cpu())


def test_atlas_kernel_keeps_mass_and_checks_inputs(cuda_device):
    D = sparse_data(120, 80, 3)
    atoms, M, other, mass, consts = sparse_states(cuda_device, D, 4, 128,
                                                  2048, 2)
    r, c = np.nonzero(D)
    csr = sparse.stack_csr([(r, c, D[r, c])] * 2, 120).to(cuda_device)
    budgets = torch.full((2,), 3000, dtype=torch.int32, device=cuda_device)
    key = sweep_cuda.PhiloxKey(key0=torch.arange(2, device=cuda_device),
                               key1=1)
    a, M2, done, ns, cnt = atlas_cuda.run_updates_atlas_multi(
        atoms, M, csr, other, 1.0, budgets, consts, mass, key)
    assert (done == 3000).all() and (cnt.accepted <= cnt.processed).all()
    for ch in range(2):
        drift = (total_mass_per_element(a.chain(ch), 120 * 4).reshape(120, 4)
                 - M2[ch]).abs().max()
        assert float(drift) < 1e-2
    with pytest.raises(ValueError, match="is on"):
        atlas_cuda.run_updates_atlas_multi(atoms, M, csr.to("cpu"), other,
                                           1.0, budgets, consts, mass, key)


def run_atlas_pair(device, D, k, B, C, budgets, mode, seed=0, s_max=8):
    """K4 and its plain version on the rows of D, one chain per budget;
    returns (kernel out, plain out, csr, inputs)."""
    nch = len(budgets)
    atoms, M, other, mass, consts = sparse_states(device, D, k, B, C, nch,
                                                  seed)
    r, c = np.nonzero(D)
    csr = sparse.stack_csr([(r, c, D[r, c])] * nch, D.shape[0]).to(device)
    budgets = torch.tensor(budgets, dtype=torch.int32, device=device)
    rand = (sweep_cuda.PhiloxKey(key0=torch.arange(3, 3 + nch,
                                                   device=device),
                                 key1=6) if mode == "fast" else
            lambda ch, first, n: rng.philox_uniforms(90 + ch, 2, ch, first,
                                                     n, B, device=device))
    args = (atoms, M, csr, other, 0.9, budgets, consts, mass, rand)
    before = atlas_cuda.run_updates_atlas_multi.launches
    out_k = atlas_cuda.run_updates_atlas_multi(*args, s_max=s_max)
    assert atlas_cuda.run_updates_atlas_multi.launches > before
    out_p = atlas_cuda.run_updates_atlas_multi_plain(*args)
    torch.cuda.synchronize()
    return out_k, out_p, csr, args


def skewed_data(G=40, S=24000, long_row=3, seed=4):
    """Rows of ~1% nonzeros and one of ~90% (over 20,000)."""
    rs = np.random.default_rng(seed)
    D = rs.gamma(2.0, 1.0, (G, S)) * (rs.random((G, S)) < 0.01)
    D[long_row] = rs.gamma(2.0, 1.0, S) * (rs.random(S) < 0.9)
    return D.astype(np.float32)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_atlas_kernel_skewed_rows(cuda_device, mode):
    """A row of over 20,000 nonzeros (~170 work items) among short rows;
    the rows of the P side, of 40 nonzeros at most, beside it."""
    D = skewed_data()
    assert int((D[3] != 0).sum()) >= 20000
    out_k, out_p, _, _ = run_atlas_pair(cuda_device, D, 4, 64, 1024,
                                        [300, 120], mode)
    assert_atlas_same(out_k, out_p)
    out_k, out_p, _, _ = run_atlas_pair(cuda_device, D.T.copy(), 4, 256,
                                        4096, [500, 60], mode)
    assert_atlas_same(out_k, out_p)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("k,B", [(1, 64), (64, 128), (4, 1), (4, 1024)],
                         ids=["k1", "k64", "B1", "B1024"])
def test_atlas_kernel_edges(cuda_device, mode, k, B):
    """Three chains with budgets 0, 37 and 400 at the kernel's limits of
    k and B."""
    D = sparse_data(300, 200, 5, 0.3)
    out_k, out_p, _, _ = run_atlas_pair(cuda_device, D, k, B, 4096,
                                        [0, 37, 400], mode)
    assert_atlas_same(out_k, out_p)
    assert out_k[2].tolist() == [0, 37, 400]
    assert int(out_k[3][0]) == 0


def test_atlas_kernel_is_deterministic(cuda_device):
    """No float atomics: two fast-mode runs on the same inputs give the
    same bits."""
    D = skewed_data(seed=6)
    out_1, _, _, args = run_atlas_pair(cuda_device, D, 8, 512, 4096,
                                       [2000, 900], "fast")
    out_2 = atlas_cuda.run_updates_atlas_multi(*args)
    for x, y in ((out_1[1], out_2[1]), (out_1[0].mass, out_2[0].mass),
                 (out_1[0].elem, out_2[0].elem), (out_1[0].n, out_2[0].n)):
        assert torch.equal(x, y)


def test_atlas_kernel_refused_launch_raises(cuda_device):
    """More chains than the card keeps resident: the cooperative launch is
    refused, the wrapper raises, and the next launch runs."""
    nch = atlas_cuda.grid_blocks(cuda_device) + 1
    D = sparse_data(12, 10, 7, 0.5)
    atoms, M, other, mass, consts = sparse_states(cuda_device, D, 2, 8, 64,
                                                  nch)
    r, c = np.nonzero(D)
    csr = sparse.stack_csr([(r, c, D[r, c])] * nch, 12).to(cuda_device)
    key = sweep_cuda.PhiloxKey(key0=torch.arange(nch, device=cuda_device),
                               key1=1)
    budgets = torch.full((nch,), 20, dtype=torch.int32, device=cuda_device)
    before = atlas_cuda.run_updates_atlas_multi.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        atlas_cuda.run_updates_atlas_multi(atoms, M, csr, other, 1.0, budgets,
                                           consts, mass, key)
    assert atlas_cuda.run_updates_atlas_multi.launches == before
    out_k, out_p, _, _ = run_atlas_pair(cuda_device, D, 2, 8, 64, [20],
                                        "fast")
    assert_atlas_same(out_k, out_p)


def test_sparse_engines_on_card(cuda_device):
    """The sparse engine in every mode, CoGAPS(sparse_optimization=True)
    and run_atlas on the card: the chi^2 history falls 5x
    (tests/test_sparse.py:107-114) and the kernels launched."""
    import dataclasses
    import cogaps_tpu_torch
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
    from cogaps_tpu_torch.io.coo import CooMatrix
    from cogaps_tpu_torch.parallel.atlas_engine import run_atlas
    from cogaps_tpu_torch.sparse_engine import SparseGapsEngine
    rs = np.random.default_rng(5)
    A = rs.gamma(2.0, 1.0, (30, 3)) * (rs.random((30, 3)) < 0.45)
    P = rs.gamma(2.0, 1.0, (20, 3)) * (rs.random((20, 3)) < 0.45)
    D = (A @ P.T).astype(np.float32)
    cfg = cogaps_tpu_torch.CogapsParams(
        n_patterns=3, n_iterations=300, seed=1,
        output_frequency=100).engine_config(*D.shape)

    def launches():
        return (sweep_cuda.run_updates_multi.launches
                + atlas_cuda.run_updates_atlas_multi.launches)

    for mode in ("dense", "ell", "xla"):
        before = launches()
        eng = SparseGapsEngine(
            D, dataclasses.replace(cfg, sparse_table_mode=mode), cuda_device)
        st, ss = eng.init_state(), eng.init_stats()
        rand = PhiloxRandom([1], cuda_device)
        for ph in (EQUILIBRATION, SAMPLING):
            st, ss = eng.run_phase(st, ss, rand, ph)
        h = ss.chisq_hist[0].cpu().numpy()
        assert h[-1] < 0.2 * h[0], (mode, h)
        assert launches() - before >= 2 * 2 * 300
    res = cogaps_tpu_torch.CoGAPS(D, n_patterns=3, n_iterations=300, seed=1,
                                  messages=False, sparse_optimization=True,
                                  output_frequency=100, device=cuda_device)
    h = res.diagnostics["chisqHistory"]
    assert h[-1] < 0.2 * h[0] and np.isfinite(res.mean_chi_sq)
    r, c = np.nonzero(D)
    res = run_atlas(CooMatrix(r, c, D[r, c], D.shape), n_patterns=3,
                    n_iterations=300, seed=2, messages=False,
                    device=cuda_device, batch=64, capacity=1024)
    # 100 * nnz is chi^2 at zero factors
    assert np.isfinite(res.mean_chi_sq)
    assert res.mean_chi_sq < 0.2 * 100 * len(r)


# ----------------------------------------------------------------------
# K3: the fused-span kernel
# ----------------------------------------------------------------------
def span_case(device, G=30, S=8, k=3, nch=3, n_warm=20):
    """NCH chains of toy data after n_warm per-call equilibration
    iterations, and the MultichainEngine that runs them."""
    from cogaps_tpu_torch.engine import (EQUILIBRATION, ChainEngine,
                                         PhiloxRandom)
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    from cogaps_tpu_torch.params import CogapsParams
    rs = np.random.default_rng(4)
    A = rs.gamma(2.0, 1.0, (G, k))
    Ds = [(A @ rs.gamma(2.0, 1.0, (S, k)).T).astype(np.float32)
          for _ in range(nch)]
    # 256 threads: the P tables' sums split over lanes (csrc/span.cu)
    cfg = CogapsParams(n_patterns=k, n_iterations=40, output_frequency=0,
                       batch_size_a=256).engine_config(G, S)
    eng = MultichainEngine(stack_device_data(Ds, None, cfg, device), cfg,
                           device)
    seeds = list(range(30, 30 + nch))
    st, ss = ChainEngine.run_phase(eng, eng.init_state(), eng.init_stats(),
                                   PhiloxRandom(seeds, device),
                                   EQUILIBRATION, 0, n_warm)
    return eng, st, ss, seeds


def assert_span_same(out_k, out_p):
    (st_k, ss_k), (st_p, ss_p) = out_k, out_p
    for x, y in ((st_k.atoms_a.elem, st_p.atoms_a.elem),
                 (st_k.atoms_a.n, st_p.atoms_a.n),
                 (st_k.atoms_p.elem, st_p.atoms_p.elem),
                 (st_k.atoms_p.n, st_p.atoms_p.n), (ss_k.upd, ss_p.upd),
                 (ss_k.n_stat, ss_p.n_stat),
                 (ss_k.prop_counts, ss_p.prop_counts),
                 (ss_k.acc_counts, ss_p.acc_counts),
                 (ss_k.sweep_counts, ss_p.sweep_counts)):
        assert torch.equal(x.cpu(), y.cpu())
    for x, y in ((st_k.atoms_a.mass, st_p.atoms_a.mass),
                 (st_k.atoms_p.mass, st_p.atoms_p.mass), (st_k.M_a, st_p.M_a),
                 (st_k.M_p, st_p.M_p), (ss_k.a_sum, ss_p.a_sum),
                 (ss_k.a_sumsq, ss_p.a_sumsq), (ss_k.p_sum, ss_p.p_sum),
                 (ss_k.p_sumsq, ss_p.p_sumsq)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cl", [None, 8, 4, 2, 1])
@pytest.mark.parametrize("phase", [0, 1])
def test_span_kernel_matches_plain(cuda_device, monkeypatch, phase, cl):
    """Seven iterations in chunks of three: three launches; at the cluster
    size the rule picks (None), and at each size forced."""
    from cogaps_tpu_torch.engine import PhiloxRandom
    eng, st, ss, seeds = span_case(cuda_device)
    monkeypatch.setattr(span_cuda, "CHUNK", 3)
    if cl is not None:
        monkeypatch.setattr(span_cuda, "cluster_size", lambda *a: cl)
    it0 = 20 if phase == 0 else 0
    args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, phase,
            eng.data, it0, 7, st, ss)
    before = span_cuda.run_span.launches
    out_k = span_cuda.run_span(*args, PhiloxRandom(seeds, cuda_device))
    assert span_cuda.run_span.launches == before + 3
    out_p = span.run_span_plain(*args, PhiloxRandom(seeds, cuda_device))
    torch.cuda.synchronize()
    assert_span_same(out_k, out_p)
    assert (out_k[1].upd > ss.upd).all()
    assert (out_k[1].n_stat == (7 if phase == 1 else 0)).all()


def test_span_rebuild_matches_plain_tables(cuda_device):
    eng, st, _, _ = span_case(cuda_device, G=70, S=9, k=4)
    got = span_cuda.rebuild_tables(eng.data, st.M_a, st.M_p)
    want = span.rebuild_tables_plain(eng.data, st.M_a, st.M_p)
    for name, x, y in zip(got._fields, got, want):
        assert torch.equal(x, y), name


def rebuild_case(device, G, S, k, nch, seed=5):
    """nch chains of gamma data (GIST's own for 1363 x 9) with random
    factors, as device data."""
    from cogaps_tpu_torch.engine import _device_data
    rs = np.random.default_rng(seed)
    if (G, S) == (1363, 9):
        D = np.stack([np.load(f"{DATA}/gist.npz")["D"].astype(np.float32)]
                     * nch)
    else:
        D = rs.gamma(2.0, 2.0, (nch, G, S)).astype(np.float32)
    inv = (1.0 / np.maximum(0.1 * D, 0.1) ** 2).astype(np.float32)
    one = np.ones(nch, np.float32)
    data = _device_data(D, inv, one, one, one, one, device)
    M_a = rs.gamma(2.0, 1.0, (nch, G, k)).astype(np.float32)
    M_p = rs.gamma(2.0, 1.0, (nch, S, k)).astype(np.float32)
    M_p[0, :, 0] = 0.0  # a dead column
    return (data, torch.as_tensor(M_a, device=device),
            torch.as_tensor(M_p, device=device))


def assert_rebuild_equal(data, M_a, M_p):
    before = span_cuda.rebuild_tables.launches
    got = span_cuda.rebuild_tables(data, M_a, M_p)
    assert span_cuda.rebuild_tables.launches == before + 1
    want = span.rebuild_tables_plain(data, M_a, M_p)
    for name, x, y in zip(got._fields, got, want):
        assert torch.equal(x, y), (name, int((x != y).sum()))


@pytest.mark.parametrize("G,S,k,nch", [
    (1363, 9, 7, 16), (2000, 128, 10, 2), (50, 9, 1, 3), (9, 50, 1, 3),
    (300, 40, 12, 4)], ids=["gist-x16", "2000x128-k10", "k1", "k1-wide",
                            "k12"])
def test_span_rebuild_shapes(cuda_device, G, S, k, nch):
    """The rebuild alone bit-equal to the plain tables: at GIST x16, where
    the P side (partners: 2000 genes) spans the cluster's CTAs, at k=1 on
    either side of the split, and with many column groups."""
    assert_rebuild_equal(*rebuild_case(cuda_device, G, S, k, nch))


@pytest.mark.parametrize("nch", [1, 16, 32, 64, 200])
def test_span_rebuild_cluster_sizes(cuda_device, nch):
    """Chain counts that take clusters of 8 down to 1 (span_cuda.
    cluster_size on the card): the tables stay bit-equal."""
    shape = span_cuda.launch_shape(1, cuda_device, nch, 1363, 9, 7, 1024)
    assert shape.cl in (1, 2, 4, 8)
    if nch == 1:
        assert shape.cl == 8
    if nch == 200:
        assert shape.cl == 1
    assert_rebuild_equal(*rebuild_case(cuda_device, 1363, 9, 7, nch))


@pytest.mark.parametrize("cl", [8, 4, 2, 1])
def test_span_rebuild_each_forced_cluster_size(cuda_device, monkeypatch, cl):
    monkeypatch.setattr(span_cuda, "cluster_size", lambda *a: cl)
    assert_rebuild_equal(*rebuild_case(cuda_device, 2000, 128, 10, 2))
    assert_rebuild_equal(*rebuild_case(cuda_device, 1363, 9, 7, 3))


@pytest.mark.parametrize("cl", [8, 4, 2, 1])
def test_span_rebuild_gwcogaps_subsets_any_cluster_size(cuda_device,
                                                        monkeypatch, cl):
    """GWCoGAPS's free stage at 20000 x 100, k=10: four 5005-gene subset
    chains, whose P side (100 rows, 5005 partners) splits its partner sums
    over the cluster's CTAs. At each cluster size a rank's chain count
    may give it, the tables are the plain version's bit for bit, so a
    chain's bits do not follow how many chains share its launch."""
    monkeypatch.setattr(span_cuda, "cluster_size", lambda *a: cl)
    assert_rebuild_equal(*rebuild_case(cuda_device, 5005, 100, 10, 4))


def test_span_kernel_is_deterministic(cuda_device):
    """No float atomics: two spans from one state give the same bits."""
    from cogaps_tpu_torch.engine import PhiloxRandom
    eng, st, ss, seeds = span_case(cuda_device)
    args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, 1, eng.data, 0,
            6, st, ss)
    (st1, ss1), (st2, ss2) = (
        span_cuda.run_span(*args, PhiloxRandom(seeds, cuda_device))
        for _ in range(2))
    for x, y in ((st1.M_a, st2.M_a), (st1.M_p, st2.M_p),
                 (st1.atoms_a.mass, st2.atoms_a.mass),
                 (st1.atoms_p.elem, st2.atoms_p.elem), (ss1.upd, ss2.upd),
                 (ss1.a_sumsq, ss2.a_sumsq), (ss1.p_sum, ss2.p_sum)):
        assert torch.equal(x, y)
    data, M_a, M_p = rebuild_case(cuda_device, 2000, 128, 10, 2)
    t1, t2 = (span_cuda.rebuild_tables(data, M_a, M_p) for _ in range(2))
    for x, y in zip(t1, t2):
        assert torch.equal(x, y)


def test_span_refused_cluster_launch_raises(cuda_device, monkeypatch):
    """Clusters of 16 CTAs (beyond the portable 8, not enabled): the card
    refuses the launch, the wrappers raise, and nothing falls back."""
    from cogaps_tpu_torch.engine import PhiloxRandom
    eng, st, ss, seeds = span_case(cuda_device, n_warm=2)
    monkeypatch.setattr(span_cuda, "cluster_size", lambda *a: 16)
    before = (span_cuda.run_span.launches, span_cuda.rebuild_tables.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        span_cuda.run_span(eng.config, eng.consts_a, eng.consts_p, eng.hist,
                           0, eng.data, 2, 1, st, ss,
                           PhiloxRandom(seeds, cuda_device))
    with pytest.raises(RuntimeError, match="CUDA error"):
        span_cuda.rebuild_tables(eng.data, st.M_a, st.M_p)
    assert (span_cuda.run_span.launches,
            span_cuda.rebuild_tables.launches) == before
    monkeypatch.undo()  # and the next launch runs
    assert_rebuild_equal(*rebuild_case(cuda_device, 70, 9, 4, 2))


def test_span_wrapper_checks_inputs(cuda_device):
    import dataclasses
    from cogaps_tpu_torch.engine import PhiloxRandom
    eng, st, ss, seeds = span_case(cuda_device, n_warm=2)
    args = (eng.config, eng.consts_a, eng.consts_p, eng.hist, 0)
    rand = PhiloxRandom(seeds, cuda_device)
    with pytest.raises(ValueError, match="is on"):
        span_cuda.run_span(*args, dataclasses.replace(eng.data,
                                                      D=eng.data.D.cpu()),
                           0, 1, st, ss, rand)
    with pytest.raises(TypeError, match="dtype"):
        span_cuda.run_span(*args, eng.data, 0, 1, st, dataclasses.replace(
            ss, upd=ss.upd.to(torch.int32)), rand)
    with pytest.raises(ValueError, match="shape"):
        span_cuda.run_span(*args, eng.data, 0, 1, dataclasses.replace(
            st, M_p=st.M_p[:, :-1].contiguous()), ss, rand)
    with pytest.raises(TypeError, match="PhiloxRandom"):
        span_cuda.run_span(*args, eng.data, 0, 1, st, ss, object())


def test_fused_gist_throughput_converges(cuda_device):
    """run_throughput (16 chains of GIST, the fused span) passes the
    meanChiSq gate of bench.py:87-95 (< 2x the golden GIST value)."""
    import cogaps_tpu_torch
    from cogaps_tpu_torch.bench_harness import run_throughput
    z = np.load(f"{DATA}/gist.npz")
    before = span_cuda.run_span.launches
    r = run_throughput(np.asarray(z["D"]), cogaps_tpu_torch.CogapsParams(
        n_patterns=7, n_iterations=2000, seed=42, output_frequency=0),
        n_chains=16, device=cuda_device)
    golden = float(np.asarray(z["golden_meanChiSq"]).reshape(-1)[0])
    assert r["mean_chi_sq"] < 2.0 * golden, r
    assert span_cuda.run_span.launches - before >= 2 * 2000 // 50


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


# ----------------------------------------------------------------------
# the probe kernels (csrc/probe_mosaic.cu F1-F8, csrc/probe_dma.cu F9-F11)
# against their plain versions: F1 and F2 within 1e-5 of the sum of the
# absolute terms, F7's sum within 1e-6 relative, every other result equal
# ----------------------------------------------------------------------
def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(
        np.float32)


def _ints(lo, hi, shape, seed):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def _slot_perm(nch, B, C, seed):
    rs = np.random.default_rng(seed)
    return np.stack([rs.permutation(C)[:B] for _ in range(nch)]).astype(
        np.float32)


def _gather_nan_rows(tbl, idx):
    """gather_rows_plain where idx names a row, else a row of NaN."""
    ok = (idx >= 0) & (idx < tbl.shape[0])
    rows = tbl[torch.where(ok, idx, 0).long()]
    return torch.where(ok[:, None], rows, torch.nan)


def _block_nan_rows(tbl, offset, n):
    return _gather_nan_rows(tbl, (offset + torch.arange(
        n, device=tbl.device)).float())


def _bits_equal(args, k, p):
    return torch.equal(k.view(torch.int32), p.view(torch.int32))


def _probe_cases():
    from cogaps_tpu_torch.probes import dma, mosaic
    from cogaps_tpu_torch.probes.__main__ import within_rel, within_terms
    m, d = mosaic, dma
    bdot_tol, prefix_tol = (within_terms(m.bdot_plain),
                            within_terms(m.prefix_plain))
    odd_rows = np.float32([[-1.0, 0.0, 2.5, 49.0, 50.0, 3.0, 3.0, 0.0]])
    table = np.arange(4096 * 12, dtype=np.float32).reshape(4096, 12)
    return {
        "bdot-3x50x5x40": ((_rand((3, 50, 5), 1), _rand((3, 50, 40), 2)),
                           m.bdot, m.bdot_plain, bdot_tol),
        "bdot-1x16x9x33": ((_rand((1, 16, 9), 31), _rand((1, 16, 33), 32)),
                           m.bdot, m.bdot_plain, bdot_tol),
        "bdot-2x3000x11x70": ((_rand((2, 3000, 11), 3),
                               _rand((2, 3000, 70), 4)),
                              m.bdot, m.bdot_plain, bdot_tol),
        # the regimes' edges: K = 16 (bytes) and 17 (operations), K = 128
        # at T = 1 and 75, B = 9, 33 and 100 (B % 4 != 0 reads b 4 bytes a
        # thread), one chain with its T split, T not a multiple of a chunk
        **{f"bdot-{n}x{T}x{K}x{B}": ((_rand((n, T, K), 40 + K),
                                     _rand((n, T, B), 41 + B)),
                                    m.bdot, m.bdot_plain, bdot_tol)
           for n, T, K, B in ((3, 500, 16, 40), (3, 500, 17, 40),
                              (2, 1, 128, 64), (2, 75, 128, 64),
                              (4, 300, 7, 9), (4, 300, 7, 33),
                              (4, 300, 7, 100), (2, 40, 20, 33),
                              (1, 1363, 7, 256), (1, 1000, 5, 100),
                              (1, 130, 128, 256), (1, 3001, 16, 12))},
        "prefix-3x100": ((_rand((3, 100), 5, 10.0),), m.prefix,
                         m.prefix_plain, prefix_tol),
        "prefix-2x1024": ((_rand((2, 1024), 6),), m.prefix, m.prefix_plain,
                          prefix_tol),
        "first_wins-3x200": ((_ints(0, 20, (3, 200), 7),), m.first_wins,
                             m.first_wins_plain, None),
        "first_wins-1x1024": ((_ints(0, 300, (1, 1024), 8),), m.first_wins,
                              m.first_wins_plain, None),
        "claim_row-3x100": ((_ints(0, 50, (3, 100), 9), 50, "row"),
                            m.claim_min, m.claim_min_plain, None),
        "claim_row-odd": ((odd_rows, 50, "row"), m.claim_min,
                          m.claim_min_plain, None),
        "claim_lane-3x100": ((_ints(-5, 60, (3, 100), 10), 50, "lane"),
                             m.claim_min, m.claim_min_plain, None),
        "claim_lane-odd": ((odd_rows, 50, "lane"), m.claim_min,
                           m.claim_min_plain, None),
        "elem-5x33": ((_rand((5, 33), 11, 3.0),), m.elem_chain,
                      m.elem_chain_plain, None),
        "elem-1000": ((_rand((1000,), 12),), m.elem_chain,
                      m.elem_chain_plain, None),
        "while_count-2x64": ((np.full((2, 64), 2.5, np.float32), "count"),
                             m.while_sum, m.while_sum_plain, None),
        "while_until-2x16": ((_ints(0, 9, (2, 16), 13), "until"),
                             m.while_sum, m.while_sum_plain, None),
        "reduce_sum-2x30x50": ((_rand((2, 30, 50), 14, 5.0), "sum"),
                               m.reduce3d, m.reduce3d_plain,
                               within_rel(1e-6)),
        "reduce_min-3x7x300": ((_rand((3, 7, 300), 15), "min"), m.reduce3d,
                               m.reduce3d_plain, None),
        "uniform-3x100": ((np.int32([5]), 3, 100), m.uniform,
                          m.uniform_plain, None),
        "uniform-2x4096": ((np.int32([-1]), 2, 4096), m.uniform,
                           m.uniform_plain, None),
        "gather_rows-K12": ((table, _ints(0, 4096, (40,), 16)),
                            d.gather_rows, d.gather_rows_plain, None),
        "gather_rows-K50": ((_rand((300, 50), 17), _ints(0, 300, (77,), 18)),
                            d.gather_rows, d.gather_rows_plain, None),
        "gather_block": ((table, np.int32([4000]), 8), d.gather_block,
                         d.gather_block_plain, None),
        # the flat walk: K = 50 (pieces straddle rows), 1 and 3, one row,
        # rows past the table's end (NaN)
        "gather_rows-K1": ((_rand((5000, 1), 42), _ints(0, 5000, (9000,), 43)),
                           d.gather_rows, d.gather_rows_plain, None),
        "gather_rows-K3": ((_rand((700, 3), 44), _ints(0, 700, (1001,), 45)),
                           d.gather_rows, d.gather_rows_plain, None),
        "gather_rows-K50-big": ((_rand((3000, 50), 46),
                                 _ints(0, 3000, (20000,), 47)),
                                d.gather_rows, d.gather_rows_plain, None),
        "gather_rows-B1": ((_rand((300, 50), 48), np.float32([299])),
                           d.gather_rows, d.gather_rows_plain, None),
        "gather_rows-nan": ((_rand((300, 50), 51),
                             np.float32([3, -1, 299, 300, 1e9, 0])),
                            d.gather_rows, _gather_nan_rows, _bits_equal),
        "gather_block-K50": ((_rand((300, 50), 52), np.int32([290]), 20),
                             d.gather_block, _block_nan_rows, _bits_equal),
        "gather_passes-K8": ((np.repeat(np.arange(1000, dtype=np.float32),
                                        8).reshape(1000, 8),
                              _ints(0, 1000, (30,), 19), 5),
                             d.gather_passes, d.gather_passes_plain, None),
        "gather_passes-K128": ((_ints(0, 4096, (4096, 128), 20),
                                _ints(0, 4096, (64,), 21), 3),
                               d.gather_passes, d.gather_passes_plain, None),
        "gather_batched-K16": ((_rand((2, 40, 16), 22),
                                _ints(0, 40, (2, 30), 23)),
                               d.gather_batched, d.gather_batched_plain,
                               None),
        "gather_batched-flat": ((_rand((3, 100, 1), 24),
                                 _ints(0, 100, (3, 64), 25)),
                                d.gather_batched, d.gather_batched_plain,
                                None),
        "scatter-2x30": ((_rand((2, 30), 26), _slot_perm(2, 30, 100, 27),
                          100), d.scatter_slots, d.scatter_slots_plain,
                         None),
        "scatter-3x100": ((_rand((3, 100), 28), _slot_perm(3, 100, 128, 29),
                           128), d.scatter_slots, d.scatter_slots_plain,
                          None),
        "strided-p2a": ((np.arange(256, dtype=np.float32)[None], 7, 1.0,
                         0.0), d.strided_sum, d.strided_sum_plain, None),
        "strided-13x2.5": ((_rand((1, 100), 30), 13, 2.5, -1.0),
                           d.strided_sum, d.strided_sum_plain, None),
    }


PROBE_IDS = ["bdot-3x50x5x40", "bdot-1x16x9x33", "bdot-2x3000x11x70",
             "bdot-3x500x16x40", "bdot-3x500x17x40", "bdot-2x1x128x64",
             "bdot-2x75x128x64", "bdot-4x300x7x9", "bdot-4x300x7x33",
             "bdot-4x300x7x100", "bdot-2x40x20x33", "bdot-1x1363x7x256",
             "bdot-1x1000x5x100", "bdot-1x130x128x256", "bdot-1x3001x16x12",
             "prefix-3x100",
             "prefix-2x1024", "first_wins-3x200", "first_wins-1x1024",
             "claim_row-3x100", "claim_row-odd", "claim_lane-3x100",
             "claim_lane-odd", "elem-5x33", "elem-1000",
             "while_count-2x64", "while_until-2x16", "reduce_sum-2x30x50",
             "reduce_min-3x7x300", "uniform-3x100", "uniform-2x4096",
             "gather_rows-K12", "gather_rows-K50", "gather_block",
             "gather_rows-K1", "gather_rows-K3", "gather_rows-K50-big",
             "gather_rows-B1", "gather_rows-nan",
             "gather_block-K50",
             "gather_passes-K8", "gather_passes-K128", "gather_batched-K16",
             "gather_batched-flat", "scatter-2x30", "scatter-3x100",
             "strided-p2a", "strided-13x2.5"]


@pytest.mark.parametrize("case", PROBE_IDS)
def test_probe_kernel_matches_plain(cuda_device, case):
    args, kernel, plain, tol = _probe_cases()[case]
    args = tuple(torch.as_tensor(a, device=cuda_device)
                 if isinstance(a, np.ndarray) else a for a in args)
    before = kernel.launches
    out_k = kernel(*args)
    assert kernel.launches == before + 1
    out_p = plain(*args)
    torch.cuda.synchronize()
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    for k, p in zip(out_k, out_p):
        assert k.shape == p.shape and k.dtype == p.dtype
        if tol is None:
            assert torch.equal(k, p), (k, p)
        else:
            assert tol(args, k, p), float((k.double() - p.double()).abs()
                                          .max())


def _on(device, *arrays):
    return tuple(torch.as_tensor(x, device=device) for x in arrays)


@pytest.mark.parametrize("shape", [(1, 1363, 7, 256), (16, 2000, 10, 100),
                                   (1, 130, 128, 256), (3, 333, 5, 9)])
def test_bdot_repeats_bit_for_bit(cuda_device, shape):
    """T split, partial sums added in a fixed order: no run-to-run bits."""
    from cogaps_tpu_torch.probes import mosaic
    NCH, T, K, B = shape
    a, b = _on(cuda_device, _rand((NCH, T, K), 60), _rand((NCH, T, B), 61))
    plan = mosaic.bdot_plan(NCH, T, K, B,
                            mosaic.sm_count(cuda_device.index or 0))
    assert plan.splits > 1
    first, second = mosaic.bdot(a, b), mosaic.bdot(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("splits", [1, 2, 7, 64])
@pytest.mark.parametrize("shape", [(2, 700, 9, 36), (2, 700, 9, 35),
                                   (2, 700, 64, 40), (2, 700, 30, 30)])
def test_bdot_any_split_of_t(cuda_device, shape, splits):
    """Each regime, with and without 16-byte loads, at T splits the plan
    would not choose."""
    from cogaps_tpu_torch.probes import mosaic
    from cogaps_tpu_torch.probes.__main__ import within_terms
    NCH, T, K, B = shape
    a, b = _on(cuda_device, _rand((NCH, T, K), 62), _rand((NCH, T, B), 63))
    plan = mosaic.bdot_plan(NCH, T, K, B)
    plan = plan._replace(splits=splits, grid=plan.grid[:2] + (NCH * splits,),
                         scratch=(splits, NCH, K, B) if splits > 1 else None)
    out = mosaic.bdot(a, b, plan)
    assert within_terms(mosaic.bdot_plain)((a, b), out,
                                           mosaic.bdot_plain(a, b))


def test_probe_kernels_take_unaligned_inputs(cuda_device):
    """A table 4 bytes past 16-byte alignment takes F9's 4-byte loads; F1
    copies b to aligned memory for its 16-byte ones."""
    from cogaps_tpu_torch.probes import dma, mosaic
    from cogaps_tpu_torch.probes.__main__ import within_terms
    flat, idx = _on(cuda_device, _rand((300 * 50 + 1,), 49),
                    _ints(0, 300, (77,), 50))
    tbl = flat[1:].view(300, 50)
    assert tbl.data_ptr() % 8 == 4
    assert torch.equal(dma.gather_rows(tbl, idx),
                       dma.gather_rows_plain(tbl, idx))
    flat_b, a = _on(cuda_device, _rand((2 * 50 * 64 + 1,), 64),
                    _rand((2, 50, 7), 65))
    b = flat_b[1:].view(2, 50, 64)
    assert within_terms(mosaic.bdot_plain)((a, b), mosaic.bdot(a, b),
                                           mosaic.bdot_plain(a, b))


def test_probe_wrappers_raise_on_card(cuda_device):
    from cogaps_tpu_torch.probes import dma, mosaic
    a = torch.ones((2, 10, 3), device=cuda_device)
    with pytest.raises(ValueError, match="is on"):
        mosaic.bdot(a, torch.ones((2, 10, 4)))
    with pytest.raises(ValueError, match="at most 1024"):
        mosaic.prefix(torch.ones((2, 2048), device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 4"):
        dma.gather_passes(torch.ones((10, 6), device=cuda_device),
                          torch.zeros(3, device=cuda_device), 2)
    b = torch.ones((2, 10, 8), device=cuda_device)
    bad = mosaic.bdot_plan(2, 10, 3, 8)._replace(tile_b=6)  # 6 % 4 != 0
    with pytest.raises(RuntimeError, match="bdot kernel launch failed"):
        mosaic.bdot(a, b, bad)


def _mod113(nch, B):
    return np.arange(nch * B, dtype=np.float32).reshape(nch, B) % 113.0


def _first_wins_cases():
    edge = np.float32([[np.nan, -0.0, 0.0, np.nan, 1.0, np.inf, -np.inf,
                        np.inf, 1.0, -0.0] * 50])
    return {
        # the probes' shapes and the port's (PERF.md's F3 rows)
        "1x1024-mod113": _mod113(1, 1024), "8x512-mod113": _mod113(8, 512),
        "8x1024-mod113": _mod113(8, 1024),
        "4x256-ints57": _ints(0, 57, (4, 256), 0),
        "16x1024-rows1363": _ints(0, 1363, (16, 1024), 56),
        # -0 equals +0, a NaN equals nothing; one key; all keys distinct;
        # a part warp; one lane
        "nan-zero-inf": edge, "one-key": np.ones((2, 1024), np.float32),
        "distinct": np.arange(1024, dtype=np.float32)[None] * 0.5,
        "3x77": _ints(0, 4, (3, 77), 1), "1x1": np.float32([[2.0]]),
    }


@pytest.mark.parametrize("case", ["1x1024-mod113", "8x512-mod113",
                                  "8x1024-mod113", "4x256-ints57",
                                  "16x1024-rows1363", "nan-zero-inf",
                                  "one-key", "distinct", "3x77", "1x1"])
def test_first_wins_matches_plain(cuda_device, case):
    """F3, a lane's earlier equal lanes counted through a hash table in
    shared memory: exactly the plain version's counts, one launch, and
    the same bits again."""
    from cogaps_tpu_torch.probes import mosaic
    r = torch.as_tensor(_first_wins_cases()[case], device=cuda_device)
    before = mosaic.first_wins.launches
    got, again = mosaic.first_wins(r), mosaic.first_wins(r)
    assert mosaic.first_wins.launches == before + 2
    want = mosaic.first_wins_plain(r)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(again, want)


@pytest.mark.parametrize("shape", [(8, 128, 256), (3, 77, 130), (1, 1, 1),
                                   (5, 300, 4), (16, 2000, 100)])
def test_reduce_sum_matches_plain(cuda_device, shape):
    """F7's sum, the middle axis split over row groups and their float64
    partials added in a fixed order: within 1e-6 of the plain version (16-
    byte loads where L % 4 == 0, 4-byte ones at L = 130 and on an input 4
    bytes past alignment), one launch each, the same bits again."""
    from cogaps_tpu_torch.probes import mosaic
    from cogaps_tpu_torch.probes.__main__ import within_rel
    x = torch.as_tensor(_rand(shape, 70, 4.0), device=cuda_device)
    flat = torch.as_tensor(_rand((x.numel() + 1,), 71, 4.0),
                           device=cuda_device)
    shifted = flat[1:].view(shape)
    for arg in (x, shifted):
        before = mosaic.reduce3d.launches
        got, again = mosaic.reduce3d(arg, "sum"), mosaic.reduce3d(arg, "sum")
        assert mosaic.reduce3d.launches == before + 2
        want = mosaic.reduce3d_plain(arg, "sum")
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, again)
        assert within_rel(1e-6)((arg,), got, want), float(
            (got.double() - want.double()).abs().max())


def test_gwcogaps_on_ranks_sharing_the_card_matches_one(cuda_device,
                                                        tmp_path):
    """GWCoGAPS with its four subset chains on 2 ranks that share the card
    over gloo (distributed.subset_mesh; stats gathered through the host):
    each rank returns the one-process result bit for bit, and each
    stage's launches, summed over the ranks, are twice the one process's
    (each rank runs every iteration of its chains)."""
    import torch_ranks
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.parallel import launch
    [D] = synthetic_dense(2000, 40, 5, 1, 9)
    params = dict(n_patterns=5, n_iterations=60, seed=9, n_sets=4,
                  output_frequency=0)
    out = str(tmp_path / "gw")
    launch.join(launch.start(torch_ranks.distributed_rank, 2, "GWCoGAPS", D,
                             params, out, "cuda"), timeout=300)
    one = torch_ranks.distributed_run("GWCoGAPS", D, params, "cuda")
    assert one["launches"].sum() > 0
    for rank in range(2):
        with np.load(f"{out}.rank{rank}.npz") as z:
            for k, v in one.items():
                want = 2 * v if k == "launches" else v
                np.testing.assert_array_equal(z[k], want, err_msg=k)


@pytest.mark.parametrize("fixed,direct,every", [
    (False, False, 0), (True, False, 0), (True, True, 0), (False, True, 10)],
    ids=["free", "fixed-P", "fixed-P-engine", "free-chi2-engine"])
def test_subset_chain_bits_do_not_follow_the_chains_beside_it(cuda_device,
                                                              fixed, direct,
                                                              every):
    """GWCoGAPS's stages at 2000 x 40, k=5, four 500-gene subset chains:
    the free stage on the fused span (K3), the fixed one on the per-call
    route (K1 and the tables kernel). Each chain run alone or two at a
    time (a rank's share of the chain mesh) gives the bits it gets beside
    the other three, through distributed.subset_engine and through a
    MultichainEngine(..., mesh=ProcessMesh(...)) made directly, on the
    fixed stage and on the free stage with a chi^2 history (per-call, both
    samplers). Batched cuBLAS table products rounded a chain's tables
    otherwise when it ran alone; csrc/tables.cu sums each chain in an
    order of its shape alone. The per-call runs launch the tables kernel
    exactly once a sampled factor an iteration."""
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
    from cogaps_tpu_torch.ops import tables_cuda
    from cogaps_tpu_torch.params import CogapsParams
    from cogaps_tpu_torch.parallel import distributed, multihost
    from cogaps_tpu_torch.parallel.multichain import (MultichainEngine,
                                                      stack_device_data)
    [D] = synthetic_dense(2000, 40, 5, 1, 9)
    subDs = [D[i::4] for i in range(4)]
    consensus = (np.random.default_rng(0).gamma(2.0, 1.0, (40, 5))
                 .astype(np.float32) if fixed else None)
    p = distributed._stage_params(CogapsParams(
        n_patterns=5, n_iterations=60, seed=9, output_frequency=every),
        True, consensus)
    cfg = p.engine_config(500, 40)
    per_call = fixed or every > 0

    def run(mesh):
        data = stack_device_data(subDs, None, cfg, "cpu")
        eng = (MultichainEngine(data, cfg, cuda_device, mesh=mesh) if direct
               else distributed.subset_engine(data, cfg, cuda_device, mesh))
        assert eng._fused_ok() is not per_call
        st, ss = eng.init_state(consensus), eng.init_stats()
        rand = PhiloxRandom([9] * eng.n_chains, cuda_device)
        before = tables_cuda.dense_tables.launches
        for phase in (EQUILIBRATION, SAMPLING):
            st, ss = eng.run_phase(st, ss, rand, phase)
        launched = tables_cuda.dense_tables.launches - before
        assert launched == (2 * 60 * (1 if fixed else 2) if per_call else 0)
        return st, ss

    st4, ss4 = run(None)
    for size in (4, 2):
        for r in range(size):
            st, ss = run(multihost.ProcessMesh("chains", None, size, r,
                                               "none"))
            held = slice(r * 4 // size, (r + 1) * 4 // size)
            for name, x, y in (("M_a", st.M_a, st4.M_a[held]),
                               ("M_p", st.M_p, st4.M_p[held]),
                               ("a_sum", ss.a_sum, ss4.a_sum[held]),
                               ("a_sumsq", ss.a_sumsq, ss4.a_sumsq[held]),
                               ("p_sum", ss.p_sum, ss4.p_sum[held]),
                               ("chisq", ss.chisq_hist,
                                ss4.chisq_hist[held]),
                               ("upd", ss.upd, ss4.upd[held])):
                assert torch.equal(x, y), (size, r, name,
                                           int((x != y).sum()))


def _tables_case(device, R, m, k, nch, seed):
    """float32 inputs of nch chains of one sampler's tables: D with zeros
    and a few large entries, invS2 = 0 on the last rows (a padded subset),
    M sparse, the partner factor with an empty last column."""
    rs = np.random.default_rng(seed)
    D = rs.gamma(2.0, 2.0, (nch, R, m)).astype(np.float32)
    D[rs.random(D.shape) < 0.2] = 0.0
    D[rs.random(D.shape) < 0.001] *= 1000.0
    inv = (1.0 / np.maximum(0.1 * D, 0.1) ** 2).astype(np.float32)
    inv[:, -max(1, R // 10):, :] = 0.0
    M = rs.gamma(1.0, 1.0, (nch, R, k)).astype(np.float32)
    M[rs.random(M.shape) < 0.3] = 0.0
    O = rs.gamma(2.0, 1.0, (nch, m, k)).astype(np.float32)
    O[:, :, -1] = 0.0
    return [torch.as_tensor(x, device=device) for x in (D, inv, M, O)]


def _tables_terms(D, inv, M, O):
    """Each table entry's sum of |terms| in float64: Y's of (|D| + |M|
    |O|^T) invS2 |O| (Y cancels), SQ's and Z's of invS2 |O_c O_c'|."""
    D, inv, M, O = (x.double().abs() for x in (D, inv, M, O))
    k = O.shape[-1]
    Y = ((D + M @ O.transpose(-1, -2)) * inv) @ O
    OO = (O.unsqueeze(-1) * O.unsqueeze(-2)).flatten(-2)
    Z = (inv @ OO).reshape(inv.shape[:-2] + (inv.shape[-2] * k, k))
    return Y, inv @ (O * O), Z


def _tables_errors(got, exact, terms):
    """The largest |table - exact| / terms over Y, SQ and Z, and whether
    every entry is within 1e-5 of its terms."""
    worst, ok = 0.0, True
    for x, e, t in zip(got, exact, terms):
        d = (x.double() - e.double()).abs()
        ok = ok and bool((d <= 1e-5 * t).all())
        pos = t > 0
        if pos.any():
            worst = max(worst, float((d[pos] / t[pos]).max()))
        ok = ok and bool((d[~pos] == 0).all())
    return worst, ok


TABLES_SHAPES = {  # (R, m, k, nch, the plan's form)
    "gist-A-x1": (1363, 9, 7, 1, "rows"),
    "gist-P-x1": (9, 1363, 7, 1, "short"),
    "gist-A-x16": (1363, 9, 7, 16, "rows"),
    "gist-P-x16": (9, 1363, 7, 16, "short"),
    "subsets-A": (500, 40, 5, 4, "rows"), "subsets-P": (40, 500, 5, 4, "mma"),
    "5000x2000-A": (5000, 2000, 10, 4, "mma"),
    "5000x2000-P": (2000, 5000, 10, 4, "mma"),
    "20000x100-P-x2": (100, 20000, 10, 2, "mma"),
    "k1": (300, 777, 1, 3, "mma"), "k12-split": (200, 3000, 12, 2, "mma"),
    "k13": (500, 700, 13, 2, "mma"), "k25": (300, 777, 25, 2, "mma"),
    "k50": (40, 300, 50, 2, "mma"), "m1": (50, 1, 3, 2, "rows"),
    "k25-m30": (300, 30, 25, 2, "simt"),
    "k20-short-split": (17, 999, 20, 3, "short"),
    "5000x2000-A-k20": (5000, 2000, 20, 4, "mma"),
    "k64-split": (100, 3000, 64, 2, "mma"),
    "k80": (300, 777, 80, 2, "mma"),
    "k150-y-two-tiles": (300, 400, 150, 2, "mma"),
    "one-row": (1, 4000, 10, 3, "rows"),
    "modsim-A": (25, 20, 3, 1, "rows"), "modsim-P": (20, 25, 3, 1, "rows"),
    "short-R17-split": (17, 999, 6, 3, "short"),
    "m64": (70, 64, 4, 2, "mma"),
    "subsets-5005-P": (100, 5005, 10, 2, "mma"),
    # below MMA_MIN_M partners above k = 12: simt_tiles_kernel, whole
    # rows of Z or (k50-m30, k128-m63) bands of them
    "20000x40-A-k20": (20000, 40, 20, 1, "simt"),
    "20000x40-A-k39": (20000, 40, 39, 1, "simt"),
    "gist-A-k13-x2": (1363, 9, 13, 2, "simt"),
    "k20-m37": (1001, 37, 20, 2, "simt"),
    "k20-one-row": (1, 40, 20, 3, "simt"),
    "k50-m30": (40, 30, 50, 2, "simt"),
    "k128-m63": (300, 63, 128, 1, "simt")}
SIMT_SHAPES = [name for name, s in TABLES_SHAPES.items() if s[4] == "simt"]


@pytest.mark.parametrize("shape", list(TABLES_SHAPES.values()),
                         ids=list(TABLES_SHAPES))
def test_dense_tables_kernel_matches_plain(cuda_device, shape):
    """dense.tables on the card (the tables kernel, one launch, in the
    plan's form: mma_kernel's tensor-core and short-row forms, some with
    splits, in column tiles above k = 12, on a ring of two stages at k80
    and with Y's columns over two tiles at k150, rows_kernel,
    simt_tiles_kernel below 64 partners above k = 12)
    against exact_tables (float64 sums
    rounded once): every entry of Y, SQ and Z within 1e-5 of its summed
    |terms|, no worse than twice the plain cuBLAS tables' own worst error
    on the same inputs (m > 1), col_nz equal, SQ Z's diagonal and Z
    symmetric; the same bits again."""
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    R, m, k, nch, form = shape
    plan = tables_cuda.tables_plan(R, m, k, cuda_build.sm_count(
        cuda_device.index or 0))
    assert plan.form == form
    args = _tables_case(cuda_device, R, m, k, nch, seed=R + m + k)
    before = tables_cuda.dense_tables.launches
    cache, phase = dense.tables(*args)
    assert tables_cuda.dense_tables.launches == before + 1
    again_c, again_p = dense.tables(*args)
    pc, pp = dense.tables_plain(*args)
    ec, ep = dense.exact_tables(*args)
    terms = _tables_terms(*args)
    torch.cuda.synchronize()
    got = (cache.Y, phase.SQ, phase.Z)
    err_k, ok = _tables_errors(got, (ec.Y, ep.SQ, ep.Z), terms)
    err_p, _ = _tables_errors((pc.Y, pp.SQ, pp.Z), (ec.Y, ep.SQ, ep.Z), terms)
    assert ok, (err_k, err_p)
    if m > 1:
        assert err_k <= 2 * err_p, (err_k, err_p)
    assert torch.equal(phase.col_nz, ep.col_nz)
    assert not phase.col_nz[..., -1].any()
    Z4 = phase.Z.reshape(nch, R, k, k)
    assert torch.equal(Z4, Z4.transpose(-1, -2))
    assert torch.equal(phase.SQ, torch.diagonal(Z4, dim1=-2, dim2=-1))
    for x, y in zip(got + (phase.col_nz,),
                    (again_c.Y, again_p.SQ, again_p.Z, again_p.col_nz)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", SIMT_SHAPES)
def test_simt_tables_bits_equal_quads(cuda_device, name):
    """simt_tiles_kernel gives quads_kernel's bits (forced by
    tables_cuda.cuda_core_plan) on the same inputs at every shape of
    TABLES_SHAPES it takes: Y, SQ, Z and col_nz equal, each entry one
    fmaf chain over the partners in order in both; and the same bits
    again on a second call; one launch each."""
    from cogaps_tpu_torch.ops import cuda_build, tables_cuda
    R, m, k, nch, _ = TABLES_SHAPES[name]
    n_sm = cuda_build.sm_count(cuda_device.index or 0)
    quads = tables_cuda.cuda_core_plan(R, m, k, n_sm)
    assert quads.form == "quads" and quads.S == 1
    assert tables_cuda.tables_plan(R, m, k, n_sm).form == "simt"
    args = _tables_case(cuda_device, R, m, k, nch, seed=R + m + k)
    before = tables_cuda.dense_tables.launches
    got = tables_cuda.dense_tables(*args)
    again = tables_cuda.dense_tables(*args)
    want = tables_cuda.dense_tables(*args, plan=quads)
    assert tables_cuda.dense_tables.launches == before + 3
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("shape", [(500, 40, 5), (40, 500, 5),
                                   (100, 20000, 10), (1363, 9, 7),
                                   (9, 1363, 7), (25, 20, 3),
                                   (300, 777, 13), (300, 777, 20),
                                   (300, 777, 40), (300, 30, 25),
                                   (300, 777, 100), (300, 400, 150)],
                         ids=["subsets-A", "subsets-P", "20000x100-P",
                              "gist-A", "gist-P", "modsim-A", "k13", "k20",
                              "k40", "k25-m30", "k100", "k150"])
def test_tables_kernel_bits_do_not_follow_the_chain_count(cuda_device,
                                                          shape):
    """A chain's tables are the same bits alone, as one of 4 and as one of
    16 (first, middle and last index), as a slice of the 16 (a view at
    its offset in them), and with a partner factor shared by every chain
    (a leading dimension of one): in each form of the plan (the
    tensor-core form, with splits at subsets-P and 20000x100-P; the
    short-row form, with splits at gist-P; rows_kernel at subsets-A,
    gist-A and modsim-A; the column tiles at k13 and at k20, with
    splits, tiles of 128 columns at k40, on a ring of two stages at k100
    and k150, Y's columns over two tiles at k150; simt_tiles_kernel at
    k25-m30)."""
    R, m, k = shape
    D, inv, M, O = _tables_case(cuda_device, R, m, k, 16, seed=7)

    def tables_of(idx, shared=False):
        other = O[:1] if shared else O[idx]
        cache, phase = dense.tables(D[idx], inv[idx], M[idx], other)
        return cache.Y, phase.SQ, phase.Z, phase.col_nz

    every = tables_of(list(range(16)))
    shared = tables_of(list(range(16)), shared=True)
    for c in (0, 7, 15):
        four = [c] + [x for x in range(16) if x != c][:3]
        for pos in (0, 2, 3):
            group = four[1:pos + 1] + [c] + four[pos + 1:]
            got = tables_of(group)
            for x, y in zip(got, every):
                assert torch.equal(x[pos], y[c]), (c, pos)
        for x, y in zip(tables_of([c]), every):
            assert torch.equal(x[0], y[c]), c
        for x, y in zip(tables_of(slice(c, c + 1)), every):
            assert torch.equal(x[0], y[c]), c
    alone = tables_of([0], shared=True)
    for x, y in zip(alone, shared):
        assert torch.equal(x[0], y[0])


@pytest.mark.parametrize("shape", [(500, 40, 5), (1363, 9, 7),
                                   (2000, 100, 10)],
                         ids=["subsets", "gist", "2000x100"])
def test_chisq_bits_do_not_follow_the_chain_count(cuda_device, shape):
    """A chain's chi^2 (dense.chisq_from_state) is the same bits alone, as
    one of 4 and as one of 16, and with the data shared by every chain."""
    R, m, k = shape
    D, inv, M_a, _ = _tables_case(cuda_device, R, m, k, 16, seed=11)
    M_p = _tables_case(cuda_device, m, 1, k, 16, seed=12)[2]
    every = dense.chisq_from_state(D, inv, M_a, M_p)
    shared = dense.chisq_from_state(D[0], inv[0], M_a, M_p)
    for c in (0, 7, 15):
        group = [c] + [x for x in range(16) if x != c][:3]
        four = dense.chisq_from_state(D[group], inv[group], M_a[group],
                                      M_p[group])
        assert torch.equal(four[0], every[c]), c
        alone = dense.chisq_from_state(D[c], inv[c], M_a[c], M_p[c])
        assert torch.equal(alone, every[c]), c
        assert torch.equal(shared[c], dense.chisq_from_state(
            D[0], inv[0], M_a[c], M_p[c])), c


def test_tables_kernel_checks_inputs(cuda_device):
    from cogaps_tpu_torch.ops import tables_cuda
    D, inv, M, O = _tables_case(cuda_device, 30, 20, 4, 2, seed=1)
    with pytest.raises(ValueError, match="no tables"):
        dense.tables(D.double(), inv.double(), M.double(), O.double())
    with pytest.raises(ValueError, match="no tables"):
        dense.tables(D, inv, M, O.cpu())
    with pytest.raises(ValueError, match="shape"):
        tables_cuda.dense_tables(D, inv, M[:, :10], O)
    with pytest.raises(ValueError, match="contiguous"):
        tables_cuda.dense_tables(D.transpose(1, 2).contiguous().transpose(
            1, 2), inv, M, O)
    with pytest.raises(ValueError, match="leading shape"):
        tables_cuda.dense_tables(D, inv, M, torch.cat([O, O]))


@pytest.mark.parametrize("NR", [1, 50, 1363])
@pytest.mark.parametrize("B", [1, 100, 1024])
def test_claim_rows_split_over_blocks_is_exact(cuda_device, NR, B):
    """F4's row form, each chain's rows split over blocks that claim in
    shared memory: exactly the plain version's table, with NaN, negative,
    fractional and out-of-range values among the lanes, at 1, 3 and 16
    chains; the lane form too."""
    from cogaps_tpu_torch.probes import mosaic
    for nch in (1, 3, 16):
        rs = np.random.default_rng(NR * B + nch)
        r = rs.integers(0, NR, (nch, B)).astype(np.float32)
        junk = rs.random((nch, B))
        r[junk < 0.05] = np.nan
        r[(junk >= 0.05) & (junk < 0.1)] = NR + 3.0
        r[(junk >= 0.1) & (junk < 0.13)] = -1.0
        r[(junk >= 0.13) & (junk < 0.15)] = 0.5
        x = torch.as_tensor(r, device=cuda_device)
        for form in ("row", "lane"):
            before = mosaic.claim_min.launches
            got = mosaic.claim_min(x, NR, form)
            assert mosaic.claim_min.launches == before + 1
            want = mosaic.claim_min_plain(x, NR, form)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), (
                nch, form)


@pytest.mark.parametrize("n", [1, 16, 80])
def test_dependent_loads_match_plain(cuda_device, n):
    """The dependent-load floor's chain equals its plain version."""
    from cogaps_tpu_torch.probes import dma
    nb, K = 1 << 16, 8
    tbl = torch.arange(nb, dtype=torch.float32, device=cuda_device)[:, None]
    tbl = tbl.expand(nb, K).contiguous()
    idx = torch.tensor([12345.0, 7.0], device=cuda_device)
    before = dma.dependent_loads.launches
    got = dma.dependent_loads(tbl, idx, n)
    assert dma.dependent_loads.launches == before + 1
    assert torch.equal(got, dma.dependent_loads_plain(tbl, idx, n))


def test_gwcogaps_nccl_ranks_on_their_own_cards_match_one(cuda_device,
                                                          tmp_path):
    """With a card a rank (NCCL; each rank on cuda:<rank>): GWCoGAPS's
    subset chains on 2 or 4 ranks give the one-process result bit for
    bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a card a rank: two cards or more")
    import torch_ranks
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.parallel import launch
    n = 4 if torch.cuda.device_count() >= 4 else 2
    [D] = synthetic_dense(2000, 40, 5, 1, 9)
    params = dict(n_patterns=5, n_iterations=60, seed=9, n_sets=4,
                  output_frequency=0)
    out = str(tmp_path / "gw")
    launch.join(launch.start(torch_ranks.distributed_rank, n, "GWCoGAPS", D,
                             params, out, "cuda", backend="nccl"),
                timeout=300)
    one = torch_ranks.distributed_run("GWCoGAPS", D, params, "cuda")
    for rank in range(n):
        with np.load(f"{out}.rank{rank}.npz") as z:
            for k in ("Amean", "Asd", "Pmean", "Psd", "meanChiSq",
                      "consensus", "updates"):
                np.testing.assert_array_equal(z[k], one[k], err_msg=k)


def test_chains_of_one_seed_draw_alike(cuda_device):
    """Fast mode's counters hold no chain index: two chains of one seed
    and one state decide alike, and as a one-chain launch of that seed
    does (engine.PhiloxRandom)."""
    atoms, M, Y, phase, consts, mass = make_states(cuda_device, 1363, 9, 7,
                                                   1024, 8192, nch=1)

    def stacked(x, n):
        return x.expand((n,) + tuple(x.shape[1:])).contiguous()

    import dataclasses
    two = [dataclasses.replace(atoms, **{f: stacked(getattr(atoms, f), 2)
                                         for f in ("mass", "elem", "n")}),
           stacked(M, 2), stacked(Y, 2),
           dense.DensePhase(*(stacked(x, 2) for x in phase))]
    mass2 = sweep.MassParams(*(stacked(x, 2) for x in mass))
    budgets = torch.full((2,), 3000, dtype=torch.int32, device=cuda_device)
    out2 = sweep_cuda.run_updates_multi(
        *two, 1.0, budgets, consts, mass2,
        sweep_cuda.PhiloxKey(key0=torch.tensor([21, 21], device=cuda_device),
                             key1=9))
    out1 = sweep_cuda.run_updates_multi(
        atoms, M, Y, phase, 1.0, budgets[:1], consts, mass,
        sweep_cuda.PhiloxKey(key0=torch.tensor([21], device=cuda_device),
                             key1=9))
    for c in range(2):
        assert torch.equal(out2[0].elem[c], out1[0].elem[0])
        assert torch.equal(out2[1][c], out1[1][0])
        assert int(out2[3][c]) == int(out1[3][0]) == 3000


def test_fused_resume_mid_chunk_equals_unbroken(cuda_device, tmp_path):
    """MultichainEngine.run_phase on the fused span, broken off at an
    iteration inside a span_cuda.CHUNK and resumed from a checkpoint in a
    new PhiloxRandom, gives the bits of the run without a break."""
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING, PhiloxRandom
    from cogaps_tpu_torch.utils import checkpoint as ckpt
    eng, st, ss, seeds = span_case(cuda_device, n_warm=20)
    assert eng._fused_ok()
    rand = PhiloxRandom(seeds, cuda_device)
    whole = eng.run_phase(st, ss, rand, EQUILIBRATION, 20)
    whole = eng.run_phase(*whole, rand, SAMPLING, 0, 30)
    part = eng.run_phase(st, ss, PhiloxRandom(seeds, cuda_device),
                         EQUILIBRATION, 20, 33)
    path = str(tmp_path / "fused.npz")
    ckpt.save_checkpoint(path, eng, *part, EQUILIBRATION, 33, seeds)
    st2, ss2, phase, it = ckpt.load_checkpoint(path, eng)
    rand2 = PhiloxRandom(ckpt.checkpoint_seeds(path), cuda_device)
    again = eng.run_phase(st2, ss2, rand2, phase, it)
    again = eng.run_phase(*again, rand2, SAMPLING, 0, 30)
    for x, y in ((whole[0].M_a, again[0].M_a), (whole[0].M_p, again[0].M_p),
                 (whole[0].atoms_a.elem, again[0].atoms_a.elem),
                 (whole[1].a_sum, again[1].a_sum),
                 (whole[1].upd, again[1].upd)):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------
# the command line and the native parser on the card's machine
# ----------------------------------------------------------------------
def test_cli_runs_on_the_card_by_default(cuda_device, tmp_path, capsys):
    """``python -m cogaps_tpu_torch`` without --device runs on the card:
    the dense sweep kernel (K1) launches and the result's
    diagnostics["device"] is CUDA, in the npz and the CSV meta file."""
    import json
    from cogaps_tpu_torch import __main__ as cli
    from cogaps_tpu_torch.result import CogapsResult
    prefix = str(tmp_path / "gist")
    sweep_cuda.run_updates_multi.launches = 0
    assert cli.main([os.path.join(DATA, "GIST.csv"), "-o", prefix,
                     "--n-patterns", "7", "--n-iterations", "100",
                     "--output-frequency", "50", "--seed", "3", "--csv",
                     "--quiet"]) == 0
    launches = sweep_cuda.run_updates_multi.launches
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(summary["meanChiSq"]) and summary["totalUpdates"] > 0
    assert launches >= 2 * 2 * 100
    for res in (CogapsResult.load(prefix + ".npz"),
                CogapsResult.from_csv(prefix)):
        assert res.diagnostics["device"].startswith("cuda")
        assert res.get_param("n_patterns") == 7


def test_native_parser_builds_on_the_cards_host(cuda_device):
    """The native parser (native/fastparse.cpp) builds with the host's
    C++ compiler into cogaps_tpu_torch/_build/ and reads GIST as the
    Python parsers do, bit for bit."""
    from cogaps_tpu_torch.io import native, parsers
    assert native.available(), native.failure()
    assert native.library_path().parent == native.BUILD_DIR
    for ext in ("csv", "tsv", "gct", "mtx"):
        path = os.path.join(DATA, f"GIST.{ext}")
        a = parsers.read_matrix(path)
        b = parsers.read_matrix(path, use_native=False)
        assert np.array_equal(a[0], b[0]) and a[0].shape == (1363, 9)
        assert a[1:] == b[1:]


# ----------------------------------------------------------------------
# the gene-sharded engines (parallel/sharded.py, sparse_sharded.py)
# ----------------------------------------------------------------------
def _assert_states_match(got, want, what):
    for side in ("atoms_a", "atoms_p"):
        a, b = getattr(got, side), getattr(want, side)
        assert torch.equal(a.elem, b.elem) and torch.equal(a.n, b.n), (
            what, side)
        torch.testing.assert_close(a.mass, b.mass, rtol=1e-5, atol=1e-5)
    for name in ("M_a", "M_p"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-5, atol=1e-5)


def test_sharded_dense_iterations_match_plain(cuda_device, monkeypatch):
    """Three iterations of ShardedGapsEngine (8 blocks of a 2000 x 100
    matrix, k=10) from a state after 20: K1 for the blocks and for the
    replicated P, against the same iterations on the plain version."""
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.params import CogapsParams
    from cogaps_tpu_torch.parallel import sharded
    [D] = synthetic_dense(2000, 100, 10, 1, 4)
    cfg = CogapsParams(n_patterns=10, n_iterations=40, seed=4,
                       output_frequency=1).engine_config(*D.shape)
    eng = sharded.ShardedGapsEngine(D, None, cfg, n_blocks=8,
                                    device=cuda_device)
    rand = sharded.ShardedRandom(4, cuda_device)
    st, ss = eng.run_phase(eng.init_state(), eng.init_stats(), rand, 0, 0,
                           20)
    before = sweep_cuda.run_updates_multi.launches
    kst, kss = eng.run_phase(st, ss, rand, 0, 20, 23)
    assert sweep_cuda.run_updates_multi.launches - before == 6
    monkeypatch.setattr(sharded, "run_updates_multi",
                        sweep_cuda.run_updates_multi_plain)
    pst, pss = eng.run_phase(st, ss, rand, 0, 20, 23)
    _assert_states_match(kst, pst, "dense sharded")
    assert torch.equal(kss.upd, pss.upd)
    assert torch.equal(kss.prop_counts, pss.prop_counts)
    torch.testing.assert_close(kss.chisq_hist, pss.chisq_hist, rtol=1e-5,
                               atol=0)


def test_sparse_sharded_p_sampler_matches_plain(cuda_device):
    """The sparse sharded engine's P sampler: one K2 launch on the tables
    summed over 4 shards (2000 x 10000, k=10), against its plain version
    on the same tables."""
    from cogaps_tpu_torch.bench_harness import synthetic_sparse
    from cogaps_tpu_torch.engine import SAMPLER_P
    from cogaps_tpu_torch.io.coo import CooMatrix
    from cogaps_tpu_torch.params import CogapsParams
    from cogaps_tpu_torch.parallel import sharded, sparse_sharded
    [D] = synthetic_sparse(2000, 10000, 10, 1, 6)
    r, c = np.nonzero(D)
    coo = CooMatrix(r.astype(np.int32), c.astype(np.int32), D[r, c], D.shape)
    cfg = CogapsParams(n_patterns=10, n_iterations=20,
                       seed=6).engine_config(*D.shape)
    eng = sparse_sharded.SparseShardedEngine(coo, cfg, n_shards=4,
                                             device=cuda_device)
    rand = sharded.ShardedRandom(6, cuda_device)
    st, _ = eng.run_phase(eng.init_state(), eng.init_stats(), rand, 0, 0, 10)
    Y0, phase = eng.p_tables(st.M_a, st.M_p)
    n_p = torch.full((1,), 400, dtype=torch.int32, device=cuda_device)
    args = (st.atoms_p, st.M_p, Y0, phase, 1.0, n_p, eng.consts_p,
            eng.mass_p, rand.sweeps(1, 0, SAMPLER_P))
    out_k = sweep_cuda.run_updates_multi(*args)
    out_p = sweep_cuda.run_updates_multi_plain(*args)
    for i in (3, 4):  # done, sweeps
        assert torch.equal(out_k[i], out_p[i])
    assert torch.equal(out_k[5].processed, out_p[5].processed)
    assert torch.equal(out_k[0].elem, out_p[0].elem)
    torch.testing.assert_close(out_k[0].mass, out_p[0].mass, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out_k[1], out_p[1], rtol=1e-5, atol=1e-5)


def test_two_ranks_sharing_the_card_match_one(cuda_device, tmp_path):
    """The dense sharded engine on 2 ranks that share the card over gloo
    (tensors on the card, collectives staged through the host): the bits
    of the one-process run."""
    import torch_ranks
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.parallel import launch
    [D] = synthetic_dense(2000, 100, 10, 1, 5)
    params = dict(n_patterns=10, n_iterations=10, seed=5, output_frequency=2)
    kw = {"n_blocks": 8}
    launch.join(launch.start(torch_ranks.rank_run, 2, "dense", D, params,
                             kw, str(tmp_path / "two"), None, None, "cuda"),
                timeout=300)
    torch_ranks.run("dense", D, params, kw, str(tmp_path / "one"),
                    device="cuda")
    torch_ranks.assert_same_bits(
        torch_ranks.result("dense", str(tmp_path / "two")),
        torch_ranks.result("dense", str(tmp_path / "one")), "2 ranks")


def test_nccl_ranks_on_their_own_cards_match_one(cuda_device, tmp_path):
    """With a card a rank the default backend is NCCL (collectives on the
    cards, no host staging): the dense sharded engine on 2 or 4 ranks,
    each on its own card, gives the bits of one process on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a card a rank: two cards or more")
    import torch_ranks
    from cogaps_tpu_torch.bench_harness import synthetic_dense
    from cogaps_tpu_torch.parallel import launch, multihost
    n = 4 if torch.cuda.device_count() >= 4 else 2
    assert multihost.default_backend(n) == "nccl"
    [D] = synthetic_dense(2000, 100, 10, 1, 5)
    params = dict(n_patterns=10, n_iterations=10, seed=5, output_frequency=2)
    kw = {"n_blocks": 8}
    launch.join(launch.start(torch_ranks.rank_run, n, "dense", D, params,
                             kw, str(tmp_path / "ranks"), None, None, "cuda",
                             backend="nccl"), timeout=300)
    torch_ranks.run("dense", D, params, kw, str(tmp_path / "one"),
                    device="cuda")
    torch_ranks.assert_same_bits(
        torch_ranks.result("dense", str(tmp_path / "ranks")),
        torch_ranks.result("dense", str(tmp_path / "one")), f"{n} ranks")
