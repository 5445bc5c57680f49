"""The CSR sweep kernel's decomposition (csrc/atlas.cu) on the CPU.

The kernel cuts each kept lane's row passes into work items of at most
CHUNK nonzeros (part (a)), sums each item over every SM (part (b)) and
adds a lane's items in chunk order before the closed forms (part (c)).
Its plain versions here are ops/atlas_cuda.work_items_plain (the
schedule) and alpha_chunked_plain / chunked_model (the chunked
alphaParameters). They are held to:
  * the schedule: every nonzero of every kept row pass exactly once, in
    CSR order, in the kernel's item order;
  * the alphaParameters of models/sparse.make_model, the port's and the
    JAX package's, on the same inputs (numpy seeds), by close_to_scale
    (tests/test_torch_sparse.py): each value within 1e-5 of the largest
    magnitude of its batch, since a sum with cancellation rounds to the
    scale of what it sums, not to its own;
  * the sweep: ops/sweep.run_updates with chunked_model makes the same
    decisions as with make_model on the same uniforms (equal done,
    sweeps, counts and elem), mass and M within the atlas per-call
    contract (atol 5e-3, rtol 1e-4; tests/test_atlas_engine.py:218-227).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu.models import sparse as jsparse
from cogaps_tpu.ops.sweep import AddrBatch as JAddr
from cogaps_tpu_torch.models import sparse
from cogaps_tpu_torch.ops import atlas_cuda, rng, sweep
from cogaps_tpu_torch.ops.atoms import AtomTable, total_mass_per_element
from test_torch_atlas import toy_coo
from test_torch_sparse import close_to_scale

torch.set_num_threads(1)


def skewed_csr(seed=0, G=12, S=3000, long_row=4, empty_row=7):
    """G rows of ~3% density over S columns, one row of ~85%, one empty."""
    rs = np.random.default_rng(seed)
    D = rs.gamma(2.0, 1.0, (G, S)) * (rs.random((G, S)) < 0.03)
    D[long_row] = rs.gamma(2.0, 1.0, S) * (rs.random(S) < 0.85)
    D[empty_row] = 0.0
    D = D.astype(np.float32)
    r, c = np.nonzero(D)
    return D, sparse.coo_to_csr(r, c, D[r, c], G)


def two_chain_csr():
    """Two chains of different data over the same 12 rows."""
    D0, _ = skewed_csr(1)
    D1, _ = skewed_csr(2, long_row=9, empty_row=0)
    coos = [(np.nonzero(D)[0], np.nonzero(D)[1], D[np.nonzero(D)])
            for D in (D0, D1)]
    return sparse.stack_csr(coos, 12)


def schedule_lanes():
    """(NCH=2, B=16) lanes: same-row pairs, pairs on two rows, singles
    (r2 = -1), lanes not kept (r1 = -1), the long and the empty rows; the
    second chain keeps only its first 6 lanes (a smaller budget)."""
    r1 = torch.tensor([[4, 7, 4, 1, 2, -1, 3, 7, 5, 6, -1, 8, 9, 10, 11, 0],
                       [9, 0, 9, 2, 0, 5, -1, -1, -1, -1, -1, -1, -1, -1,
                        -1, -1]])
    r2 = torch.tensor([[4, 7, 1, -1, 3, 5, 4, -1, 5, 7, 2, -1, 9, 11, -1, 4],
                       [9, 0, 3, -1, 9, -1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]])
    return r1, r2


@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
def test_work_items_cover_each_nonzero_once(chunk):
    csr = two_chain_csr()
    r1, r2 = schedule_lanes()
    items, first, count = atlas_cuda.work_items_plain(csr.indptr, r1, r2,
                                                      chunk)
    ptr = csr.indptr
    assert (items[:, 4] - items[:, 3] <= chunk).all()
    assert (items[:, 4] >= items[:, 3]).all()
    # the kernel's order: chain by chain, lane by lane
    order = items[:, 0] * 100 + items[:, 1]
    assert (order[1:] >= order[:-1]).all()
    for c in range(2):
        own = items[items[:, 0] == c]
        assert int(count[c].sum()) == len(own)
        for lane in range(16):
            mine = own[int(first[c, lane]):int(first[c, lane] + count[c,
                                                                      lane])]
            assert (mine[:, 1] == lane).all()
            passes = []
            if r1[c, lane] >= 0:
                passes.append(int(r1[c, lane]))
                if r2[c, lane] >= 0 and r2[c, lane] != r1[c, lane]:
                    passes.append(int(r2[c, lane]))
            assert int(count[c, lane]) == sum(
                max(1, -(-int(ptr[c, r + 1] - ptr[c, r]) // chunk))
                for r in passes)
            at = 0
            for r in passes:  # r1's chunks, then r2's, each in CSR order
                n = max(1, -(-int(ptr[c, r + 1] - ptr[c, r]) // chunk))
                got = mine[at:at + n]
                assert (got[:, 2] == r).all()
                covered = torch.cat([torch.arange(int(s), int(e))
                                     for s, e in got[:, 3:5]])
                assert torch.equal(covered,
                                   torch.arange(int(ptr[c, r]),
                                                int(ptr[c, r + 1])))
                at += n
    # the empty rows give one empty item; the long row many
    empty = items[(items[:, 0] == 0) & (items[:, 2] == 7)]
    assert len(empty) == 3 and (empty[:, 3] == empty[:, 4]).all()
    long_len = int(ptr[0, 5] - ptr[0, 4])
    assert long_len > 2000
    assert int(count[0, 0]) == max(1, -(-long_len // chunk))


def proposals_of(csr, k, B, C, n_atoms, budget, seed):
    """One sweep's proposals (ops/sweep.propose) on a random compact atom
    table of one chain (alpha 0.5: births and deaths both frequent)."""
    rs = np.random.default_rng(seed)
    NB = csr.n_rows * k
    elem = np.full(C, -1, np.int32)
    elem[:n_atoms] = rs.integers(0, NB, n_atoms)
    mass = np.zeros(C, np.float32)
    mass[:n_atoms] = rs.gamma(2.0, 0.5, n_atoms)
    atoms = AtomTable(mass=torch.from_numpy(mass),
                      elem=torch.from_numpy(elem),
                      n=torch.tensor(n_atoms, dtype=torch.int32))
    consts = sweep.make_consts(csr.n_rows, 50, k, C, B, 0.5)
    uni = rng.philox_uniforms(seed, 1, 0, 0, 1, B).reshape(16, B)
    return sweep.propose(uni, atoms, budget, consts), atoms


@pytest.mark.parametrize("budget", [5, 200])
def test_work_items_of_a_sweep(budget):
    """The kept lanes of a real sweep touch disjoint rows, so the items
    cover the nonzeros of the rows they name once each."""
    _, csr = skewed_csr(3, G=40, S=600, long_row=11, empty_row=2)
    q, _ = proposals_of(csr, 3, 64, 256, 60, budget, 4)
    pair = q.is_move | q.is_exch
    r1 = torch.where(q.keep, q.r1, -1)[None]
    r2 = torch.where(pair, q.r2, -1)[None]
    assert 0 < int(q.keep.sum()) <= budget
    assert bool(q.is_birth.any() | q.is_death.any()) and bool(pair.any())
    items, first, count = atlas_cuda.work_items_plain(csr.indptr, r1, r2, 16)
    assert (count[0][~q.keep] == 0).all() and (count[0][q.keep] > 0).all()
    covered = torch.cat([torch.arange(int(s), int(e))
                         for s, e in items[:, 3:5]])
    rows = sorted(set(r1[r1 >= 0].tolist()) | set(r2[r2 >= 0].tolist()))
    want = torch.cat([torch.arange(int(csr.indptr[0, r]),
                                   int(csr.indptr[0, r + 1])) for r in rows])
    assert torch.equal(torch.sort(covered).values, want)


def alpha_cases():
    """(name, dense data, csr, k) for test_torch_atlas.py's toy and a CSR
    with a row of many chunks and an empty row."""
    coo, D = toy_coo()
    D = D.astype(np.float32)
    r, c = np.nonzero(D)
    D2, csr2 = skewed_csr(5, G=30, S=2500, long_row=17, empty_row=3)
    return {"toy": (D, sparse.coo_to_csr(r, c, D[r, c], D.shape[0]), 3),
            "long_row": (D2, csr2, 4)}


def addresses(rs, G, k, B, D):
    """Random lane addresses: same-row pairs, pairs on two rows, and the
    long and empty rows of the data among them."""
    r1 = rs.integers(0, G, B)
    r2 = rs.integers(0, G, B)
    r2[:B // 3] = r1[:B // 3]
    lens = (D != 0).sum(axis=1)
    r1[B // 3] = r2[B // 3] = int(lens.argmax())
    r1[B // 3 + 1] = int(lens.argmin())
    r2[B // 3 + 2] = int(lens.argmax())
    return r1, rs.integers(0, k, B), r2, rs.integers(0, k, B)


@pytest.mark.parametrize("chunk", [5, 128])
@pytest.mark.parametrize("case", ["toy", "long_row"])
def test_chunked_alpha_equals_make_models(case, chunk):
    D, csr, k = alpha_cases()[case]
    rs = np.random.default_rng(11)
    G, S = D.shape
    M = rs.gamma(1.0, 1.0, (G, k)).astype(np.float32)
    other = rs.gamma(1.0, 1.0, (S, k)).astype(np.float32)
    r1, c1, r2, c2 = addresses(rs, G, k, 64, D)
    addr = sweep.AddrBatch(*(torch.from_numpy(x) for x in (r1, c1, r2, c2)))
    phase = sparse.make_sparse_phase(torch.from_numpy(other))
    got = atlas_cuda.alpha_chunked_plain(csr, 0, phase, torch.from_numpy(M),
                                         addr, chunk)
    port = sparse.make_model(csr.ell(), phase).alpha((), torch.from_numpy(M),
                                                     addr)
    jab = jsparse.make_model(jsparse.to_ell(D), jsparse.make_sparse_phase(
        jnp.asarray(other))).alpha((), jnp.asarray(M), JAddr(
            *(jnp.asarray(x, jnp.int32) for x in (r1, c1, r2, c2))))
    for name in got._fields:
        close_to_scale(getattr(got, name), getattr(port, name), name)
        close_to_scale(getattr(got, name), np.asarray(getattr(jab, name)),
                       name)
    assert float(got.err1.min()) > 0.0


@pytest.mark.parametrize("case", ["toy", "long_row"])
def test_chunked_alpha_on_kept_lanes_of_every_type(case):
    """The lanes of a real sweep (births, deaths, moves, exchanges, and
    lanes not kept), against make_model; a pair's terms where it is one."""
    D, csr, k = alpha_cases()[case]
    q, _ = proposals_of(csr, k, 128, 512, 90, 128, 6)
    for flag in (q.is_birth, q.is_death, q.is_move, q.is_exch):
        assert bool(flag.any())
    assert not bool(q.keep.all())
    rs = np.random.default_rng(12)
    M = torch.from_numpy(rs.gamma(1.0, 1.0, (D.shape[0], k)).astype(
        np.float32))
    phase = sparse.make_sparse_phase(torch.from_numpy(
        rs.gamma(1.0, 1.0, (D.shape[1], k)).astype(np.float32)))
    addr = sweep.AddrBatch(q.r1, q.c1, q.r2, q.c2)
    got = atlas_cuda.alpha_chunked_plain(csr, 0, phase, M, addr, 9)
    want = sparse.make_model(csr.ell(), phase).alpha((), M, addr)
    kept, pair = q.keep.numpy(), (q.is_move | q.is_exch).numpy()
    for name in ("s1", "smu1", "err1"):
        close_to_scale(getattr(got, name).numpy()[kept],
                       getattr(want, name).numpy()[kept], name)
    for name in ("s_pair", "smu_pair", "err_pair"):
        close_to_scale(getattr(got, name).numpy()[pair],
                       getattr(want, name).numpy()[pair], name)


@pytest.mark.parametrize("chunk", [8, 128])
def test_chunked_sweep_makes_the_same_decisions(chunk):
    coo, D = toy_coo()
    D = D.astype(np.float32)
    r, c = np.nonzero(D)
    csr = sparse.coo_to_csr(r, c, D[r, c], D.shape[0])
    k, B, C = 3, 128, 2048
    rs = np.random.default_rng(8)
    NB = D.shape[0] * k
    elem = np.full(C, -1, np.int32)
    elem[:60] = rs.integers(0, NB, 60)
    mass = np.zeros(C, np.float32)
    mass[:60] = rs.gamma(2.0, 0.5, 60)
    atoms = AtomTable(mass=torch.from_numpy(mass),
                      elem=torch.from_numpy(elem),
                      n=torch.tensor(60, dtype=torch.int32))
    M = total_mass_per_element(atoms, NB).reshape(-1, k)
    phase = sparse.make_sparse_phase(torch.from_numpy(
        rs.gamma(2.0, 1.0, (D.shape[1], k)).astype(np.float32)))
    consts = sweep.make_consts(D.shape[0], D.shape[1], k, C, B, 0.01)
    lam = 0.01 * float(np.sqrt(k / D[D != 0].mean()))
    mp = sweep.MassParams(lam=torch.tensor(lam),
                          max_gibbs_mass=torch.tensor(100.0 / lam))
    slab = rng.philox_uniforms(9, 2, 0, 0, 80, B).reshape(80, 16, B)
    outs = [sweep.run_updates(lambda i: slab[i], atoms, M, (), 0.8, 600,
                              consts, mp, model=model)
            for model in (sparse.make_model(csr.ell(), phase),
                          atlas_cuda.chunked_model(csr, 0, phase, chunk))]
    (a1, M1, _, d1, n1, c1), (a2, M2, _, d2, n2, c2) = outs
    assert d1 == d2 == 600 and n1 == n2
    assert torch.equal(c1.processed, c2.processed)
    assert torch.equal(c1.accepted, c2.accepted)
    assert torch.equal(a1.elem, a2.elem) and int(a1.n) == int(a2.n)
    torch.testing.assert_close(a2.mass, a1.mass, atol=5e-3, rtol=1e-4)
    torch.testing.assert_close(M2, M1, atol=5e-3, rtol=1e-4)
    assert int(c1.accepted.sum()) > 50
