"""The sparse model's per-call tables kernel's plain version and plan
(cogaps_tpu_torch/ops/sparse_tables_cuda.py) against the JAX package on
the CPU.

sparse_tables_plain builds (SQ, Y0, G) of every chain from the chains'
CSR rows; cogaps_tpu/models/sparse.py builds them from dense weights
(kernel_tables) and from ELL rows (kernel_tables_ell). The same seeded
numpy data goes through both, for the A sampler (gene-major rows) and the
P sampler (sample-major rows, the engines' csr_p), one chain and three.
The packages sum the same terms in other orders, so each entry is held
within 1e-5 of its sum of |terms| (beta (|O|^T |O| + sum_nz |w| |o| |o|^T)
for G and SQ, beta sum_nz |o| / d + sum_c' |M_c'| |G_cc'| for Y0), and an
entry whose terms are all 0 is 0. The kernel itself runs only on the card
(tests/test_torch_cuda.py); here its plan's segments are checked to follow
k and a row's length alone."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu.models import sparse as jsparse
from cogaps_tpu_torch.models import sparse
from cogaps_tpu_torch.ops import sparse_tables_cuda as st

torch.set_num_threads(1)
BETA = 100.0


def make_data(NR, m, k, nch, seed):
    """nch chains' data (nonnegative, a third nonzero, row 1 empty, row 2
    with one nonzero, column 3 empty), factors M and partner factors with
    an empty last column."""
    rs = np.random.default_rng(seed)
    Ds = []
    for _ in range(nch):
        D = (rs.gamma(2.0, 2.0, (NR, m))
             * (rs.random((NR, m)) < 0.35)).astype(np.float32)
        D[1] = 0.0
        D[2] = 0.0
        D[2, m // 2] = 3.5
        D[:, 3] = 0.0
        Ds.append(D)
    return Ds, rs


def factors(rs, nch, NR, m, k):
    M = rs.gamma(1.0, 1.0, (nch, NR, k)).astype(np.float32)
    M[rs.random(M.shape) < 0.3] = 0.0
    O = rs.gamma(2.0, 1.0, (nch, m, k)).astype(np.float32)
    O[:, :, -1] = 0.0
    return M, O


def csr_of(Ds):
    coos = []
    for D in Ds:
        r, c = np.nonzero(D)
        coos.append((r, c, D[r, c]))
    return sparse.stack_csr(coos, Ds[0].shape[0])


def terms(D, O, M):
    """Each entry's sum of |terms| in float64: (SQ, Y0, G)."""
    D, O, M = (np.asarray(x, np.float64) for x in (D, O, M))
    nz = D != 0
    d = np.where(nz, D, 1.0)
    W = np.where(nz, np.abs(1.0 - 1.0 / (d * d)), 0.0)
    R = np.where(nz, 1.0 / d, 0.0)
    A = np.abs(O)
    G = BETA * ((A.T @ A)[None] + np.einsum("ri,ic,id->rcd", W, A, A))
    Y0 = BETA * (R @ A) + np.einsum("rd,rcd->rc", np.abs(M), G)
    return np.diagonal(G, axis1=1, axis2=2), Y0, G.reshape(-1, O.shape[1])


def assert_within(got, want, scale, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    d = np.abs(got - want)
    bad = d > 1e-5 * scale
    assert not bad.any(), (what, float((d / np.maximum(scale, 1e-300)).max()))


CASES = {  # (rows, partners, k): the A side; the P side is its transpose
    "60x35-k4": (60, 35, 4), "120x80-k10": (120, 80, 10),
    "40x50-k20": (40, 50, 20), "12x15-k200": (12, 15, 200)}


@pytest.mark.parametrize("nch", [1, 3])
@pytest.mark.parametrize("side", ["A", "P"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_tables(case, side, nch):
    """sparse_tables_plain (through sparse_tables on CPU tensors, which
    runs it) against JAX's kernel_tables and kernel_tables_ell chain by
    chain, on the A side's CSR rows or the P side's (csr_p's
    orientation): an empty row, a one-nonzero row, an empty data column
    and an empty partner column among them."""
    G_, S_, k = CASES[case]
    Ds, rs = make_data(G_, S_, k, nch, seed=G_ + S_ + k + nch)
    if side == "P":
        Ds = [np.ascontiguousarray(D.T) for D in Ds]
    NR, m = Ds[0].shape
    M, O = factors(rs, nch, NR, m, k)
    csr = csr_of(Ds)
    got = st.sparse_tables(csr, torch.from_numpy(O), torch.from_numpy(M))
    plain = st.sparse_tables_plain(csr, torch.from_numpy(O),
                                   torch.from_numpy(M))
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert [tuple(x.shape) for x in got] == [(nch, NR, k), (nch, NR, k),
                                             (nch, NR * k, k)]
    for c, D in enumerate(Ds):
        ell = jsparse.to_ell(D)
        Wd, D1 = jsparse.dense_weights(ell, m)
        o, mc = jnp.asarray(O[c]), jnp.asarray(M[c])
        scale = terms(D, O[c], M[c])
        for how, want in (
                ("kernel_tables", jsparse.kernel_tables(Wd, D1, o, mc)),
                ("kernel_tables_ell", jsparse.kernel_tables_ell(
                    ell, o, mc, row_chunk=16))):
            for name, x, y, s in zip(("SQ", "Y0", "G"), got, want, scale):
                assert_within(x[c].numpy(), np.asarray(y), s,
                              f"{case} {side} chain {c} {name} vs {how}")


def test_plain_broadcasts_a_shared_factor():
    """A partner factor (or M) with one chain for all gives each chain
    what its own copy gives."""
    Ds, rs = make_data(30, 20, 5, 3, seed=2)
    M, O = factors(rs, 3, 30, 20, 5)
    csr = csr_of(Ds)
    shared = st.sparse_tables_plain(csr, torch.from_numpy(O[:1]),
                                    torch.from_numpy(M))
    own = st.sparse_tables_plain(csr, torch.from_numpy(
        np.repeat(O[:1], 3, axis=0)), torch.from_numpy(M))
    for x, y in zip(shared, own):
        assert torch.equal(x, y)


H100_SMEM = 232_448  # shared memory a block can use
H100_SM_SMEM = 233_472  # an SM's shared memory (228 KB, 1 KB a block kept)
H100_REGS = 255  # registers a thread at most


@pytest.mark.parametrize("k", [1, 3, 4, 5, 10, 12, 13, 16, 17, 20, 39, 50,
                               64, 90, 100, 120, 121, 150, 172, 173, 200,
                               256, 300, 500])
def test_plan_fits_and_takes_k_alone(k):
    """The plan is a function of k alone (no chain count, no SM count),
    and each form fits an H100: lanes up to k = 16 (a warp a row, a lane
    a nonzero: every entry of U's upper triangle and T4 in a lane's
    registers, under the 255 a thread can hold, and the ring of
    LANE_STAGES stages of 32 staged rows a warp, 16-byte aligned, on
    distinct banks for 8 lanes' 16-byte loads); tiles up to k = 172 (a
    row's 8 x 8 tiles of U's upper triangle over G groups of a block of
    64 threads up to 16 tiles, else over one group of the fewest warps
    that hold them, up to 256 threads; SUB nonzeros a group a
    segment, the ring of TILE_AHEAD + 1 segments under TILE_RING bytes,
    fmaf chains of FL
    segments, CHAIN nonzeros at least and less than CHAIN + SUB); slabs
    past it (4 x 4 items over as few slabs of up to 1024 threads as hold
    them). The shared memory adds up and fits a block, at least two
    blocks an SM in the lanes and tiles forms."""
    assert list(inspect.signature(st.sparse_plan).parameters) == ["k"]
    p = st.sparse_plan(k)
    assert st.sparse_plan(k) == p and p.k == k
    assert p.threads % 32 == 0 and p.threads <= st.MAX_THREADS
    assert p.smem <= H100_SMEM
    if k <= st.LANES_MAX_K:
        assert p.form == "lanes"
        assert p.KP == 4 * -(-k // 4) and p.RS >= p.KP and p.RS % 8 == 4
        E = k * (k + 1) // 2 + k
        assert p.P == E and E + p.KP + 40 <= H100_REGS
        assert (p.G, p.SUB, p.SEG, p.FL, p.S) == (1, 1, st.LANES, 1, 1)
        assert p.threads == st.LANE_THREADS
        warp = (st.LANE_STAGES * st.LANES * p.RS
                + 4 * st.LANE_STAGES * st.LANES + E + k * k)
        assert p.smem == 4 * (p.threads // 32) * (4 * -(-warp // 4))
    elif k <= st.TILES_MAX_K:
        assert p.form == "tiles"
        nt = -(-k // st.TILE)
        assert p.KP == st.TILE * nt and p.RS == p.KP + 4
        assert p.P == nt * (nt + 1) // 2
        if p.P <= st.TILE_SMALL:
            assert p.threads == 64
        else:
            assert p.threads - 32 < p.P <= p.threads <= 256
        assert p.G == p.threads // p.P and p.G * p.P <= p.threads
        assert p.SEG == p.G * p.SUB and 1 <= p.SUB <= st.CHAIN
        slots = st.TILE_AHEAD + 1
        assert (p.SUB == 1
                or slots * p.SEG * (p.RS + 4) * 4 <= st.TILE_RING)
        assert st.CHAIN <= p.FL * p.SUB < st.CHAIN + p.SUB
        assert p.S == 1
        assert p.smem == 4 * (72 * p.threads + slots * p.SEG * (p.RS + 2)
                              + 4 * st.TILE_AHEAD * p.SEG + p.KP * nt
                              + 16)
    else:
        assert p.form == "slabs"
        assert p.KP == 4 * -(-k // 4) and p.RS == p.KP
        nt = p.KP // 4
        assert p.P == nt * (nt + 1) // 2 + nt
        assert p.S == -(-p.P // st.MAX_THREADS) >= 2
        assert p.G == 1 and (p.S - 1) * p.threads < p.P <= p.S * p.threads
        assert p.threads - 32 < -(-p.P // p.S)
        assert p.SEG == p.SUB >= 1 and p.FL == 1
        assert p.smem == 4 * (p.SEG * (p.KP + 3) + p.KP)
    if p.form != "slabs":
        assert 2 * (p.smem + 1024) <= H100_SM_SMEM


def test_plan_forms_meet_at_16():
    """k = 16 is the last lanes plan (152 entries a lane) and k = 17 the
    first tiles plan (6 tiles of 8 x 8 over k padded to 24, 10 groups of
    them in 64 threads); the lanes
    form takes every k from 1 to 16, the tiles form every k from 17 to
    172, and the plan raises below k = 1."""
    assert st.LANES_MAX_K == 16
    assert [st.sparse_plan(k).form for k in range(1, 17)] == ["lanes"] * 16
    assert all(st.sparse_plan(k).form == "tiles" for k in range(17, 173))
    last, first = st.sparse_plan(16), st.sparse_plan(17)
    assert last.P == 152 and last.KP == 16
    assert first.KP == 24 and first.P == 6 and first.G == 10
    for k in (0, -3):
        with pytest.raises(ValueError, match="sparse tables kernel takes"):
            st.sparse_plan(k)


def test_plan_slabs_past_a_block():
    """Up to k = 172 a row's 8 x 8 tiles fit 256 threads (253 of them at
    k = 172); past it the 4 x 4 items of k = 173 take two slabs."""
    p = st.sparse_plan(172)
    assert p.form == "tiles" and p.P == 253 and p.threads == 256
    q = st.sparse_plan(173)
    assert q.form == "slabs" and q.P > st.MAX_THREADS and q.S == 2


@pytest.mark.parametrize("k", [4, 10, 16, 17, 20, 50, 100, 200])
def test_segments_follow_k_and_row_length(k):
    """A row's sums, as segments(k, n) gives them, cover its n nonzeros
    once; they depend on (k, n) alone (segments takes nothing else), a
    row of no nonzeros has none, and each form keeps its shape: lanes,
    lane l summing positions l, l + 32, ... in order; tiles, group g's
    chains running over its ranges of SUB in FL segments of SEG in turn;
    slabs, one group whose chains are the segments of SEG."""
    assert list(inspect.signature(st.segments).parameters) == ["k", "n"]
    p = st.sparse_plan(k)
    assert st.segments(k, 0) == ()
    for n in (1, 31, 32, 33, p.SEG + 1, 5 * p.SEG + 3, 40 * p.SEG + 7):
        groups = st.segments(k, n)
        flat = sorted(i for g in groups for c in g for i in c)
        assert flat == list(range(n))
        assert all(c for g in groups for c in g)
        if p.form == "lanes":
            assert len(groups) == min(st.LANES, n)
            for lane, g in enumerate(groups):
                assert g == (tuple(range(lane, n, st.LANES)),)
        elif p.form == "tiles":
            assert len(groups) <= p.G
            for g, chains in enumerate(groups):
                for c, chain in enumerate(chains):
                    assert len(chain) <= p.FL * p.SUB
                    segs = {i // p.SEG for i in chain}
                    assert segs <= set(range(c * p.FL, (c + 1) * p.FL))
                    assert all(g * p.SUB <= i % p.SEG < (g + 1) * p.SUB
                               for i in chain)
                    assert list(chain) == sorted(chain)
        else:
            (chains,) = groups
            assert [c[0] for c in chains] == list(range(0, n, p.SEG))
            assert all(len(c) <= p.SEG for c in chains)
        assert st.segments(k, n) == groups


@pytest.mark.parametrize("k", [3, 10, 20, 50, 200])
def test_z2_chunks_follow_k_and_m(k):
    """Z2 = O^T O's chunks depend on (k, m) alone: whole stages (lanes:
    32 partners; tiles: SEG) and at most MAX_CHUNKS a chain in the lanes
    and tiles forms, whole segments of ZCHUNK partners at least in the
    slabs form; they cover the m partners, and m = 0 has none."""
    assert list(inspect.signature(st.z2_chunks).parameters) == ["k", "m"]
    p = st.sparse_plan(k)
    assert st.z2_chunks(k, 0)[1] == 0
    for m in (1, 31, 32, 1000, 10000, 50000, 123457):
        zseg, nzc = st.z2_chunks(k, m)
        assert zseg % p.SEG == 0 and (nzc - 1) * zseg < m <= nzc * zseg
        if p.form == "slabs":
            assert st.ZCHUNK <= zseg < st.ZCHUNK + p.SEG
        else:
            assert nzc <= st.MAX_CHUNKS
            assert zseg == p.SEG or (zseg - p.SEG) * st.MAX_CHUNKS < m
        assert st.z2_chunks(k, m) == (zseg, nzc)


def test_scratch_by_hand():
    """scratch_floats at small shapes, counted by hand: lanes (k = 3, m =
    100: 4 chunks of 32) Z2's partials (2 chains x 9 entries x 4 chunk
    slots: 72 floats, to 96), Z2 (2 chains x 9 entries, each chain's in
    32 floats of its own), the padded copy of O (one shared factor, 100
    x 4), 2 x 2 counters and flags; slabs (k = 200, m = 3000: 3 chunks
    of 1050) partials and Z2 of one chain."""
    p = st.sparse_plan(3)
    assert st.z2_chunks(3, 100) == (32, 4)
    assert st.scratch_floats(p, 2, 1, 100) == 96 + 2 * 32 + 100 * 4 + 4
    q = st.sparse_plan(200)
    assert st.z2_chunks(200, 3000) == (1050, 3)
    assert st.scratch_floats(q, 1, 1, 3000) == 4 * 200 * 200


def test_counts_by_hand():
    """sparse_tables_counts at a small shape, counted by hand: bytes of
    indptr, idx, val, the factors (shared or a chain each) and the three
    tables; operations per nonzero, per chain (Z2) and per row."""
    nnz, NR, m, k, nch = 100, 7, 11, 3, 2
    n_bytes, n_ops = st.sparse_tables_counts(nnz, NR, m, k, nch)
    assert n_bytes == (8 * 2 * 8 + 8 * 100 + 4 * 2 * 11 * 3 + 4 * 2 * 7 * 3
                       + 4 * 2 * 7 * (9 + 6))
    assert n_ops == 100 * (3 + 12 + 6) + 2 * 11 * 12 + 2 * 7 * (12 + 18 + 6)
    shared, _ = st.sparse_tables_counts(nnz, NR, m, k, nch, o_chains=1,
                                        m_chains=1)
    assert n_bytes - shared == 4 * 11 * 3 + 4 * 7 * 3


def test_wrapper_checks_and_dispatch():
    """CPU tensors run the plain version; tensors on another device, a
    chain count the factors do not have, or k below 1 raise."""
    Ds, rs = make_data(12, 9, 3, 2, seed=5)
    M, O = factors(rs, 2, 12, 9, 3)
    csr = csr_of(Ds)
    with pytest.raises(ValueError, match="no sparse tables kernel"):
        st.sparse_tables(csr, torch.from_numpy(O).to("meta"),
                         torch.from_numpy(M).to("meta"))
    with pytest.raises(ValueError, match="not \\(chains or 1"):
        st.sparse_tables(csr, torch.from_numpy(np.concatenate([O, O])),
                         torch.from_numpy(M))
    with pytest.raises(ValueError, match="sparse tables kernel takes"):
        st.sparse_plan(0)
    before = st.sparse_tables.launches
    st.sparse_tables(csr, torch.from_numpy(O), torch.from_numpy(M))
    assert st.sparse_tables.launches == before
