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


@pytest.mark.parametrize("k", [1, 3, 4, 5, 10, 12, 13, 20, 39, 50, 64, 90,
                               100, 150, 172, 173, 200, 256, 300, 500])
def test_plan_fits_and_takes_k_alone(k):
    """The plan is a function of k alone (no chain count, no SM count):
    the G groups of a row's P items fit the block's threads, 128 threads
    where a row fits them (as many groups as fit), else one group of a
    multiple of 32 up to 1024, in as few slabs as hold it; without slabs
    the staged partner rows hold the row's G (SEG KP >= k^2); Z2's chunks
    are whole segments; the shared memory adds up and fits an H100
    block."""
    assert list(inspect.signature(st.sparse_plan).parameters) == ["k"]
    p = st.sparse_plan(k)
    assert p.KP == 4 * -(-k // 4) and p.nt * 4 == p.KP
    assert p.P == p.nt * (p.nt + 1) // 2 + p.nt
    assert p.G * p.P <= p.S * p.threads and p.threads <= st.MAX_THREADS
    assert p.threads % 32 == 0
    assert p.S == -(-p.P // st.MAX_THREADS)
    if p.P <= st.THREADS:
        assert p.threads == st.THREADS and p.G == st.THREADS // p.P
    else:
        assert p.G == 1 and (p.S - 1) * p.threads < p.P
        assert p.threads - 32 < -(-p.P // p.S)
    assert p.SEG == p.G * p.SUB and p.SUB >= 1
    assert p.ZSEG % p.SEG == 0
    if p.S == 1:
        assert p.SEG * p.KP >= k * k and p.ZSEG == p.SEG
    else:
        assert st.ZCHUNK <= p.ZSEG < st.ZCHUNK + p.SEG
    assert p.smem == 4 * (p.SEG * (p.KP + 3) + p.KP
                          + (p.G * p.P * 16 if p.G > 1 else 0))
    assert p.smem <= 232_448
    assert st.sparse_plan(k) == p


def test_plan_slabs_past_a_block():
    """Up to k = 172 a row's P = nt (nt + 3) / 2 items fit one block's
    threads; one tile row more takes two slabs, and k < 1 raises."""
    p = st.sparse_plan(172)
    assert p.P <= st.MAX_THREADS and p.S == 1
    q = st.sparse_plan(173)
    assert q.nt == p.nt + 1 and q.P > st.MAX_THREADS and q.S == 2
    for k in (0, -3):
        with pytest.raises(ValueError, match="sparse tables kernel takes"):
            st.sparse_plan(k)


@pytest.mark.parametrize("k", [4, 10, 20, 50, 200])
def test_segments_follow_k_and_row_length(k):
    """A row's sums run in segments of SEG nonzeros from its start, each
    cut into its groups' ranges of SUB (the last of each shorter), in
    order, covering the row once; they depend on (k, n) alone (segments
    takes nothing else), and a row of no nonzeros has none."""
    assert list(inspect.signature(st.segments).parameters) == ["k", "n"]
    p = st.sparse_plan(k)
    assert st.segments(k, 0) == ()
    for n in (1, p.SUB + 1, p.SEG - 1, p.SEG, p.SEG + 1, 5 * p.SEG + 3):
        segs = st.segments(k, n)
        assert len(segs) == -(-n // p.SEG)
        flat = [r for seg in segs for r in seg]
        assert flat[0][0] == 0 and flat[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(flat, flat[1:]))
        assert all(0 < hi - lo <= p.SUB for lo, hi in flat)
        for i, seg in enumerate(segs):
            assert seg[0][0] == i * p.SEG and len(seg) <= p.G
            assert all(lo == i * p.SEG + g * p.SUB
                       for g, (lo, _) in enumerate(seg))


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
