"""The per-call tables kernel's plan, counts and dispatch
(cogaps_tpu_torch/ops/tables_cuda.py, models/dense.tables) on the CPU, and
F4's row split (probes/mosaic.claim_plan).

The kernel (csrc/tables.cu) runs only on the card, where
tests/test_torch_cuda.py holds it to its plain version. Here: the plan
fixes every chain's summation order from (R, m, k) and the SM count
alone, its contraction chunks cover [0, m) once and in order, its row
tiles, stages and warps cover every (row, partner) pair once, its quads
cover every table entry, and its shared memory and registers fit an H100
block, at the shapes the per-call route runs (GIST, 5000 x 2000, 20000 x
100, a 2500 x 2000 sharded block, phase 11's 5005 x 100 subsets, modsim)
and at edges of m and k; it picks the tensor-core form, the short-row
form, rows_kernel or quads_kernel as expected; tables_counts on a case
counted by hand; the dispatcher gives CPU tensors of either float type
to the plain version without a launch, raises for anything the kernel
does not take, and the plain version and the emulation of mma_kernel's
3xTF32 arithmetic (tables_tf32, its TF32 rounding checked by hand), with
a leading chain dimension, match the JAX package's make_phase and
rebuild_cache to float32 rounding (1e-5 of the summed terms' magnitude;
for Y of (|D| + |M| |O|^T) invS2 against |O|, since Y cancels)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogaps_tpu.models import dense as jdense
from cogaps_tpu_torch.models import dense
from cogaps_tpu_torch.ops import tables_cuda
from cogaps_tpu_torch.parallel import distributed
from cogaps_tpu_torch.probes import mosaic

torch.set_num_threads(1)
H100_SMS = 132

PLAN_SHAPES = {  # (R, m, k): sampler A rows are genes, P's samples
    "gist-A": (1363, 9, 7), "gist-P": (9, 1363, 7),
    "5000x2000-A": (5000, 2000, 10), "5000x2000-P": (2000, 5000, 10),
    "20000x100-A": (20000, 100, 10), "20000x100-P": (100, 20000, 10),
    "block-2500x2000-A": (2500, 2000, 10),
    "block-2500x2000-P": (2000, 2500, 10),
    "m1": (50, 1, 3), "odd-m": (37, 1001, 5),
    "k1": (300, 777, 1), "k3": (300, 777, 3), "k7": (300, 777, 7),
    "k10": (300, 777, 10), "k25": (300, 777, 25),
    "k25-few-rows": (3, 5000, 25), "k50": (40, 300, 50),
    "subsets-A": (5005, 100, 10), "subsets-P": (100, 5005, 10),
    "modsim-A": (25, 20, 3), "modsim-P": (20, 25, 3),
    "m16": (70, 16, 4), "R17": (17, 999, 6), "R33": (33, 4001, 8),
    "k12": (200, 3000, 12),
    # above k = 12: the column tiles, and what stays quads_kernel's
    "k13": (500, 700, 13), "gist-A-k13": (1363, 9, 13),
    "gist-P-k13": (9, 1363, 13), "5000x2000-A-k20": (5000, 2000, 20),
    "5000x2000-P-k20": (2000, 5000, 20), "20000x100-A-k20": (20000, 100, 20),
    "20000x100-P-k20": (100, 20000, 20), "5000x2000-A-k50": (5000, 2000, 50),
    "5000x2000-P-k50": (2000, 5000, 50), "k64": (70, 64, 64),
    "k25-m30": (300, 30, 25), "k50-m30": (40, 30, 50),
    "k25-one-row": (1, 4000, 25), "k65": (300, 777, 65),
    # above k = 64: the tensor-core form's column tiles, Y's over two
    # tiles at k150; the short-row form's ceiling, and past a block's
    "5000x2000-A-k80": (5000, 2000, 80), "5000x2000-P-k80": (2000, 5000, 80),
    "5000x2000-A-k100": (5000, 2000, 100),
    "5000x2000-P-k100": (2000, 5000, 100), "100x100-k90": (100, 100, 90),
    "k150": (300, 400, 150), "k65-short": (30, 777, 65),
    "k615": (5000, 2000, 615),
}
# the form tables_plan takes: mma_kernel's tensor-core ("mma") and
# short-row ("short") forms (in column tiles above k = 12), rows_kernel,
# quads_kernel (above k = 12 where m < MMA_MIN_M, R = 1, in the short-row
# form above TILE_MAX_K, or where a column tile does not fit a block)
PLAN_FORMS = {
    "gist-A": "rows", "gist-P": "short", "5000x2000-A": "mma",
    "5000x2000-P": "mma", "20000x100-A": "mma", "20000x100-P": "mma",
    "block-2500x2000-A": "mma", "block-2500x2000-P": "mma", "m1": "rows",
    "k1": "mma", "k12": "mma", "k25": "mma", "k25-few-rows": "short",
    "k50": "mma", "subsets-A": "mma", "subsets-P": "mma",
    "modsim-A": "rows", "modsim-P": "rows", "m16": "rows",
    "R17": "short", "R33": "mma", "k13": "mma", "gist-A-k13": "quads",
    "gist-P-k13": "short", "5000x2000-A-k20": "mma",
    "5000x2000-P-k20": "mma", "20000x100-A-k20": "mma",
    "20000x100-P-k20": "mma", "5000x2000-A-k50": "mma",
    "5000x2000-P-k50": "mma", "k64": "mma", "k25-m30": "quads",
    "k50-m30": "quads", "k25-one-row": "quads", "k65": "mma",
    "5000x2000-A-k80": "mma", "5000x2000-P-k80": "mma",
    "5000x2000-A-k100": "mma", "5000x2000-P-k100": "mma",
    "100x100-k90": "mma", "k150": "mma", "k65-short": "quads",
    "k615": "quads"}


def test_plan_takes_no_chain_count():
    params = list(inspect.signature(tables_cuda.tables_plan).parameters)
    assert params == ["R", "m", "k", "n_sm"]
    assert all("ch" not in p for p in tables_cuda.TablesPlan._fields)


@pytest.mark.parametrize("shape", list(PLAN_SHAPES.values()),
                         ids=list(PLAN_SHAPES))
def test_plan_splits_cover_the_contraction_once_in_order(shape):
    R, m, k = shape
    plan = tables_cuda.tables_plan(R, m, k, H100_SMS)
    splits = plan.splits()
    assert len(splits) == plan.S >= 1
    assert splits[0][0] == 0 and splits[-1][1] == m
    for (lo, hi), (lo2, _) in zip(splits, splits[1:]):
        assert lo < hi == lo2
    assert all(hi - lo <= plan.CH for lo, hi in splits)
    assert plan.CH % plan.L == 0


@pytest.mark.parametrize("shape", list(PLAN_SHAPES.values()),
                         ids=list(PLAN_SHAPES))
def test_plan_fits_a_block_and_covers_every_entry(shape):
    R, m, k = shape
    plan = tables_cuda.tables_plan(R, m, k, H100_SMS)
    assert plan.smem <= tables_cuda.SMEM_MAX == 232_448
    assert plan.registers <= 255
    assert plan.row_tiles * plan.RT >= R > (plan.row_tiles - 1) * plan.RT
    assert plan.nq == -(-k // 4) + -(-(k * (k + 1) // 2) // 4)
    if plan.form in ("mma", "short"):  # four warps, RW x KW
        assert plan.RW * plan.KW == tables_cuda.MMA_WARPS
        assert plan.RT == 16 * plan.RW
        assert plan.L == tables_cuda._mma_stage(plan.RW) >= 16 * plan.KW
        assert plan.CH % plan.L == 0 and plan.G == 1 and plan.PQ == 0
        floats = (tables_cuda._tile_floats(k, plan.RW, plan.NCT,
                                           plan.stages) if plan.NCT
                  else tables_cuda._mma_floats(k, plan.RW))
        assert plan.smem == 4 * floats
        # a ring of three stages, two in wide tiles where three do not
        # fit two blocks an SM
        assert plan.stages == (2 if plan.NCT > tables_cuda.TILE_NT and 4
                               * tables_cuda._tile_floats(
                                   k, plan.RW, plan.NCT)
                               > tables_cuda.SMEM_TWO else 3)
        kp = k * (k + 1) // 2  # n-tiles of 8 cover Y's k and Z's kp
        assert plan.NT8 % 8 == 0 and plan.NT8 - 8 < k + kp + 8
        assert plan.NT8 >= 8 * -(-k // 8) + kp
        assert plan.partial == plan.RT * plan.NC
        # column tiles above k = 12, one tile of every column below
        assert (plan.NCT > 0) == (k > tables_cuda.ROWS_MAX_K)
        assert plan.acc_tiles == -(-plan.NT8 // plan.NC)
        return
    assert plan.G * plan.RT == tables_cuda.THREADS
    if plan.PQ == 0:  # rows_kernel: a thread a row, every entry
        assert plan.G == 1 and plan.acc_tiles == 1
        assert k <= tables_cuda.ROWS_MAX_K
        assert plan.accumulators == k + k * (k + 1) // 2
    else:
        assert plan.PQ in tables_cuda.QUADS
        assert plan.TQ * plan.acc_tiles >= plan.nq
        assert plan.TQ * (plan.acc_tiles - 1) < plan.nq
        assert plan.smq % 2 == 1 and plan.smq >= plan.qy
        assert plan.accumulators == 4 * plan.PQ


@pytest.mark.parametrize("shape,rows", [
    ((5000, 2000, 10), True), ((100, 20000, 10), True), ((1363, 9, 7), True),
    ((64, 50, 12), True), ((9, 1363, 7), True), ((5000, 2000, 13), False),
    ((9, 1363, 13), False), ((300, 777, 25), False)],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_plan_takes_the_rows_kernel_up_to_k12(shape, rows):
    """A row's accumulators at once in one block (one column tile of
    mma_kernel, or rows_kernel below MMA_MIN_M partners) wherever k <=
    12; for a larger k, mma_kernel's column tiles over several blocks
    from MMA_MIN_M partners, or quads_kernel, its quads spread over a
    row's threads where the rows are few."""
    plan = tables_cuda.tables_plan(*shape, H100_SMS)
    assert (plan.PQ == 0 and plan.acc_tiles == 1) is rows
    if not rows and plan.form == "quads" and shape[0] < 64:
        assert plan.G > 1
    if not rows and plan.form != "quads":
        assert plan.acc_tiles > 1 and plan.G == 1


@pytest.mark.parametrize("R,chunk", [(9, 128), (32, 384), (40, 480),
                                     (64, 512), (100, 512)])
def test_plan_chunks_shorter_for_fewer_rows(R, chunk):
    """A long contraction's chunk where one row tile cannot fill the
    card (mma_kernel): 12 R partners, from two stages up to MMA_CHUNK."""
    plan = tables_cuda.tables_plan(R, 4000, 7, H100_SMS)
    assert plan.CH == chunk and plan.S == -(-4000 // chunk)


def test_plan_fills_the_card_where_one_chain_can():
    """Few rows and a long contraction: the chunks give the blocks (9 x
    20000, the short-row form), up to chunks of MMA_CHUNK where a split's
    partials are 64 rows wide (P at 20000 x 100: its 16 chains fill the
    card), and one chunk where the rows alone do (A)."""
    short = tables_cuda.tables_plan(9, 20000, 7, H100_SMS)
    assert short.blocks >= H100_SMS and short.S == short.blocks
    p = tables_cuda.tables_plan(100, 20000, 10, H100_SMS)
    assert p.CH == tables_cuda.MMA_CHUNK and p.S == -(-20000 // p.CH)
    assert 16 * p.blocks >= 2 * H100_SMS
    a = tables_cuda.tables_plan(20000, 100, 10, H100_SMS)
    assert a.S == 1 and a.blocks >= H100_SMS


@pytest.mark.parametrize("name", list(PLAN_FORMS))
def test_plan_picks_the_expected_form(name):
    """The tensor-core form for 33 rows and more, at every k whose
    column tile fits a block (to k = 614), the short-row form (partners
    split over the warps) below, up to k = TILE_MAX_K; rows_kernel where
    the contraction is shorter than MMA_MIN_M partners (the accuracy
    gate) or at one row, quads_kernel there above k = 12 and beyond
    those."""
    plan = tables_cuda.tables_plan(*PLAN_SHAPES[name], H100_SMS)
    assert plan.form == PLAN_FORMS[name]
    assert (plan.KW > 1) == (plan.form == "short")


def _coverage(plan):
    """How many times the plan's blocks, stages and warps reach each
    (row, partner) pair."""
    hits = np.zeros((plan.R, plan.m), dtype=np.int32)
    mma = plan.form in ("mma", "short")
    for tile in range(plan.row_tiles):
        for lo, hi in plan.splits():
            if not mma:
                hits[tile * plan.RT:(tile + 1) * plan.RT, lo:hi] += 1
                continue
            for i0 in range(lo, hi, plan.L):
                for rw in range(plan.RW):
                    r0 = tile * plan.RT + 16 * rw
                    for kw in range(plan.KW):
                        for grp in range(kw, plan.L // 16, plan.KW):
                            g0 = i0 + 16 * grp
                            hits[r0:r0 + 16, g0:min(g0 + 16, hi)] += 1
    return hits


@pytest.mark.parametrize("shape", list(PLAN_SHAPES.values()),
                         ids=list(PLAN_SHAPES))
def test_plan_covers_every_row_and_partner_once(shape):
    plan = tables_cuda.tables_plan(*shape, H100_SMS)
    assert (_coverage(plan) == 1).all()


TILE_SHAPES = [(40, 300, 20), (17, 999, 13), (100, 2000, 25), (70, 64, 50),
               (9, 1363, 13), (5000, 2000, 20), (100, 20000, 20),
               (2000, 5000, 50), (3, 5000, 64), (64, 64, 33),
               (5000, 2000, 80), (2000, 5000, 80), (5000, 2000, 100),
               (2000, 5000, 100), (100, 100, 90), (300, 400, 150)]


@pytest.mark.parametrize("shape", TILE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_column_tiles_cover_each_column_once(shape):
    """Above k = 12 (mma_kernel's column tiles): the plan takes no chain
    count; its column tiles, in the grid's order, cover each of the NT8
    columns once, Y's n-tiles in the first tiles they fill (two at k =
    150); its splits cover the contraction once, in order; a block's
    shared memory and the register estimate fit three blocks an SM up to
    k = 22 and two above (and in the tensor-core form's tiles of 128
    columns above TILE_WIDE_K, on a ring of two stages above k = 74);
    every entry of a row's k x k is in exactly one tile's Z list, in
    address order, SQ's diagonal marked, and tiles of Y alone have
    none."""
    R, m, k = shape
    plan = tables_cuda.tables_plan(R, m, k, H100_SMS)
    # 128 columns a tile, not 64, in the tensor-core form
    wide = k > tables_cuda.TILE_WIDE_K and plan.form == "mma"
    assert plan.form in ("mma", "short")
    assert plan.NCT == tables_cuda.TILE_NT * (2 if wide else 1)
    tiles = plan.column_tiles()
    assert len(tiles) == plan.acc_tiles and tiles[0][0] == 0
    assert tiles[-1][1] == plan.NT8
    for (a, b), (a2, _) in zip(tiles, tiles[1:]):
        assert a < b == a2 and b - a == plan.NC
    ny8 = 8 * -(-k // 8)  # Y's columns, in the first y_tiles tiles
    y_tiles = -(-ny8 // plan.NC)
    assert (y_tiles > 1) == (k > 128 and wide)
    assert plan.stages == (2 if wide and k > 74 else 3)
    splits = plan.splits()
    assert splits[0][0] == 0 and splits[-1][1] == m
    assert all(lo < hi == lo2 for (lo, hi), (lo2, _) in zip(splits,
                                                             splits[1:]))
    per_sm = 3 if k <= 22 and not wide else 2
    assert per_sm * (plan.smem + 1024) <= 228 * 1024
    assert plan.registers <= 65536 // (per_sm * tables_cuda.THREADS)
    assert plan.partial == plan.RT * plan.NC
    lists = tables_cuda.tile_list(k, plan.NCT)
    assert len(lists) == plan.acc_tiles
    seen = np.zeros(k * k, dtype=np.int32)
    kp = k * (k + 1) // 2
    for t, ent in enumerate(lists):
        assert len(ent) == 2 * plan.NC
        live = [x for x in ent if x >= 0]
        assert list(ent[len(live):]) == [-1] * (len(ent) - len(live))
        assert bool(live) == (tiles[t][1] > ny8)  # Y's tiles alone: none
        addr = [x >> 8 for x in live]
        assert addr == sorted(addr)
        for x, e in zip(live, addr):
            seen[e] += 1
            c, c2 = divmod(e, k)
            lo, hi = min(c, c2), max(c, c2)
            n = ny8 + lo * k - lo * (lo - 1) // 2 + hi - lo
            assert n == tiles[t][0] + (x & 0x7F) and n < ny8 + kp
            assert bool(x & 0x80) == (c == c2)  # SQ's c = address / (k+1)
            assert c != c2 or e == c * (k + 1)
    assert (seen == 1).all()


def test_tables_counts_by_hand():
    """R=2, m=3, k=2 (3 pairs): bytes 4 (2*6 D and W + 4 M + 6 O + 8 Y
    and SQ + 8 Z) + 2 col_nz = 154; operations 6 elements x (8 + 2 + 6) +
    3 partners x 3 pairs = 105."""
    assert tables_cuda.tables_counts(2, 3, 2, 1) == (154, 105)
    assert tables_cuda.tables_counts(2, 3, 2, 4) == (616, 420)
    # the tensor-core count: 3 products x 2 operations x 6 (row, partner)
    # pairs x (2 + 3) columns
    assert tables_cuda.tables_tc_counts(2, 3, 2, 1) == (154, 180)
    assert tables_cuda.tables_tc_counts(2, 3, 2, 4) == (616, 720)


def _tables_inputs(R, m, k, nch, seed=3):
    rs = np.random.default_rng(seed)
    D = rs.gamma(2.0, 2.0, (nch, R, m)).astype(np.float32)
    D[:, :, 0] = 0.0
    inv = (1.0 / np.maximum(0.1 * D, 0.1) ** 2).astype(np.float32)
    inv[:, -1, :] = 0.0  # a padded row
    M = rs.gamma(1.0, 1.0, (nch, R, k)).astype(np.float32)
    O = rs.gamma(2.0, 1.0, (nch, m, k)).astype(np.float32)
    O[:, :, -1] = 0.0  # an empty column: col_nz false
    return D, inv, M, O


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dispatch_sends_cpu_tensors_to_the_plain_body(dtype):
    arrays = _tables_inputs(30, 20, 4, 2)
    args = [torch.from_numpy(a).to(dtype) for a in arrays]
    before = tables_cuda.dense_tables.launches
    cache, phase = dense.tables(*args)
    pc, pp = dense.tables_plain(*args)
    assert tables_cuda.dense_tables.launches == before
    assert cache.Y.dtype == dtype and torch.equal(cache.Y, pc.Y)
    for x, y in zip(phase, pp):
        assert torch.equal(x, y)
    assert not phase.col_nz[:, -1].any() and phase.col_nz[:, 0].all()


def test_dispatch_raises_on_what_the_kernel_does_not_take():
    args = [torch.from_numpy(a) for a in _tables_inputs(6, 5, 3, 1)]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no tables"):
        dense.tables(*meta)
    with pytest.raises(ValueError, match="no tables"):
        dense.tables(args[0], args[1], args[2], meta[3])
    with pytest.raises(ValueError, match="no tables kernel"):
        tables_cuda.dense_tables(*args)


def test_chain_stride_takes_the_call_or_one_chain():
    t = torch.zeros(4, 6, 5)
    assert tables_cuda._lead_stride("D", t, (4,), 30) == 30
    assert tables_cuda._lead_stride("D", t[:1], (4,), 30) == 0
    assert tables_cuda._lead_stride("D", t[0], (4,), 30) == 0
    with pytest.raises(ValueError, match="leading shape"):
        tables_cuda._lead_stride("D", t[:2], (4,), 30)


@pytest.mark.parametrize("shape", [(25, 20, 3), (20, 25, 3), (1363, 9, 7),
                                   (9, 1363, 7)],
                         ids=["modsim-A", "modsim-P", "gist-A", "gist-P"])
def test_plain_tables_match_jax_per_chain(shape):
    """The kernel's plain version on two chains at once, each chain
    against the JAX package's make_phase and rebuild_cache."""
    R, m, k = shape
    D, inv, M, O = _tables_inputs(R, m, k, 2, seed=R + m)
    cache, phase = dense.tables(*(torch.from_numpy(a) for a in (D, inv, M,
                                                                 O)))
    for c in range(2):
        jp = jdense.make_phase(jnp.asarray(inv[c]), jnp.asarray(O[c]))
        jY = np.asarray(jdense.rebuild_cache(
            jnp.asarray(D[c]), jnp.asarray(inv[c]), jnp.asarray(M[c]),
            jnp.asarray(O[c])).Y)
        d, w, mm, o = (x[c].astype(np.float64) for x in (D, inv, M, O))
        y_terms = ((np.abs(d) + mm @ o.T) * w) @ o
        z_terms = w @ (o[:, :, None] * o[:, None, :]).reshape(m, k * k)
        for got, want, terms in (
                (cache.Y[c].numpy(), jY, y_terms),
                (phase.SQ[c].numpy(), np.asarray(jp.SQ), w @ (o * o)),
                (phase.Z[c].numpy(), np.asarray(jp.Z),
                 z_terms.reshape(R * k, k))):
            assert np.all(np.abs(got.astype(np.float64) - want)
                          <= 1e-5 * terms + 1e-30)
        np.testing.assert_array_equal(phase.col_nz[c].numpy(),
                                      np.asarray(jp.col_nz))


def test_tf32_round_is_cvt_rna():
    """To 10 fraction bits, to nearest, ties away from zero, in either
    sign; what is not finite stays; big + small holds x to 2^-22 of it."""
    one = 1.0
    tie, below = one + 2.0 ** -11, one + 2.0 ** -11 - 2.0 ** -23
    x = torch.tensor([tie, below, -tie, 3.0, 0.0, float("inf"),
                      float("nan"), 1.0 + 3 * 2.0 ** -12], dtype=torch.float32)
    got = tables_cuda.tf32_round(x)
    want = [one + 2.0 ** -10, one, -(one + 2.0 ** -10), 3.0, 0.0,
            float("inf")]
    assert got[:6].tolist() == want and torch.isnan(got[6])
    assert got[7].item() == one + 2.0 ** -10
    assert (got[:6].view(torch.int32) & 0x1FFF == 0).all()
    v = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1e3, 1000).astype(np.float32))
    big, small = tables_cuda.tf32_split(v)
    assert torch.equal(tables_cuda.tf32_round(big), big)
    assert torch.equal(tables_cuda.tf32_round(small), small)
    assert ((big.double() + small.double() - v.double()).abs()
            <= 2.0 ** -22 * v.double().abs()).all()


@pytest.mark.parametrize("shape", [(20, 96, 3), (17, 999, 6), (9, 1363, 7),
                                   (40, 300, 5), (100, 2000, 4),
                                   (40, 300, 20), (17, 999, 13),
                                   (100, 2000, 25), (70, 64, 50),
                                   (140, 150, 70), (140, 150, 130)],
                         ids=["short-R20", "short-R17-split", "gist-P",
                              "mma-k5", "mma-split", "tiles-k20",
                              "tiles-short-split-k13", "tiles-split-k25",
                              "tiles-k50", "tiles-k70", "tiles-y2-k130"])
def test_tf32_tables_match_jax_per_chain(shape):
    """mma_kernel's arithmetic (tables_tf32: the 3xTF32 products, the sums
    in the plan's order, column tile by column tile above k = 12) on two
    chains at once, each chain against the JAX package's make_phase and
    rebuild_cache, and against the float64 tables, each entry within
    1e-5 of its summed |terms|; the plan's form, with splits at gist-P,
    mma-split, tiles-short-split-k13 and tiles-split-k25, above k = 64 at
    tiles-k70 and with Y's columns over two tiles at tiles-y2-k130."""
    R, m, k = shape
    plan = tables_cuda.tables_plan(R, m, k, H100_SMS)
    assert plan.form in ("mma", "short")
    assert (plan.S > 1) == (shape in ((17, 999, 6), (9, 1363, 7),
                                      (100, 2000, 4), (17, 999, 13),
                                      (100, 2000, 25)))
    assert (plan.acc_tiles > 1) == (k > tables_cuda.ROWS_MAX_K)
    assert (8 * -(-k // 8) > plan.NC) == (k == 130)  # Y over two tiles
    D, inv, M, O = _tables_inputs(R, m, k, 2, seed=R + m)
    Y, SQ, Z, col_nz = tables_cuda.tables_tf32(
        *(torch.from_numpy(a) for a in (D, inv, M, O)))
    ec, ep = dense.tables_plain(*(torch.from_numpy(a).double()
                                  for a in (D, inv, M, O)))
    for c in range(2):
        jp = jdense.make_phase(jnp.asarray(inv[c]), jnp.asarray(O[c]))
        jY = np.asarray(jdense.rebuild_cache(
            jnp.asarray(D[c]), jnp.asarray(inv[c]), jnp.asarray(M[c]),
            jnp.asarray(O[c])).Y)
        d, w, mm, o = (x[c].astype(np.float64) for x in (D, inv, M, O))
        y_terms = ((np.abs(d) + mm @ o.T) * w) @ o
        z_terms = (w @ (o[:, :, None] * o[:, None, :]).reshape(m, k * k)
                   ).reshape(R * k, k)
        for got, want, exact, terms in (
                (Y[c], jY, ec.Y[c], y_terms),
                (SQ[c], np.asarray(jp.SQ), ep.SQ[c], w @ (o * o)),
                (Z[c], np.asarray(jp.Z), ep.Z[c], z_terms)):
            got = got.numpy().astype(np.float64)
            assert np.all(np.abs(got - want) <= 1e-5 * terms + 1e-30)
            assert np.all(np.abs(got - exact.numpy())
                          <= 1e-5 * terms + 1e-30)
        np.testing.assert_array_equal(col_nz[c].numpy(),
                                      np.asarray(jp.col_nz))


def test_workaround_is_gone():
    """The tables kernel's order makes the subset engines' chain-at-a-time
    tables needless: no such function, and subset_engine's engine
    iterates as every MultichainEngine does."""
    from cogaps_tpu_torch.params import CogapsParams
    from cogaps_tpu_torch.parallel.multichain import stack_device_data
    assert not hasattr(dense, "tables_per_chain")
    cfg = CogapsParams(n_patterns=3, n_iterations=4).engine_config(12, 8)
    Ds = [np.random.default_rng(s).gamma(2.0, 1.0, (12, 8)).astype(
        np.float32) for s in range(2)]
    eng = distributed.subset_engine(stack_device_data(Ds, None, cfg, "cpu"),
                                    cfg, "cpu")
    assert "iterate" not in vars(eng)


CLAIM_SHAPES = [(16, 1024, 1363), (8, 512, 1363), (1, 1, 1), (1, 100, 50),
                (4, 1024, 1), (200, 1024, 1363), (1, 1024, 100000)]


@pytest.mark.parametrize("shape", CLAIM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_claim_plan_covers_the_rows_once_and_fits(shape):
    NCH, B, NR = shape
    plan = mosaic.claim_plan(NCH, B, NR, H100_SMS)
    ranges = plan.ranges(NR)
    assert len(ranges) == plan.blocks >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == NR
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2
    assert plan.rows <= mosaic.CLAIM_ROWS and plan.smem <= 48 * 1024
    assert plan.threads % 32 == 0 and plan.threads <= mosaic.CLAIM_THREADS
    assert 4 * plan.threads >= min(B, 4 * mosaic.CLAIM_THREADS)
    fill = min(NR, -(-H100_SMS // NCH), mosaic.CLAIM_BLOCKS)
    assert plan.blocks == max(fill, -(-NR // mosaic.CLAIM_ROWS))
