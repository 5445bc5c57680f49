"""The per-call tables kernel's plan, counts and dispatch
(cogaps_tpu_torch/ops/tables_cuda.py, models/dense.tables) on the CPU, and
F4's row split (probes/mosaic.claim_plan).

The kernel (csrc/tables.cu) runs only on the card, where
tests/test_torch_cuda.py holds it to its plain version. Here: the plan
fixes every chain's summation order from (R, m, k) and the SM count
alone, its contraction chunks cover [0, m) once and in order, its quads
cover every table entry, and its shared memory and registers fit an H100
block, at the shapes the per-call route runs (GIST, 5000 x 2000, 20000 x
100, a 2500 x 2000 sharded block) and at edges of m and k; tables_counts
on a case counted by hand; the dispatcher gives CPU tensors of either
float type to the plain version without a launch, raises for anything
the kernel does not take, and the plain version, with a leading chain
dimension, matches the JAX package's make_phase and rebuild_cache to
float32 rounding (1e-5 of the summed terms' magnitude; for Y of
(|D| + |M| |O|^T) invS2 against |O|, since Y cancels)."""

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
    "k25-few-rows": (3, 5000, 25), "k50": (40, 30, 50),
}


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
    assert plan.smem <= 227 * 1024 and plan.registers <= 255
    assert plan.G * plan.RT == tables_cuda.THREADS
    assert plan.row_tiles * plan.RT >= R > (plan.row_tiles - 1) * plan.RT
    assert plan.nq == -(-k // 4) + -(-(k * (k + 1) // 2) // 4)
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
    """rows_kernel (PQ 0) wherever k <= 12; quads_kernel, its quads spread
    over a row's threads where the rows are few, for a larger k."""
    plan = tables_cuda.tables_plan(*shape, H100_SMS)
    assert (plan.PQ == 0) is rows
    if not rows and shape[0] < 64:
        assert plan.G > 1


@pytest.mark.parametrize("R,chunk", [(9, 64), (32, 128), (64, 256),
                                     (100, 256)])
def test_plan_chunks_shorter_for_fewer_rows(R, chunk):
    """A long contraction's chunk where one row tile cannot fill the
    card: 4 R partners, from 64 to 256."""
    plan = tables_cuda.tables_plan(R, 4000, 7, H100_SMS)
    assert plan.CH == chunk and plan.S == -(-4000 // chunk)


def test_plan_fills_the_card_where_one_chain_can():
    """Few rows and a long contraction: the chunks give the blocks (P at
    20000 x 100), and one chunk where the rows alone do (A)."""
    p = tables_cuda.tables_plan(100, 20000, 10, H100_SMS)
    assert p.blocks >= 64 and p.S == p.blocks
    a = tables_cuda.tables_plan(20000, 100, 10, H100_SMS)
    assert a.S == 1 and a.blocks >= H100_SMS


def test_tables_counts_by_hand():
    """R=2, m=3, k=2 (3 pairs): bytes 4 (2*6 D and W + 4 M + 6 O + 8 Y
    and SQ + 8 Z) + 2 col_nz = 154; operations 6 elements x (8 + 2 + 6) +
    3 partners x 3 pairs = 105."""
    assert tables_cuda.tables_counts(2, 3, 2, 1) == (154, 105)
    assert tables_cuda.tables_counts(2, 3, 2, 4) == (616, 420)


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
