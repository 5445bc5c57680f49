"""K3's launch plans (ops/span_cuda.py) on the CPU: where the sweep stage
keeps its chain state, the rebuild's order of sums, the cluster size
rule at 16, and the launch's shared memory and plan layout.

The sweep stage of csrc/span.cu runs K1's sweep on state staged in the
rank-0 CTA's shared memory: span_cuda.sweep_plan places the groups of
ops/sweep_cuda.GROUPS as smem_plan does for K1, in the region the
rebuild's tiles take in turn. The rebuild's sums run in an order of the
sampler's shape alone (span_cuda.chunks), so a chain's tables have the
same bits whatever the cluster size and chain count; rebuild_tables_split
is the plain model of that order."""

import numpy as np
import pytest
import torch

from cogaps_tpu_torch.ops import span, span_cuda, sweep_cuda
from cogaps_tpu_torch.parallel import multichain
from cogaps_tpu_torch.params import CogapsParams

torch.set_num_threads(1)

# GIST 1363 x 9 at k=7: the A and P samplers' (rows, capacity, batch)
GIST_SIDES = {"A": (1363, 8192, 1024), "P": (9, 1024, 32)}


@pytest.mark.parametrize("side", ["A", "P"])
def test_sweep_plan_matches_k1_at_gist(side):
    """The sweep stage's placement fits an H100 block beside the kernel's
    static shared memory and the fixed part, and places the arrays K1's
    smem_plan places: at GIST A all but Z (226,496 bytes), at GIST P all."""
    NR, C, B = GIST_SIDES[side]
    k = 7
    got = span_cuda.sweep_plan(NR, k, C)
    k1 = sweep_cuda.smem_plan(NR, k, C, B, 16)
    assert got.offsets == k1.offsets and got.nbytes == k1.nbytes
    placed = {n for n, off in got.offsets.items() if off is not None}
    want = set(sweep_cuda.PLACED) - ({"Z"} if side == "A" else set())
    assert placed == want
    if side == "A":
        assert got.nbytes == 226_496
    assert (got.nbytes + span_cuda.fixed_bytes(k) + sweep_cuda.STATIC_SMEM
            <= sweep_cuda.SMEM_BLOCK == 232_448)


@pytest.mark.parametrize("G,S,k,nch", [
    (1363, 9, 7, 16), (5005, 100, 10, 4), (20000, 100, 10, 16),
    (100, 100, 88, 1), (6000, 100, 20, 16)])
def test_span_launch_fits_a_block(G, S, k, nch):
    """At every cluster size, span_kernel's dynamic shared memory (fixed
    part, then the larger of the rebuild's tiles and the sweeps'
    placements) fits beside its static part; the plan's ints are each
    side's six plan fields, then its nine byte offsets."""
    cfg = CogapsParams(n_patterns=k).engine_config(G, S)
    threads = span_cuda.block_threads(cfg.batch_a, cfg.batch_p, k)
    places = (span_cuda.sweep_plan(G, k, cfg.capacity_a),
              span_cuda.sweep_plan(S, k, cfg.capacity_p))
    for cl in span_cuda.CLUSTER_SIZES:
        plans = (span_cuda.rebuild_plan(G, S, k, threads, cl),
                 span_cuda.rebuild_plan(S, G, k, threads, cl))
        smem = span_cuda.smem_bytes(plans, k, places)
        assert smem + sweep_cuda.STATIC_SMEM <= sweep_cuda.SMEM_BLOCK
        shape = span_cuda.LaunchShape(cl, *plans, smem, *places)
        ints = shape.plan_ints()
        assert len(ints) == 2 * (6 + len(sweep_cuda.PLACED))
        assert ints[:6] == list(plans[0]) and ints[15:21] == list(plans[1])
        assert ints[6:15] == [-1 if o is None else o
                              for o in places[0].slots]
    assert span_cuda.span_fits(G, S, k, cfg.batch_a, cfg.batch_p)


@pytest.mark.parametrize("NR,m,k", [
    (1363, 9, 7), (9, 1363, 7), (5005, 100, 10), (100, 5005, 10),
    (20000, 100, 10), (100, 20000, 10), (100, 100, 88), (2100, 5, 3)])
def test_rebuild_order_is_the_shapes_alone(NR, m, k):
    """The chunks (each sum over its chunk's partners in order, the
    partials added in chunk order) are the same for every cluster size
    and thread count; the chunks cover the partners once, in order."""
    orders = {(p.cj, p.nchunk) for p in (
        span_cuda.rebuild_plan(NR, m, k, threads, cl)
        for cl in span_cuda.CLUSTER_SIZES for threads in (64, 256, 1024))}
    assert orders == {span_cuda.chunks(NR, m)}
    cj, n = span_cuda.chunks(NR, m)
    assert cj % 4 == 0 and (n - 1) * cj < m <= n * cj
    assert n == 1 or cj <= span_cuda.MAX_CHUNK or NR < span_cuda.FEW_ROWS


def test_split_tables_equal_for_every_cluster_size_and_chain_count():
    """At one shape with several chunks on both sides (300 x 600 rows and
    partners), rebuild_tables_split gives the same bits at every cluster
    size, and a chain's bits alone equal its bits beside the others."""
    rs = np.random.default_rng(8)
    G, S, k, nch = 300, 600, 4, 3
    Ds = [rs.gamma(2.0, 2.0, (G, S)).astype(np.float32) for _ in range(nch)]
    cfg = CogapsParams(n_patterns=k).engine_config(G, S)
    data = multichain.stack_device_data(Ds, None, cfg, "cpu")
    M_a = torch.as_tensor(rs.gamma(2.0, 1.0, (nch, G, k)).astype(np.float32))
    M_p = torch.as_tensor(rs.gamma(2.0, 1.0, (nch, S, k)).astype(np.float32))
    assert span_cuda.chunks(G, S)[1] > 1 and span_cuda.chunks(S, G)[1] > 1
    ref = span_cuda.rebuild_tables_split(data, M_a, M_p, 1)
    for cl in span_cuda.CLUSTER_SIZES[:-1]:
        for x, y in zip(span_cuda.rebuild_tables_split(data, M_a, M_p, cl),
                        ref):
            assert torch.equal(x, y)
    one = multichain.stack_device_data(Ds[1:2], None, cfg, "cpu")
    alone = span_cuda.rebuild_tables_split(one, M_a[1:2], M_p[1:2], 16)
    for x, y in zip(alone, ref):
        assert torch.equal(x[0], y[1])
    plain = span.rebuild_tables_plain(data, M_a, M_p)
    for x, y in zip(ref, plain):  # float64 sums rounded once, either order
        if x.dtype == torch.bool:
            assert torch.equal(x, y)
        else:
            assert (x - y).abs().max() <= 1e-6 * y.abs().max()


@pytest.mark.parametrize("nch,holds16,want", [
    (1, 7, 16), (4, 7, 16), (4, 4, 16), (4, 3, 8), (5, 4, 8), (8, 8, 16),
    (9, 8, 8), (4, 0, 8)])
def test_cluster_size_takes_16_only_where_the_card_holds_it(nch, holds16,
                                                            want):
    """With a fake card that keeps `holds16` clusters of 16 resident (and
    every smaller size freely), 16 is picked only where all nch chains'
    clusters are resident and take at most one SM each of 132."""
    def max_active(cl):
        return holds16 if cl == 16 else 132 // cl

    assert span_cuda.cluster_size(nch, 132, max_active) == want
