"""Where the sweep kernel (cogaps_tpu_torch/csrc/sweep.cu) keeps each
chain's state: ops/sweep_cuda.smem_plan and the scratch layout beside it.

The plan is plain Python, so it is checked here at chip_smoke.py's
phase-3 shapes and at edge widths: offsets disjoint, 16-byte aligned and
within a block's shared memory beside the kernel's static part; the
groups of GROUPS placed whole in their order of priority, one passed
over only when it did not fit; GIST's P sampler wholly in shared memory
and its A sampler all but Z. The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import pytest

from cogaps_tpu_torch.ops import sweep_cuda
from cogaps_tpu_torch.ops.sweep_cuda import (GROUPS, PLACED, SMEM_BLOCK,
                                             STATIC_SMEM, pack, placed_bytes,
                                             scratch_layout, smem_plan)

CSRC = Path(sweep_cuda.__file__).resolve().parent.parent / "csrc"

# (NR, K, C, B, nch): chip_smoke.py phase 3's K1 and K2 cases
PHASE3 = {
    "GIST A": (1363, 7, 8192, 1024, 4),
    "GIST P": (9, 7, 1024, 32, 4),
    "5000-row": (5000, 10, 32768, 1024, 4),
    "K2 A": (2000, 10, 16384, 1024, 4),
    "K2 P": (10000, 10, 65536, 1024, 4),
}
EDGES = [(NR, K, C, B, nch) for NR, C in ((9, 1024), (1363, 8192),
                                           (300, 2048))
         for K in (1, 7, 64) for B in (1, 32, 33, 1024) for nch in (1, 200)]


def aligned(n):
    return -(-n // 16) * 16


BUDGET = SMEM_BLOCK - STATIC_SMEM


def check_plan(plan, NR, K, C, budget):
    sizes = placed_bytes(NR, K, C)
    spans = sorted((off, off + sizes[n]) for n, off in plan.offsets.items()
                   if off is not None)
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0  # disjoint
    assert all(off % 16 == 0 for off, _ in spans)
    assert plan.nbytes % 16 == 0 and plan.nbytes <= budget
    assert all(end <= plan.nbytes for _, end in spans)
    # priority: each group, whole, sits right after the ones placed before
    # it, or stays global, whole, because it no longer fit
    top = 0
    for group in GROUPS:
        where = [plan.offsets[n] for n in group]
        size = sum(aligned(sizes[n]) for n in group)
        if where[0] is None:
            assert all(w is None for w in where)
            assert top + size > budget, group
        else:
            for name, off in zip(group, where):
                assert off == top, name
                top += aligned(sizes[name])
    assert top == plan.nbytes
    assert [n for g in GROUPS for n in g] == list(PLACED)


@pytest.mark.parametrize("case", list(PHASE3))
def test_plan_at_phase3_shapes(case):
    NR, K, C, B, nch = PHASE3[case]
    check_plan(smem_plan(NR, K, C, B, nch), NR, K, C, BUDGET)


@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
def test_plan_at_edge_widths(shape):
    NR, K, C, B, nch = shape
    check_plan(smem_plan(NR, K, C, B, nch), NR, K, C, BUDGET)


def test_gist_p_wholly_and_gist_a_all_but_z_resident():
    p = smem_plan(*PHASE3["GIST P"]).offsets
    assert all(p[n] is not None for n in PLACED)
    a = smem_plan(*PHASE3["GIST A"]).offsets
    assert [n for n in PLACED if a[n] is None] == ["Z"]


def test_claims_first_at_the_large_shapes():
    """The 5000-row and K2 shapes keep their claim tables (the atomics)
    in shared memory, and the rest of their state, too large to stage
    whole, global with the L1 for it."""
    for case in ("5000-row", "K2 A"):
        off = smem_plan(*PHASE3[case]).offsets
        assert [n for n in PLACED if off[n] is not None] == ["rmin", "amin"]
    off = smem_plan(*PHASE3["K2 P"]).offsets  # 65536 slot claims: 256 KB
    assert [n for n in PLACED if off[n] is not None] == ["rmin"]


def test_shape_too_big_leaves_everything_global():
    plan = smem_plan(100_000, 64, 1 << 20, 1024, 4)
    assert plan.nbytes == 0 and all(v is None for v in plan.offsets.values())
    stride, g_rmin, g_amin, g_hole = scratch_layout(100_000, 1 << 20, plan)
    assert (g_rmin, g_amin, g_hole) == (0, 100_001, 100_001 + (1 << 20) + 1)
    assert stride == g_hole + (1 << 20) // 4


@pytest.mark.parametrize("NR, K, C", [(300, 7, 8192), (1363, 7, 8192),
                                       (9, 64, 1024)])
def test_every_width_class_and_chain_count_gets_the_block_budget(NR, K, C):
    """The plan depends on the shape of a chain's state only: one-warp
    blocks of more chains than SMs take the same placement as one chain
    of 1024 lanes."""
    plans = {smem_plan(NR, K, C, B, nch) for B in (1, 32, 33, 1024)
             for nch in (1, 132, 264, 1000)}
    assert plans == {pack(NR, K, C, budget=BUDGET)}


@pytest.mark.parametrize("names", [(), ("rmin", "amin", "hole"),
                                   ("rmin", "amin", "hole", "mass", "elem"),
                                   PLACED])
def test_forced_placement_packs_in_order(names):
    """A forced placement (the card tests' keyword) packs the named arrays
    in PLACED's order, fit or not."""
    plan = pack(1363, 7, 8192, names=names)
    sizes = placed_bytes(1363, 7, 8192)
    assert {n for n in PLACED if plan.offsets[n] is not None} == set(names)
    assert plan.nbytes == sum(aligned(sizes[n]) for n in names)


@pytest.mark.parametrize("shape", list(PHASE3.values()) + EDGES[:6])
def test_scratch_holds_only_the_global_claims(shape):
    NR, K, C, B, nch = shape
    plan = smem_plan(NR, K, C, B, nch)
    stride, *offs = scratch_layout(NR, C, plan)
    ints = {"rmin": NR + 1, "amin": C + 1, "hole": -(-C // 4)}
    spans = []
    for name, off in zip(("rmin", "amin", "hole"), offs):
        assert (off < 0) == (plan.offsets[name] is not None), name
        if off >= 0:
            spans.append((off, off + ints[name]))
    assert sum(b - a for a, b in spans) == stride
    assert all(b <= stride for _, b in spans)


def test_static_smem_matches_sweep_shared():
    """STATIC_SMEM is sweep_common.cuh's SweepShared, the kernel's only
    static shared memory."""
    src = (CSRC / "sweep_common.cuh").read_text()
    body = re.search(r"struct SweepShared \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"int (\w+)", body) == ["warp_sums", "rank_to_src",
                                             "n", "cnt"]
    assert "int warp_sums[32];" in body and "int rank_to_src[kMaxB + 1];" in body
    assert "int n, done, n_processed;" in body and "int cnt[8];" in body
    assert STATIC_SMEM == 4 * (32 + 1025 + 3 + 8)


def test_one_warp_class_has_no_block_barrier_in_source():
    """The one-warp instantiation synchronises through block_sync and
    block_scan only, whose kWarp branches use __syncwarp and shuffles:
    __syncthreads appears nowhere else in the sweep's source."""
    src = (CSRC / "sweep_common.cuh").read_text()
    assert "__syncthreads" not in (CSRC / "sweep.cu").read_text()
    assert "__syncthreads" not in (CSRC / "dense_model.cuh").read_text()
    helpers = {}
    for name in ("block_sync", "block_scan"):
        m = re.search(r"__device__ (?:__forceinline__ )?\w+ " + name
                      + r"\(.*?\n\}\n", src, re.S)
        helpers[name] = m.group(0)
        # the kWarp branch comes first and calls no block barrier
        warp_part, _, rest = m.group(0).partition("else")
        assert "if constexpr (kWarp)" in warp_part, name
        assert "__syncthreads" not in warp_part and "__syncthreads" in rest
    rest = src
    for text in helpers.values():
        rest = rest.replace(text, "")
    code = "\n".join(line.split("//")[0] for line in rest.splitlines())
    assert "__syncthreads" not in code
