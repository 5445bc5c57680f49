"""F1-F8: the Mosaic probes' functions, each a kernel of
csrc/probe_mosaic.cu beside its plain PyTorch version.

The TPU sites (tools/, file:line of the pallas_call):
  F1 bdot        probe_mosaic.py:51, 72, 92; probe_mosaic2.py:33 (bdot_case);
                 probe_mosaic3.py:33 (k1-k3), 85 (bdot_marg);
                 probe_mosaic4.py:35 (bdot_marg)
  F2 prefix      probe_mosaic2.py:33 (tri_case)
  F3 first_wins  probe_mosaic.py:213; probe_mosaic2.py:33 (match_case);
                 probe_mosaic3.py:85 (match_marg); probe_mosaic4.py:35
                 (match_marg); probe_mosaic5.py:27 (k_match)
  F4 claim_min   probe_mosaic2.py:33 (ohmin_case, row form);
                 probe_mosaic3.py:85, probe_mosaic4.py:35 (ohmin_marg, lane
                 form)
  F5 elem_chain  probe_mosaic.py:187; probe_mosaic2.py:33 (elem_case);
                 probe_mosaic3.py:85, probe_mosaic4.py:35 (elem_marg)
  F6 while_sum   probe_mosaic.py:116 ("count"); probe_mosaic2.py:197
                 ("until")
  F7 reduce3d    probe_mosaic.py:131 ("sum"), 145 ("min")
  F8 uniform     probe_mosaic.py:163; probe_mosaic2.py:214

How a kernel and its plain version agree on the card: F3-F6 and F8 bit
for bit (integer results, or the same float32 operations under
-fmad=false; F6 is exact for integer-valued inputs, whose float32 sums
do not depend on the order); F1 and F2 sum in float32 against the plain
version's float64, within 1e-5 of the sum of the absolute terms; F7's sum
is float64 rounded once on both sides (within 1e-6 relative), its min
exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..ops import rng
from ..ops.cuda_build import check, sm_count
from . import bind, launch, on_card

F32 = torch.float32
MAX_LANES = 1024  # F2, F3 and F6 hold a chain's lanes in one block

_SIGNATURES = {
    "probe_bdot": "iiiiiiiiippppp",
    "probe_prefix": "iippp",
    "probe_first_wins": "iippp",
    "probe_claim_min": "iiiiiippp",
    "probe_elem_chain": "iippp",
    "probe_while_sum": "iippp",
    "probe_reduce3d": "iiiippp",
    "probe_uniform": "iippp",
    "probe_empty": "p",
}


def build() -> tuple:
    """Compile csrc/probe_mosaic.cu and load it: (library, report)."""
    return bind("probe_mosaic", _SIGNATURES)


def empty(device) -> None:
    """One launch of a kernel that does nothing, on the CUDA `device`: the
    floor under every probe's time (probes/__main__.launch_floor)."""
    with torch.cuda.device(device):
        launch(empty, build()[0].probe_empty)


empty.launches = 0


def _lanes(name, B):
    if B > MAX_LANES:
        raise ValueError(f"{name} takes at most {MAX_LANES} lanes, not {B}")


# ---------------------------------------------------------------- F1
# csrc/probe_mosaic.cu's kSkinnyK, kSkinnyThreads, kSkinnyTX and
# kSkinnyChunk, and the shapes of its bdot_tile_kernel launches
SKINNY_K = 16  # the bytes regime's largest K
SKINNY_THREADS = 256  # a block: SKINNY_TX column units x 32 t rows
SKINNY_TX = 8
SKINNY_CHUNK = 256  # t of a staged in shared memory at a time


class TileShape(NamedTuple):
    groups: int  # thread groups splitting each chunk's t
    chunk_t: int  # t of a and b staged at a time
    stages: int  # chunks in flight


# by side; a thread's tile is 4 x 4 in both
TILES = {64: TileShape(1, 32, 2), 32: TileShape(4, 32, 4)}
# T splits: none where the blocks already fill FILLED of a wave; else
# enough to fill one, more up to WAVES blocks an SM while each split keeps
# SPLIT_T t (the bytes kernel runs two blocks an SM, and a split shorter
# than its chunk costs more in partial sums than it gains)
FILLED = {"bytes": 1.0, "operations": 0.75}
WAVES = {"bytes": 2, "operations": 1}
SPLIT_T = {"bytes": SKINNY_CHUNK, "operations": 32}


class BdotPlan(NamedTuple):
    """How one bdot call runs: `regime` "bytes" (K <= SKINNY_K) or
    "operations"; a block covers `tile_k` rows i and `tile_b` columns j
    of one chain's (K, B) output, over one of `splits` T ranges, staging
    `chunk_t` t of its inputs in shared memory at a time; `vec`: 16-byte
    loads of b (and of a, operations regime); `grid` (column tiles, row
    tiles, NCH * splits) of `threads` (x, y) blocks with `smem` bytes of
    static shared memory; `scratch` the (splits, NCH, K, B) float32
    partial sums, None with one split."""
    regime: str
    tile_k: int
    tile_b: int
    chunk_t: int
    vec: bool
    splits: int
    grid: tuple
    threads: tuple
    smem: int
    scratch: Optional[tuple]


def _splits(T, blocks, n_sm, regime):
    """How many T ranges to split a call of `blocks` blocks (a range) into
    on n_sm SMs, as FILLED, WAVES and SPLIT_T say."""
    if blocks >= FILLED[regime] * n_sm:
        return 1
    least = -(-n_sm // blocks)
    most = WAVES[regime] * n_sm // blocks
    return min(T, max(least, min(most, T // SPLIT_T[regime])))


@functools.cache
def bdot_plan(NCH: int, T: int, K: int, B: int, n_sm: int = 132) -> BdotPlan:
    """The plan of bdot on (NCH, T, K) and (NCH, T, B) on a card of n_sm
    SMs.

    Bytes regime (K <= 16): a block of SKINNY_THREADS takes all K rows
    and a strip of SKINNY_TX column units (a unit 4 columns where B % 4
    == 0, so b is read 16 bytes a thread, else 1), its 32 t rows
    splitting t.

    Operations regime: 64 x 64 tiles of (K, B) where NCH x tiles fill at
    least 3/4 of a wave, else 32 x 32 tiles whose blocks split each chunk's
    t four ways.

    Where NCH x strips (tiles) leave SMs idle, T is split (_splits)."""
    if min(NCH, T, K, B) < 1:
        raise ValueError(f"empty bdot ({NCH}, {T}, {K}) x ({NCH}, {T}, {B})")
    if K <= SKINNY_K:
        vec = B % 4 == 0
        V = 4 if vec else 1
        strips = -(-B // (V * SKINNY_TX))
        splits = _splits(T, NCH * strips, n_sm, "bytes")
        smem = 4 * (2 * SKINNY_CHUNK * K
                    + SKINNY_THREADS // 32 * K * SKINNY_TX * V)
        return BdotPlan("bytes", K, SKINNY_TX * V, SKINNY_CHUNK, vec, splits,
                        (strips, 1, NCH * splits), (SKINNY_THREADS, 1), smem,
                        (splits, NCH, K, B) if splits > 1 else None)
    vec = K % 4 == 0 and B % 4 == 0
    tile = 64
    if NCH * -(-K // 64) * -(-B // 64) < FILLED["operations"] * n_sm:
        tile = 32  # 4x the blocks
    tiles = -(-K // tile) * -(-B // tile)
    splits = _splits(T, NCH * tiles, n_sm, "operations")
    shape = TILES[tile]
    # the staged chunks of a and b; the t groups' sums reuse them
    smem = 4 * shape.stages * shape.chunk_t * 2 * tile
    return BdotPlan("operations", tile, tile, shape.chunk_t, vec, splits,
                    (-(-B // tile), -(-K // tile), NCH * splits),
                    (tile * tile // 16 * shape.groups, 1), smem,
                    (splits, NCH, K, B) if splits > 1 else None)


def _aligned(t):
    """t, or a copy of it in new (16-byte aligned) memory."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bdot_plain(a, b):
    """float64 products and sums, rounded once to float32."""
    return torch.einsum("cti,ctb->cib", a.double(), b.double()).float()


def bdot(a: torch.Tensor, b: torch.Tensor,
         plan: Optional[BdotPlan] = None) -> torch.Tensor:
    """out[c, i, j] = sum_t a[c, t, i] b[c, t, j]: (NCH, T, k) and
    (NCH, T, B) float32 -> (NCH, k, B), the batched dot_general of the
    probes (contracting T, batching NCH). On the card it runs as `plan`
    says (default bdot_plan of the shapes and the card's SMs)."""
    NCH, T, K = a.shape
    B = b.shape[-1]
    check("a", a, F32, (NCH, T, K), a.device)
    check("b", b, F32, (NCH, T, B), a.device)
    if not on_card(a):
        return bdot_plain(a, b)
    if plan is None:
        plan = bdot_plan(NCH, T, K, B, sm_count(a.device.index or 0))
    if plan.vec:
        a, b = _aligned(a), _aligned(b)
    out = torch.empty((NCH, K, B), dtype=F32, device=a.device)
    part = (None if plan.scratch is None else
            torch.empty(plan.scratch, dtype=F32, device=a.device))
    launch(bdot, build()[0].probe_bdot, NCH, T, K, B,
           ("bytes", "operations").index(plan.regime), plan.tile_k,
           plan.tile_b, int(plan.vec), plan.splits, a.data_ptr(),
           b.data_ptr(), None if part is None else part.data_ptr(),
           out.data_ptr())
    return out


bdot.launches = 0


def bdot_counts(a, b):
    NCH, T, K = a.shape
    B = b.shape[-1]
    return 4 * NCH * (T * K + T * B + K * B), 2 * NCH * T * K * B


# ---------------------------------------------------------------- F2
def prefix_plain(x):
    return torch.cumsum(x.double(), 1).float()


def prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the lanes of (NCH, B) float32, B <=
    1024: the probe's x @ tri_le(B, B)."""
    NCH, B = x.shape
    check("x", x, F32, (NCH, B), x.device)
    _lanes("prefix", B)
    if not on_card(x):
        return prefix_plain(x)
    out = torch.empty_like(x)
    launch(prefix, build()[0].probe_prefix, NCH, B, x.data_ptr(),
           out.data_ptr())
    return out


prefix.launches = 0


def prefix_counts(x):
    return 8 * x.numel(), x.numel()


# ---------------------------------------------------------------- F3
def first_wins_plain(r):
    """The probes' broadcast compare: m[c, l, j] = (r[c, l] == r[c, j]),
    summed over l < j."""
    B = r.shape[1]
    lane = torch.arange(B, device=r.device)
    earlier = lane[:, None] < lane[None, :]
    m = r[:, :, None] == r[:, None, :]
    return (m & earlier).sum(1, dtype=torch.int32)


def first_wins(r: torch.Tensor) -> torch.Tensor:
    """For each lane of (NCH, B) float32 values, B <= 1024, the count of
    earlier lanes of its chain holding the same value (int32); a lane is
    kept, first-wins, where the count is 0."""
    NCH, B = r.shape
    check("r", r, F32, (NCH, B), r.device)
    _lanes("first_wins", B)
    if not on_card(r):
        return first_wins_plain(r)
    out = torch.empty((NCH, B), dtype=torch.int32, device=r.device)
    launch(first_wins, build()[0].probe_first_wins, NCH, B, r.data_ptr(),
           out.data_ptr())
    return out


first_wins.launches = 0


def first_wins_counts(r):
    """r read, counts written; a compare and an add per pair l < j."""
    NCH, B = r.shape
    return 8 * NCH * B, NCH * B * (B - 1)


# ---------------------------------------------------------------- F4
CLAIM_FORMS = ("row", "lane")


def claim_min_plain(r, n_rows, form):
    """The probes' one-hot minimum: where(rows == r, lane, B), its min
    over lanes (row form, (NCH, NR)) or over rows (lane form, (NCH, B))."""
    B = r.shape[1]
    rows = torch.arange(n_rows, dtype=F32, device=r.device)
    lane = torch.arange(B, dtype=torch.int32, device=r.device)
    hit = torch.where(rows[None, :, None] == r[:, None, :], lane, B)
    return hit.amin(dim=2 if form == "row" else 1)


CLAIM_ROWS = 12288  # csrc/probe_mosaic.cu's kClaimRows: 48 KB of claims
# a row-form block's most threads (four lanes a thread) and a chain's most
# blocks: on an NVIDIA H100 80GB HBM3 at 700 W, at (16,1024) and (8,512),
# NR=1363, 512 threads and 2 to 4 blocks a chain were the quickest of
# 256/512/1024 threads and 1, 2, 4, 8 blocks or enough to fill the SMs
# (0.0056 against 0.0058-0.0062 ms a launch)
CLAIM_THREADS = 512
CLAIM_BLOCKS = 4


class ClaimPlan(NamedTuple):
    """The row form's split: `blocks` blocks a chain of `rows` rows each
    (the last shorter) and `threads` threads, `smem` bytes of claims a
    block."""
    blocks: int
    rows: int
    threads: int
    smem: int

    def ranges(self, n_rows: int) -> list:
        """The rows [lo, hi) of each block of a chain."""
        return [(b * self.rows, min((b + 1) * self.rows, n_rows))
                for b in range(self.blocks)]


@functools.lru_cache(maxsize=256)
def claim_plan(NCH: int, B: int, n_rows: int, n_sm: int) -> ClaimPlan:
    """How the row form splits each chain's n_rows rows over blocks: as
    many as fill the n_sm SMs with the NCH chains, at most CLAIM_BLOCKS
    and at least as many as keep a block to CLAIM_ROWS rows."""
    want = max(1, min(n_rows, -(-n_sm // NCH), CLAIM_BLOCKS))
    rows = min(-(-n_rows // want), CLAIM_ROWS)
    threads = min(CLAIM_THREADS, 32 * -(-B // 32))
    return ClaimPlan(blocks=-(-n_rows // rows), rows=rows, threads=threads,
                     smem=4 * rows)


def claim_min(r: torch.Tensor, n_rows: int, form: str) -> torch.Tensor:
    """Row form: claim[c, row] = the least lane of chain c whose value is
    `row`, else B (NCH, n_rows), the claim table of K1's conflict rule;
    lane form: hit[c, lane] = lane where r[c, lane] is a row of
    [0, n_rows), else B (NCH, B). int32; r (NCH, B) float32."""
    NCH, B = r.shape
    check("r", r, F32, (NCH, B), r.device)
    if form not in CLAIM_FORMS:
        raise ValueError(f"form is one of {CLAIM_FORMS}, not {form!r}")
    if n_rows < 1:
        raise ValueError(f"n_rows must be positive, not {n_rows}")
    if not on_card(r):
        return claim_min_plain(r, n_rows, form)
    out = torch.empty((NCH, n_rows if form == "row" else B),
                      dtype=torch.int32, device=r.device)
    plan = claim_plan(NCH, B, n_rows, sm_count(r.device.index or 0))
    launch(claim_min, build()[0].probe_claim_min, CLAIM_FORMS.index(form),
           NCH, B, n_rows, plan.rows, plan.threads, r.data_ptr(),
           out.data_ptr())
    return out


claim_min.launches = 0


def claim_min_counts(r, n_rows, form):
    """Row form: r read, the table set and written once, a claim a lane;
    lane form: r read, hits written, a range and integer test a lane."""
    NCH, B = r.shape
    if form == "row":
        return 4 * NCH * (B + n_rows), NCH * (B + n_rows)
    return 8 * NCH * B, 4 * NCH * B


# ---------------------------------------------------------------- F5
ELEM_OPS = 50  # the probes' chain length


def elem_chain_plain(x):
    for _ in range(ELEM_OPS):
        x = x * 1.0001 + 0.001
    return x


def elem_chain(x: torch.Tensor) -> torch.Tensor:
    """50 times x = x * 1.0001 + 0.001 on float32 x of any shape."""
    check("x", x, F32, x.shape, x.device)
    if not on_card(x):
        return elem_chain_plain(x)
    out = torch.empty_like(x)
    launch(elem_chain, build()[0].probe_elem_chain, x.numel(), ELEM_OPS,
           x.data_ptr(), out.data_ptr())
    return out


elem_chain.launches = 0


def elem_chain_counts(x):
    return 8 * x.numel(), 2 * ELEM_OPS * x.numel()


# ---------------------------------------------------------------- F6
WHILE_FORMS = ("count", "until")


def while_trips(x, form):
    """Iterations of the loop: ceil(x[0, 0]) (at least 0) for "count",
    the least t with t * numel >= 100 for "until"."""
    if form == "count":
        return max(0, int(torch.ceil(x.reshape(-1)[0]).item()))
    return -(-100 // x.numel())


def while_sum_plain(x, form):
    if form == "count":
        s = x.sum()
        trip = x.reshape(-1)[0].item()
        i, acc = 0.0, torch.zeros((), dtype=F32, device=x.device)
        while i < trip:
            i += 1.0
            acc = acc + s
        return acc.reshape(1, 1)
    a = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    while a.sum().item() < 100.0:
        a = a + 1.0
        acc = acc + x
    return acc


def while_sum(x: torch.Tensor, form: str) -> torch.Tensor:
    """A loop whose trip count comes from device memory, on float32 x of
    at most 1024 elements. "count" (probe_mosaic.py:116): i = 0, acc = 0;
    while i < x[0, 0]: i += 1, acc += sum(x); returns acc as (1, 1).
    "until" (probe_mosaic2.py:197): a = acc = 0 (x's shape); while
    sum(a) < 100: a += 1, acc += x; returns acc."""
    check("x", x, F32, x.shape, x.device)
    if form not in WHILE_FORMS:
        raise ValueError(f"form is one of {WHILE_FORMS}, not {form!r}")
    if x.numel() < 1:
        raise ValueError("while_sum needs at least one element")
    _lanes("while_sum", x.numel())
    if not on_card(x):
        return while_sum_plain(x, form)
    out = torch.empty((1, 1) if form == "count" else x.shape, dtype=F32,
                      device=x.device)
    launch(while_sum, build()[0].probe_while_sum, WHILE_FORMS.index(form),
           x.numel(), x.data_ptr(), out.data_ptr())
    return out


while_sum.launches = 0


def while_sum_counts(x, form):
    """x read once; "count": the sum once and an add a trip, one value
    written; "until": per trip the sum of a and two adds an element."""
    n, trips = x.numel(), while_trips(x, form)
    if form == "count":
        return 4 * n + 4, n + trips
    return 8 * n, 3 * n * trips


# ---------------------------------------------------------------- F7
REDUCE_FORMS = ("sum", "min")


def reduce3d_plain(x, form):
    if form == "sum":
        xd = x.double()
        return (xd * xd).sum(1).float()
    return x.amin(2)


def reduce3d(x: torch.Tensor, form: str) -> torch.Tensor:
    """On (NCH, M, L) float32: "sum" -> sum(x * x, axis=1) (NCH, L),
    float64 products and sums rounded once; "min" -> min(x, axis=2)
    (NCH, M)."""
    NCH, M, L = x.shape
    check("x", x, F32, (NCH, M, L), x.device)
    if form not in REDUCE_FORMS:
        raise ValueError(f"form is one of {REDUCE_FORMS}, not {form!r}")
    if not on_card(x):
        return reduce3d_plain(x, form)
    out = torch.empty((NCH, L if form == "sum" else M), dtype=F32,
                      device=x.device)
    launch(reduce3d, build()[0].probe_reduce3d, REDUCE_FORMS.index(form),
           NCH, M, L, x.data_ptr(), out.data_ptr())
    return out


reduce3d.launches = 0


def reduce3d_counts(x, form):
    NCH, M, L = x.shape
    n = NCH * M * L
    if form == "sum":
        return 4 * (n + NCH * L), 2 * n
    return 4 * (n + NCH * M), n


# ---------------------------------------------------------------- F8
# Philox4x32-10 a value: 10 rounds of 2 mulhi, 2 mullo, 4 xor and 2 key
# adds, then the shift, or and subtraction of the mapping
UNIFORM_OPS = 10 * 10 + 3


def uniform_plain(seed, rows, lanes):
    """ops/rng.philox4x32 of the counter (lane, row, 0, 0) under the key
    (seed, 0), word 0, mapped as the kernel maps it."""
    shape = (rows, lanes)
    dev = seed.device
    lane = torch.arange(lanes, dtype=torch.int64, device=dev).expand(shape)
    row = torch.arange(rows, dtype=torch.int64, device=dev)[:, None].expand(
        shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=dev)
    w0 = rng.philox4x32(lane, row, zero, zero,
                        seed.reshape(()).long() & 0xFFFFFFFF, 0)[0]
    bits = ((w0 >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(F32) - 1.0


def uniform(seed: torch.Tensor, rows: int, lanes: int) -> torch.Tensor:
    """(rows, lanes) float32 uniforms in [0, 1) from a (1,) int32 seed on
    the device: ((w >> 9) | 0x3F800000) as float32, minus 1, for w word 0
    of Philox4x32-10 of the counter (lane, row, 0, 0) under the key (seed,
    0) — the probes' mapping of pltpu.prng_random_bits, whose bits no
    other generator gives."""
    check("seed", seed, torch.int32, (1,), seed.device)
    if rows < 1 or lanes < 1:
        raise ValueError(f"shape ({rows}, {lanes}) is empty")
    if not on_card(seed):
        return uniform_plain(seed, rows, lanes)
    out = torch.empty((rows, lanes), dtype=F32, device=seed.device)
    launch(uniform, build()[0].probe_uniform, rows, lanes, seed.data_ptr(),
           out.data_ptr())
    return out


uniform.launches = 0


def uniform_counts(seed, rows, lanes):
    """The seed read, the values written; UNIFORM_OPS 32-bit integer
    operations a value, counted against the float32 rate."""
    return 4 + 4 * rows * lanes, UNIFORM_OPS * rows * lanes
