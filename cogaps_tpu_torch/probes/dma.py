"""F9-F11: the DMA probes' functions, each a kernel of csrc/probe_dma.cu
beside its plain PyTorch version.

The TPU sites (tools/, file:line of the pallas_call):
  F9  gather_block    probe_dma.py:56 (p1: 8 rows at a runtime offset)
      gather_rows     probe_dma.py:155 (_mk_call: B rows at float32 indices)
      gather_passes   probe_dma2.py:68 (R dependent gather passes)
      gather_batched  probe_mosaic5.py:27 (k_gather, and k_gred's flat table
                      as K = 1)
      dependent_loads no TPU site: the dependent-load floor under
                      gather_passes
  F10 scatter_slots   probe_mosaic5.py:27 (k_scatter)
  F11 strided_sum     probe_dma.py:85 (p2a), 112 (p2b)

Each moves data without arithmetic on it (F11's and gather_passes' few
float32 operations are the same on both sides), so kernel and plain
version agree exactly. Indices must name rows of the table (or slots of
the output): the kernels write NaN rows for others, the plain versions
raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_build import check
from . import bind, launch, on_card
from .mosaic import sm_count

F32 = torch.float32

_SIGNATURES = {
    "probe_gather_rows": "iiiiippppp",
    "probe_gather_passes": "iiiippppp",
    "probe_dependent_loads": "iiipppp",
    "probe_gather_batched": "iiiipppp",
    "probe_scatter_slots": "iiipppp",
    "probe_strided_sum": "iiffppp",
}


def build() -> tuple:
    """Compile csrc/probe_dma.cu and load it: (library, report)."""
    return bind("probe_dma", _SIGNATURES)


def _table(tbl):
    NB, K = tbl.shape
    check("tbl", tbl, F32, (NB, K), tbl.device)
    return NB, K


# ---------------------------------------------------------------- F9
# csrc/probe_dma.cu's kGatherThreads
GATHER_THREADS = 256
GATHER_BLOCKS_PER_SM = 8  # 2048 threads: an SM's most


class GatherPlan(NamedTuple):
    """How gather_rows and gather_block walk their (B, K) output: `pieces`
    of 16 bytes (the last one partial where B K % 4), in `tiles` of `tile`
    pieces, `items` a thread of `threads`; `grid` blocks take tiles g,
    g + grid, ..."""
    pieces: int
    tile: int
    tiles: int
    items: int
    threads: int
    grid: int


def gather_plan(B: int, K: int, n_sm: int = 132) -> GatherPlan:
    """The flat walk of a (B, K) gather: a piece a thread while the tiles
    spread over the SMs at GATHER_BLOCKS_PER_SM blocks an SM (a small
    gather's loads go out from as many SMs as it can reach), two past
    that, so each thread has two pieces' loads in flight; as many blocks
    as tiles, at most GATHER_BLOCKS_PER_SM an SM, each looping over its
    tiles."""
    if B < 1 or K < 1:
        raise ValueError(f"empty gather of {B} rows of {K}")
    pieces = -(-B * K // 4)
    full = GATHER_BLOCKS_PER_SM * n_sm
    items = 1 if pieces <= full * GATHER_THREADS else 2
    tile = GATHER_THREADS * items
    tiles = -(-pieces // tile)
    return GatherPlan(pieces, tile, tiles, items, GATHER_THREADS,
                      min(tiles, full))


def _gather(wrapper, tbl, idx, offset, B):
    NB, K = tbl.shape
    plan = gather_plan(B, K, sm_count(tbl.device.index or 0))
    out = torch.empty((B, K), dtype=F32, device=tbl.device)
    launch(wrapper, build()[0].probe_gather_rows, NB, K, B, plan.items,
           plan.grid,
           tbl.data_ptr(), None if idx is None else idx.data_ptr(),
           None if offset is None else offset.data_ptr(), out.data_ptr())
    return out


def gather_rows_plain(tbl, idx):
    return tbl[idx.long()]


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j, :] = tbl[idx[j], :]: rows of an (NB, K) float32 table at
    (B,) float32 row indices -> (B, K)."""
    _table(tbl)
    check("idx", idx, F32, (idx.shape[0],), tbl.device)
    if not on_card(tbl):
        return gather_rows_plain(tbl, idx)
    return _gather(gather_rows, tbl, idx, None, idx.shape[0])


gather_rows.launches = 0


def _distinct(rows):
    """How many different values `rows` holds: the table rows a gather
    must read at least once, however often its indices repeat them."""
    return torch.unique(rows.reshape(-1)).numel()


def gather_rows_counts(tbl, idx):
    """The distinct table rows read once, the B rows written, the indices
    read."""
    B, K = idx.shape[0], tbl.shape[1]
    return 4 * (_distinct(idx) * K + B * K + B), 0


def gather_block_plain(tbl, offset, n):
    return tbl[offset.long() + torch.arange(n, device=tbl.device)]


def gather_block(tbl: torch.Tensor, offset: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Rows offset[0] .. offset[0] + n - 1 of an (NB, K) float32 table,
    the offset a (1,) int32 tensor read on the device (probe_dma.py p1)."""
    _table(tbl)
    check("offset", offset, torch.int32, (1,), tbl.device)
    if n < 1:
        raise ValueError(f"n must be positive, not {n}")
    if not on_card(tbl):
        return gather_block_plain(tbl, offset, n)
    return _gather(gather_block, tbl, None, offset, n)


gather_block.launches = 0


def gather_block_counts(tbl, offset, n):
    return 8 * n * tbl.shape[1] + 4, 0


def gather_passes_plain(tbl, idx, n_passes):
    NB = tbl.shape[0]
    cur = idx
    for _ in range(n_passes):
        buf = tbl[cur.long()]
        cur = torch.floor(cur * 0.5 + buf[:, 0]) % NB
    return cur + buf[0, 0], buf


def gather_passes(tbl: torch.Tensor, idx: torch.Tensor,
                  n_passes: int) -> tuple:
    """probe_dma2.py's dependent passes on an (NB, K) float32 table, K a
    multiple of 4, from (B,) float32 row indices: each pass gathers buf =
    tbl[idx] and sets idx = floor(idx * 0.5 + buf[:, 0]) % NB. Returns
    (idx + buf[0, 0] after the last pass, (B,); buf of the last pass,
    (B, K))."""
    NB, K = _table(tbl)
    check("idx", idx, F32, (idx.shape[0],), tbl.device)
    if n_passes < 1:
        raise ValueError(f"n_passes must be positive, not {n_passes}")
    if K % 4:
        raise ValueError(f"gather_passes takes K a multiple of 4, not {K}")
    if not on_card(tbl):
        return gather_passes_plain(tbl, idx, n_passes)
    B = idx.shape[0]
    out = torch.empty((B,), dtype=F32, device=tbl.device)
    buf = torch.empty((B, K), dtype=F32, device=tbl.device)
    launch(gather_passes, build()[0].probe_gather_passes, NB, K, B,
           n_passes, tbl.data_ptr(), idx.data_ptr(), buf.data_ptr(),
           out.data_ptr())
    return out, buf


gather_passes.launches = 0


def gather_passes_counts(tbl, idx, n_passes):
    """The distinct rows that the passes' indices name (followed as the
    passes follow them) read once, the indices read, buf and the result
    written once; per lane and pass a multiply, an add, a floor and a
    remainder."""
    NB, K = tbl.shape
    B = idx.shape[0]
    cur, named = idx, []
    for _ in range(n_passes):
        named.append(cur)
        cur = torch.floor(cur * 0.5 + tbl[cur.long(), 0]) % NB
    rows = _distinct(torch.cat(named))
    return 4 * (rows * K + B + B * K + B), 4 * n_passes * B


def dependent_loads_plain(tbl, idx, n_loads):
    NB = tbl.shape[0]
    cur = idx[:1]
    for _ in range(n_loads):
        cur = torch.floor(cur * 0.5 + tbl[cur.long(), 0]) % NB
    return cur


def dependent_loads(tbl: torch.Tensor, idx: torch.Tensor,
                    n_loads: int) -> torch.Tensor:
    """The dependent-load floor under gather_passes (no TPU site): one
    lane follows n_loads dependent loads of the (NB, K) float32 table's
    column 0 from cur = idx[0], cur = floor(cur * 0.5 + tbl[cur, 0]) % NB
    (gather_passes' index rule). Returns cur, (1,)."""
    NB, K = _table(tbl)
    check("idx", idx, F32, (idx.shape[0],), tbl.device)
    if n_loads < 1:
        raise ValueError(f"n_loads must be positive, not {n_loads}")
    if not on_card(tbl):
        return dependent_loads_plain(tbl, idx, n_loads)
    out = torch.empty((1,), dtype=F32, device=tbl.device)
    launch(dependent_loads, build()[0].probe_dependent_loads, NB, K,
           n_loads, tbl.data_ptr(), idx.data_ptr(), out.data_ptr())
    return out


dependent_loads.launches = 0


def gather_batched_plain(tbl, idx):
    NCH = tbl.shape[0]
    chain = torch.arange(NCH, device=tbl.device)[:, None]
    return tbl[chain, idx.long()].transpose(1, 2).contiguous()


def gather_batched(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[c, q, j] = tbl[c, idx[c, j], q]: rows of each chain's (T, K)
    float32 table at (NCH, B) float32 indices, in the (NCH, K, B) layout
    of probe_mosaic5.py's k_gather; K = 1 is its k_gred's flat table."""
    NCH, T, K = tbl.shape
    check("tbl", tbl, F32, (NCH, T, K), tbl.device)
    check("idx", idx, F32, (NCH, idx.shape[-1]), tbl.device)
    if not on_card(tbl):
        return gather_batched_plain(tbl, idx)
    B = idx.shape[1]
    out = torch.empty((NCH, K, B), dtype=F32, device=tbl.device)
    launch(gather_batched, build()[0].probe_gather_batched, NCH, T, K, B,
           tbl.data_ptr(), idx.data_ptr(), out.data_ptr())
    return out


gather_batched.launches = 0


def gather_batched_counts(tbl, idx):
    """The distinct rows of each chain's table read once, the (NCH, K, B)
    output written, the indices read."""
    NCH, T, K = tbl.shape
    B = idx.shape[1]
    chain = torch.arange(NCH, device=idx.device)[:, None] * T
    rows = _distinct(chain + idx.long())
    return 4 * (rows * K + NCH * K * B + NCH * B), 0


# ---------------------------------------------------------------- F10
def scatter_slots_plain(val, slot, n_slots):
    NCH, B = val.shape
    out = torch.zeros((NCH, n_slots), dtype=F32, device=val.device)
    chain = torch.arange(NCH, device=val.device)[:, None].expand(NCH, B)
    out[chain, slot.long()] = val
    return out


def scatter_slots(val: torch.Tensor, slot: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """out[c, slot[c, i]] = val[c, i] into an (NCH, n_slots) float32 table
    of zeros; val and slot (NCH, B) float32, slots unique in a chain."""
    NCH, B = val.shape
    check("val", val, F32, (NCH, B), val.device)
    check("slot", slot, F32, (NCH, B), val.device)
    if n_slots < 1:
        raise ValueError(f"n_slots must be positive, not {n_slots}")
    if not on_card(val):
        return scatter_slots_plain(val, slot, n_slots)
    out = torch.empty((NCH, n_slots), dtype=F32, device=val.device)
    launch(scatter_slots, build()[0].probe_scatter_slots, NCH, B, n_slots,
           val.data_ptr(), slot.data_ptr(), out.data_ptr())
    return out


scatter_slots.launches = 0


def scatter_slots_counts(val, slot, n_slots):
    NCH, B = val.shape
    return 4 * NCH * (2 * B + n_slots), 0


# ---------------------------------------------------------------- F11
STRIDED_TERMS = 8  # the probes' fori_loop(0, 8, ...)


def strided_sum_plain(x, stride, scale=1.0, shift=0.0):
    acc = torch.zeros((), dtype=F32, device=x.device)
    for j in range(STRIDED_TERMS):
        acc = acc + (x[0, stride * j] * scale + shift)
    return acc.reshape(1, 1)


def strided_sum(x: torch.Tensor, stride: int, scale: float = 1.0,
                shift: float = 0.0) -> torch.Tensor:
    """sum_{j<8} (x[0, stride j] * scale + shift) in float32, added in
    order j, as (1, 1); x (1, L) float32. probe_dma.py's p2a is stride 7
    of x, p2b stride 31 of 2x + 1."""
    L = x.shape[-1]
    check("x", x, F32, (1, L), x.device)
    if stride < 0 or stride * (STRIDED_TERMS - 1) >= L:
        raise ValueError(f"{STRIDED_TERMS} elements {stride} apart do not "
                         f"fit in {L}")
    if not on_card(x):
        return strided_sum_plain(x, stride, scale, shift)
    out = torch.empty((1, 1), dtype=F32, device=x.device)
    launch(strided_sum, build()[0].probe_strided_sum, STRIDED_TERMS, stride,
           float(scale), float(shift), x.data_ptr(), out.data_ptr())
    return out


strided_sum.launches = 0


def strided_sum_counts(x, stride, scale=1.0, shift=0.0):
    return 4 * STRIDED_TERMS + 4, 3 * STRIDED_TERMS
