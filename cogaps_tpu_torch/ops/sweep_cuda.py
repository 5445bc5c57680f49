"""One sampler's update call for NCH chains: the CUDA sweep kernel
(csrc/sweep.cu) and its wrapper.

``run_updates_multi`` runs every chain's ``update(nSteps)`` — all sweeps
until each chain's budget is spent — as one kernel launch with one
thread block per chain. It replaces cogaps_tpu/ops/pallas_sweep.py::
_kernel_b and its wrapper run_updates_pallas_multi. For tensors on the
CPU it runs the plain version (ops/sweep.run_updates, chain by chain);
for CUDA tensors it launches the kernel or raises.

Each block keeps as much of its chain's state in shared memory as pays:
``smem_plan`` places the groups of GROUPS in that order of priority (the
row claims, the slot claims, then the hole flags, atom table, Y, SQ and
M together, then Z), each where it still fits in the block's budget,
and the kernel obeys the byte offsets it is given. Claim tables that lie
in shared memory take no global scratch.

Two random modes, as in the JAX kernel:

* exact — ``rand`` is an ops.sweep.UniformSource. The wrapper hands the
  kernel a slab of ``s_max`` (16, B) blocks per chain; the kernel stops
  when the budget is spent or the slab is used up, and the wrapper goes
  on with the next slab (run_updates_pallas_multi's completion loop).
  This mode reads the kernel's counters back after each launch.
* fast — ``rand`` is a PhiloxKey: the kernel draws its blocks from
  Philox4x32-10 (ops/rng.philox_uniforms gives the same numbers) and runs
  to the end of the budget in one launch, reading the budgets from
  device memory: no host synchronisation.

The kernel is built from csrc/sweep.cu (with csrc/sweep_common.cuh) by
ops/cuda_build.py at first use. Fed the sparse model's tables (G in the
Z table's place, models/sparse.kernel_tables) with noise floors 0, the
same wrapper and kernel are the port of the TPU kernel's tables mode,
run_updates_pallas_tables(_multi) (K2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Union

import torch

from ..models import dense
from . import cuda_build
from . import rng as gaps_rng
from .atoms import AtomTable, stack_atoms
from .sweep import (MassParams, SamplerConsts, SweepCounts, UniformSource,
                    run_updates)

MAX_BATCH = 1024
_N_OUT = 10  # done, sweeps, processed[4], accepted[4]
_PLAIN_CHUNK = 8  # sweeps of uniforms the plain version draws at once

# The chain-state arrays a block may stage in shared memory
# (sweep_common.cuh::Placed), and the groups a plan places whole, in
# order of priority: row and slot claims (the atomics) each alone; then
# hole flags (bytes), atom table, Y, SQ and M together, since what stays
# global is read through L1, which shares the SM's 256 KB with shared
# memory: a block that fills shared memory with part of that state
# starves the L1 of the rest and ran slower than one that staged none of
# it (PERF.md section 6: 0.354 ms against 0.185 at 20000 rows); then Z.
PLACED = ("rmin", "amin", "hole", "mass", "elem", "Y", "SQ", "M", "Z")
GROUPS = (("rmin",), ("amin",), ("hole", "mass", "elem", "Y", "SQ", "M"),
          ("Z",))
SMEM_BLOCK = 232_448  # shared memory one block may use on an H100 (227 KB)
# static shared memory of the kernel, sweep_common.cuh::SweepShared
STATIC_SMEM = 4 * (32 + MAX_BATCH + 1 + 3 + 8)


class PhiloxKey(NamedTuple):
    """Fast-mode key: chain c's blocks are philox((lane, row group,
    sweep, 0), (key0[c], key1)) — its seed word's alone."""

    key0: torch.Tensor  # (NCH,) int64 per-chain seed words, on the device
    key1: int  # (phase, iteration, sampler) word


class SmemPlan(NamedTuple):
    """Where a launch keeps each array of PLACED: its byte offset in the
    block's dynamic shared memory, or None for global memory."""

    slots: tuple  # the offsets in PLACED's order
    nbytes: int  # dynamic shared memory a block takes

    @property
    def offsets(self) -> dict:
        return dict(zip(PLACED, self.slots))

    def describe(self) -> str:
        inside = [n for n in PLACED if self.offsets[n] is not None]
        outside = [n for n in PLACED if self.offsets[n] is None]
        return (f"shared {'/'.join(inside) or '-'} ({self.nbytes} B), "
                f"global {'/'.join(outside) or '-'}")


def placed_bytes(NR: int, K: int, C: int) -> dict:
    """Bytes of each array of PLACED for one chain."""
    NB = NR * K
    return {"rmin": 4 * (NR + 1), "amin": 4 * (C + 1), "hole": C,
            "mass": 4 * C, "elem": 4 * C, "Y": 4 * NB, "SQ": 4 * NB,
            "M": 4 * NB, "Z": 4 * NB * K}


def pack(NR: int, K: int, C: int, names=PLACED,
         budget: Optional[int] = None) -> SmemPlan:
    """The arrays `names`, in PLACED's order, at 16-byte aligned offsets;
    with a budget, the named arrays of each group of GROUPS, in order,
    go in together where they still fit, and stay global together
    otherwise."""
    sizes = {n: -(-b // 16) * 16 for n, b in placed_bytes(NR, K, C).items()}
    offsets, top = dict.fromkeys(PLACED), 0
    for group in GROUPS:
        members = [n for n in group if n in names]
        if budget is None or top + sum(sizes[n] for n in members) <= budget:
            for n in members:
                offsets[n] = top
                top += sizes[n]
    return SmemPlan(tuple(offsets[n] for n in PLACED), top)


@functools.lru_cache(maxsize=64)
def smem_plan(NR: int, K: int, C: int, B: int, nch: int) -> SmemPlan:
    """The placement of one launch of nch chains of batch B: GROUPS in
    order, each in shared memory where it fits in what a block may take
    beside the kernel's static shared memory. Every width class and chain
    count gets that same budget; chains past one an SM run in later
    waves."""
    return pack(NR, K, C, budget=SMEM_BLOCK - STATIC_SMEM)


def scratch_layout(NR: int, C: int, plan: SmemPlan) -> tuple:
    """(ints a chain, offset of the row claims, of the slot claims, of
    the hole flags) of the global scratch for the claim tables the plan
    leaves in global memory; -1 for one in shared memory."""
    top, offs = 0, []
    for name, n in (("rmin", NR + 1), ("amin", C + 1), ("hole", -(-C // 4))):
        if plan.offsets[name] is None:
            offs.append(top)
            top += n
        else:
            offs.append(-1)
    return (top, *offs)


def build() -> tuple:
    """Compile csrc/sweep.cu (once per source hash) and load it.
    Returns (ctypes library, compiler report)."""
    lib, report = cuda_build.load("sweep")
    fn = lib.cogaps_sweep_launch
    ints = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_uint32, ints, ctypes.c_int,
                      ints, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cogaps_sweep_static_smem.argtypes = [ctypes.c_int]
    lib.cogaps_sweep_static_smem.restype = ctypes.c_int
    return lib, report


def run_updates_multi(atoms: AtomTable, M: torch.Tensor, Y: torch.Tensor,
                      phase: dense.DensePhase, temp: float,
                      n_steps: torch.Tensor, consts: SamplerConsts,
                      mass: MassParams,
                      rand: Union[PhiloxKey, UniformSource], *,
                      s_max: int = 32, max_sweeps: Optional[int] = None):
    """Update calls of NCH chains. atoms: (NCH, C) tables with n (NCH,);
    M, Y, phase.SQ: (NCH, n_rows, k); phase.Z: (NCH, n_rows*k, k);
    phase.col_nz: (NCH, k); n_steps: (NCH,) int budgets; mass fields
    (NCH,). The inputs are left untouched. `max_sweeps` (exact mode)
    stops every chain after that many sweeps, budget spent or not: it
    lets a check step two versions sweep by sweep.

    Returns (atoms, M, Y, done, n_sweeps, counts), chain-stacked."""
    if max_sweeps is not None and isinstance(rand, PhiloxKey):
        raise ValueError("max_sweeps needs a UniformSource (exact mode)")
    if M.device.type == "cpu":
        return run_updates_multi_plain(atoms, M, Y, phase, temp, n_steps,
                                       consts, mass, rand,
                                       max_sweeps=max_sweeps)
    if M.device.type != "cuda":
        raise ValueError(f"no sweep for tensors on {M.device}")
    return _run_kernel(atoms, M, Y, phase, temp, n_steps, consts, mass,
                       rand, s_max, max_sweeps)


run_updates_multi.launches = 0


@torch.inference_mode()
def run_updates_multi_plain(atoms, M, Y, phase, temp, n_steps, consts,
                            mass, rand, max_sweeps=None):
    """The plain version of run_updates_multi: ops/sweep.run_updates
    chain by chain, on whatever device the tensors are (inference mode
    trims PyTorch's per-operation overhead)."""

    def one(c, blocks, budget, chain_mass):
        model = dense.make_model(dense.DensePhase(
            SQ=phase.SQ[c], Z=phase.Z[c], col_nz=phase.col_nz[c]))
        return run_updates(blocks, atoms.chain(c), M[c],
                           dense.DenseCache(Y=Y[c]), temp, budget, consts,
                           chain_mass, model=model, max_sweeps=max_sweeps)

    outs = plain_chains(one, rand, n_steps, consts.batch, mass, M.device)
    return (stack_atoms([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2].Y for o in outs]), *stack_counts(outs, M.device))


def plain_chains(one: Callable, rand: Union[PhiloxKey, UniformSource],
                 n_steps: torch.Tensor, B: int, mass: MassParams, device):
    """one(c, blocks, budget, mass) for every chain c, where blocks(i) is
    chain c's sweep-i (16, B) block from `rand` (drawn _PLAIN_CHUNK
    sweeps at a time; a PhiloxKey gives the fast mode's blocks)."""
    if isinstance(rand, PhiloxKey):
        key = rand

        def rand(c, first, n):
            return gaps_rng.philox_uniforms(key.key0[c], key.key1, 0, first,
                                            n, B, device=device)

    outs = []
    for c, budget in enumerate(n_steps.tolist()):
        slab = {}

        def blocks(i, c=c, slab=slab):
            first = i - i % _PLAIN_CHUNK
            if first not in slab:
                slab.clear()
                slab[first] = rand(c, first, _PLAIN_CHUNK).reshape(
                    _PLAIN_CHUNK, 16, B)
            return slab[first][i - first]

        outs.append(one(c, blocks, int(budget), MassParams(
            lam=mass.lam[c], max_gibbs_mass=mass.max_gibbs_mass[c])))
    return outs


def stack_counts(outs, device):
    """(done, n_sweeps, counts) of per-chain run_updates results."""
    ints = functools.partial(torch.tensor, dtype=torch.int32, device=device)
    return (ints([o[3] for o in outs]), ints([o[4] for o in outs]),
            SweepCounts(processed=torch.stack([o[5].processed for o in outs]),
                        accepted=torch.stack([o[5].accepted for o in outs])))


def _run_kernel(atoms, M, Y, phase, temp, n_steps, consts, mass, rand,
                s_max, max_sweeps, place=None):
    """The kernel's update call. `place` (tests and measurements only)
    forces a placement: a tuple of names of PLACED, put in shared memory
    and the rest left global, fit or not (a block too large for the card
    is refused and raises), or an SmemPlan."""
    NCH, NR, K = M.shape
    dev = M.device
    f32 = torch.float32
    for name, t, dt, shape in (
            ("Y", Y, f32, (NCH, NR, K)), ("SQ", phase.SQ, f32, (NCH, NR, K)),
            ("Z", phase.Z, f32, (NCH, NR * K, K)),
            ("col_nz", phase.col_nz, torch.bool, (NCH, K))):
        cuda_build.check(name, t, dt, shape, dev)
    B, C = consts.batch, consts.capacity
    plan, offsets, layout = _placement(NR, K, C, B, NCH, place)
    st = KernelState.make(atoms, M, consts, mass, n_steps,
                          scratch_ints=layout[0])
    Y_t = Y.clone()  # the kernel works in place on copies of the state
    colnz = phase.col_nz.to(torch.int32)
    lib, _ = build()

    def launch(budget_t, uni, s_lim, key0, key1, stream):
        err = lib.cogaps_sweep_launch(
            NCH, consts.batch, consts.capacity, NR, K,
            int(consts.local_moves), float(consts.alpha * consts.n_bins),
            float(consts.domain_length), float(temp),
            mass.lam.data_ptr(), mass.max_gibbs_mass.data_ptr(),
            budget_t.data_ptr(), st.mass.data_ptr(), st.elem.data_ptr(),
            st.n.data_ptr(), st.M.data_ptr(), Y_t.data_ptr(),
            phase.SQ.data_ptr(), phase.Z.data_ptr(), colnz.data_ptr(),
            st.scratch.data_ptr(), st.out.data_ptr(),
            uni.data_ptr() if uni is not None else None, s_lim,
            key0.data_ptr() if key0 is not None else None, key1, offsets,
            plan.nbytes, layout, stream)
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}"
                               f" ({plan.describe()})")
        run_updates_multi.launches += 1

    done, n_sweeps, counts = drive(launch, st, n_steps, consts.batch, rand,
                                   s_max, max_sweeps)
    return st.atoms(), st.M, Y_t, done, n_sweeps, counts


@functools.lru_cache(maxsize=64)
def _placement(NR, K, C, B, nch, place):
    """(plan, its offsets and its scratch layout as C int arrays) of a
    launch; `place` forces a placement (see _run_kernel)."""
    if place is None:
        plan = smem_plan(NR, K, C, B, nch)
    elif isinstance(place, SmemPlan):
        plan = place
    else:
        plan = pack(NR, K, C, names=place)
    offsets = (ctypes.c_int * len(PLACED))(
        *(-1 if off is None else off for off in plan.slots))
    return plan, offsets, (ctypes.c_int * 4)(*scratch_layout(NR, C, plan))


class KernelState(NamedTuple):
    """Copies of one update call's state that a sweep kernel works on in
    place, and its scratch and counter buffers (both kernels share the
    atom-table and conflict machinery, csrc/sweep_common.cuh)."""

    mass: torch.Tensor
    elem: torch.Tensor
    n: torch.Tensor
    M: torch.Tensor
    scratch: torch.Tensor  # (NCH * scratch_ints,) claims and hole flags
    out: torch.Tensor  # (NCH, _N_OUT) int32 counters

    @staticmethod
    def make(atoms: AtomTable, M: torch.Tensor, consts: SamplerConsts,
             mass: MassParams, n_steps: torch.Tensor,
             scratch_ints: Optional[int] = None) -> "KernelState":
        """`scratch_ints`: ints of claim scratch a chain (default all the
        claim tables and hole flags, NR + 2C + 2)."""
        NCH, NR, K = M.shape
        B, C = consts.batch, consts.capacity
        if scratch_ints is None:
            scratch_ints = NR + 2 * C + 2
        if not 1 <= B <= MAX_BATCH:
            raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
        if C <= 0 or C & (C - 1):
            raise ValueError(f"capacity {C} is not a power of two")
        if (NR, K) != (consts.n_rows, consts.k):
            raise ValueError(
                "factor shape does not match the sampler constants")
        dev = M.device
        f32, i32 = torch.float32, torch.int32
        for name, t, dt, shape in (
                ("atoms.mass", atoms.mass, f32, (NCH, C)),
                ("atoms.elem", atoms.elem, i32, (NCH, C)),
                ("atoms.n", atoms.n, i32, (NCH,)),
                ("M", M, f32, (NCH, NR, K)), ("lam", mass.lam, f32, (NCH,)),
                ("max_gibbs_mass", mass.max_gibbs_mass, f32, (NCH,)),
                ("n_steps", n_steps, i32, (NCH,))):
            cuda_build.check(name, t, dt, shape, dev)
        return KernelState(
            mass=atoms.mass.clone(), elem=atoms.elem.clone(),
            n=atoms.n.clone(), M=M.clone(),
            scratch=torch.empty(max(NCH * scratch_ints, 1), dtype=i32,
                                device=dev),
            out=torch.empty((NCH, _N_OUT), dtype=i32, device=dev))

    def atoms(self) -> AtomTable:
        return AtomTable(mass=self.mass, elem=self.elem, n=self.n)


def drive(launch: Callable, st: KernelState, n_steps: torch.Tensor, B: int,
          rand: Union[PhiloxKey, UniformSource], s_max: int,
          max_sweeps: Optional[int]):
    """Run a sweep kernel's update call in either random mode.
    `launch(budgets, uniforms, s_lim, key0, key1, stream)` launches the
    kernel once on the state `st`. Fast mode: one launch, budgets read
    on the device. Exact mode: slabs of s_max uniform blocks until every
    budget is spent (or `max_sweeps` sweeps have run); unfinished chains
    have all run the same number of sweeps. Returns (done, n_sweeps,
    counts) on the device."""
    dev = st.M.device
    NCH = st.M.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if isinstance(rand, PhiloxKey):
            cuda_build.check("key0", rand.key0, torch.int64, (NCH,), dev)
            launch(n_steps, None, 0, rand.key0, rand.key1 & 0xFFFFFFFF,
                   stream)
            out = st.out
            return out[:, 0], out[:, 1], SweepCounts(processed=out[:, 2:6],
                                                     accepted=out[:, 6:10])
        target = n_steps.cpu()
        total = torch.zeros((NCH, _N_OUT), dtype=torch.int32)
        swept = 0
        while bool((total[:, 0] < target).any()):
            s_lim = s_max
            if max_sweeps is not None:
                s_lim = min(s_max, max_sweeps - swept)
                if s_lim <= 0:
                    break
            offs = total[:, 1].tolist()
            uni = torch.stack([rand(c, offs[c], s_lim) for c in range(NCH)]
                              ).to(device=dev, dtype=torch.float32
                                   ).contiguous()
            cuda_build.check("uniforms", uni, torch.float32,
                             (NCH, s_lim * 16, B), dev)
            left = (target - total[:, 0]).to(device=dev)
            launch(left, uni, s_lim, None, 0, stream)
            total += st.out.cpu()
            swept += s_lim
    return (total[:, 0].to(dev), total[:, 1].to(dev),
            SweepCounts(processed=total[:, 2:6].to(dev),
                        accepted=total[:, 6:10].to(dev)))
