"""Conflict-free Gibbs proposal sweep — the plain PyTorch version.

This is the counterpart of cogaps_tpu/ops/sweep.py and the plain
version of the CUDA sweep kernel (csrc/sweep.cu, bound in
ops/sweep_cuda.py): the kernel's wrapper runs it for tensors on the CPU,
and the tests and chip_smoke.py hold the kernel to it. One sweep draws B
candidate proposals from one (16, B) uniform block, keeps each proposal
iff no earlier lane touches its rows or atoms (first wins), truncates to
the atom capacity and the remaining budget, evaluates the survivors at
the batch-start state and applies them together. cogaps_tpu/ops/sweep.py
documents the parallelization argument and the proposal kernels
(reference: SingleThreadedGibbsSampler.h, ProposalQueue.cpp).

The function works on one chain: atom tables of shape (C,), M and Y of
shape (n_rows, k). Uniform rows 0-4 drive the type and accept draws,
rows 5-8 the selections; rows 9-15 are unused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from . import rng as gaps_rng
from .atoms import AtomTable

# (chain, first sweep, number of sweeps) -> (n*16, B) float32 uniforms:
# one (16, B) block per sweep, as cogaps_tpu/ops/pallas_sweep._draw_uni
# lays them out
UniformSource = Callable[[int, int, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConsts:
    """Static per-sampler constants."""

    n_rows: int  # rows of the factor being sampled
    m: int  # reduction length (the other dimension)
    k: int  # n_patterns
    n_bins: int  # n_rows * k
    capacity: int  # atom table capacity (a power of two)
    batch: int  # proposal batch width B
    alpha: float
    domain_length: float  # binLength * nBins with binLength = 2^64 // nBins
    local_moves: bool = True


class MassParams(NamedTuple):
    """Mass-prior parameters lambda and maxGibbsMass/lambda
    (DenseNormalModel.h:79-81), as tensors: 0-dim for one chain, (NCH,)
    for a batch."""

    lam: torch.Tensor
    max_gibbs_mass: torch.Tensor


class AddrBatch(NamedTuple):
    r1: torch.Tensor
    c1: torch.Tensor
    r2: torch.Tensor
    c2: torch.Tensor


class ApplyBatch(NamedTuple):
    """Accepted matrix deltas of both streams, (2B,) each; lanes that
    apply nothing carry delta exactly 0."""

    rows: torch.Tensor
    cols: torch.Tensor
    deltas: torch.Tensor


class SweepCounts(NamedTuple):
    processed: torch.Tensor  # (..., 4) int32, kept proposals by type
    accepted: torch.Tensor  # (..., 4) int32, state-changing by type


def make_consts(n_rows: int, m: int, k: int, capacity: int, batch: int,
                alpha: float, local_moves: bool = True) -> SamplerConsts:
    n_bins = n_rows * k
    bin_length = (2**64) // n_bins
    return SamplerConsts(n_rows=n_rows, m=m, k=k, n_bins=n_bins,
                         capacity=capacity, batch=batch, alpha=alpha,
                         domain_length=float(bin_length * n_bins),
                         local_moves=local_moves)


def death_prob(n_f32: torch.Tensor, consts: SamplerConsts) -> torch.Tensor:
    """deathProb = n*L / (n*L + alpha*nBins*(L-n)) in float32
    (reference: SingleThreadedGibbsSampler.h:105-108)."""
    numer = n_f32 * consts.domain_length
    denom = numer + consts.alpha * consts.n_bins * (
        consts.domain_length - n_f32)
    return numer / denom


def _keep(active, r1, r2, uses2, a1, uses_a1, a2, uses_a2,
          consts: SamplerConsts) -> torch.Tensor:
    """Exact first-wins on rows and atoms: lane i survives iff it is the
    earliest active lane touching each of its rows and atoms
    (cogaps_tpu/ops/sweep._keep)."""
    B = r1.shape[0]
    lane = torch.arange(B, device=r1.device)
    lane_a = torch.where(active, lane, B).repeat(2)
    NR, C = consts.n_rows, consts.capacity

    # both streams' claims in one scatter per table; unused streams
    # scatter to the sentinel entry NR / C and skip the test
    rows = torch.cat([r1, r2])
    rows_used = torch.cat([active, active & uses2])
    rmin = torch.full((NR + 1,), B, dtype=torch.int64, device=r1.device)
    rmin.scatter_reduce_(0, torch.where(rows_used, rows, NR), lane_a, "amin")
    slots = torch.cat([a1, a2])
    slots_used = torch.cat([active & uses_a1, active & uses_a2])
    amin = torch.full((C + 1,), B, dtype=torch.int64, device=r1.device)
    amin.scatter_reduce_(0, torch.where(slots_used, slots, C), lane_a, "amin")
    won = ((~rows_used | (rmin[rows] >= lane_a))
           & (~slots_used | (amin[slots] >= lane_a)))
    ok = won.view(2, B).all(dim=0)
    return active & ok


class Proposals(NamedTuple):
    """One sweep's B proposals after the conflict rule and the capacity
    and budget truncation; the type flags are cleared unless kept."""

    keep: torch.Tensor
    is_birth: torch.Tensor
    is_death: torch.Tensor
    is_move: torch.Tensor
    is_exch: torch.Tensor
    a1c: torch.Tensor
    a2c: torch.Tensor
    e_birth: torch.Tensor
    elem1: torch.Tensor
    elem2: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    r1: torch.Tensor
    c1: torch.Tensor
    r2: torch.Tensor
    c2: torch.Tensor


def propose(uni: torch.Tensor, atoms: AtomTable, remaining: int,
            consts: SamplerConsts) -> Proposals:
    """The first half of a sweep (csrc/sweep_common.cuh::sweep_front):
    types, picks, first-wins conflicts, capacity and budget truncation."""
    B, C, K, NB = consts.batch, consts.capacity, consts.k, consts.n_bins
    dev = atoms.mass.device
    f32 = torch.float32

    idx = torch.arange(B, device=dev)
    n = atoms.n.to(torch.int64)
    u1, u2, _, _, _, ui0, ui1, ui2, ui3 = uni[:9]

    active = idx < min(remaining, B)

    # ---- proposal types (reference: SingleThreadedGibbsSampler.h:95-111)
    small = n < 2
    dp = death_prob(n.to(f32), consts)
    is_bd = u1 < 0.5
    is_death = active & is_bd & (u2 < dp) & ~small
    is_birth = active & ((is_bd & (u2 >= dp)) | small)
    is_move = active & ~small & (u1 >= 0.5) & (u1 < 0.75)
    is_exch = active & ~small & (u1 >= 0.75)

    # ---- picks: the table is compact, so a uniform rank is a slot
    n_c = torch.clamp(n, min=1)
    nf = n_c.to(f32)
    a1r = torch.minimum((ui0 * nf).to(torch.int64), n_c - 1)
    n1 = torch.clamp(n - 1, min=1)
    a2rr = torch.minimum((ui1 * n1.to(f32)).to(torch.int64), n1 - 1)
    a2r_ = a2rr + (a2rr >= a1r).to(torch.int64)  # uniform over ranks != a1
    a1c = a1r & (C - 1)
    a2c = torch.minimum(a2r_, n_c - 1) & (C - 1)
    e_birth = torch.clamp((ui2 * NB).to(torch.int64), max=NB - 1)

    elem_a1 = atoms.elem[a1c].to(torch.int64)
    elem_a2 = atoms.elem[a2c].to(torch.int64)
    elem1 = torch.where(is_birth, e_birth, torch.clamp(elem_a1, min=0))
    m1 = torch.where(is_birth, 0.0, atoms.mass[a1c])
    if consts.local_moves:
        # symmetric window e1 +/- U[1, W], W = mean atom spacing in bins
        W_f = torch.clamp(torch.floor(
            torch.tensor(float(NB), dtype=f32, device=dev) / nf), min=1.0)
        t2m = ui3 * 2.0
        sgn = torch.where(t2m < 1.0, -1.0, 1.0)
        frac = t2m - torch.floor(t2m)
        mag = torch.minimum(torch.floor(frac * W_f) + 1.0, W_f)
        # floor-mod of a possibly negative target (torch.remainder)
        e_move = torch.remainder(elem1.to(f32) + sgn * mag,
                                 NB).to(torch.int64)
    else:
        e_move = torch.clamp((ui3 * NB).to(torch.int64), max=NB - 1)
    elem2 = torch.where(is_move, e_move, torch.clamp(elem_a2, min=0))
    m2 = atoms.mass[a2c]
    r1 = elem1 // K
    c1 = elem1 - r1 * K
    r2 = elem2 // K
    c2 = elem2 - r2 * K
    uses2 = is_move | is_exch
    uses_a1 = is_death | is_move | is_exch

    keep = _keep(active, r1, r2, uses2, a1c, uses_a1, a2c, is_exch, consts)

    # capacity guard (conservative pre-rank), then exact budget truncation
    pre_birth_rank = torch.cumsum(keep & is_birth, 0)
    keep &= ~is_birth | (n + pre_birth_rank - 1 < C)
    rank = torch.cumsum(keep, 0)
    keep &= rank <= remaining

    return Proposals(keep=keep, is_birth=is_birth & keep,
                     is_death=is_death & keep, is_move=is_move & keep,
                     is_exch=is_exch & keep, a1c=a1c, a2c=a2c,
                     e_birth=e_birth, elem1=elem1, elem2=elem2, m1=m1, m2=m2,
                     r1=r1, c1=c1, r2=r2, c2=c2)


def sweep(uni: torch.Tensor, atoms: AtomTable, M: torch.Tensor, mstate,
          temp: float, remaining: int, consts: SamplerConsts,
          mass: MassParams, *, model):
    """One batched proposal sweep of one chain. Returns
    (atoms, M, mstate, n_processed, counts)."""
    B, C, K = consts.batch, consts.capacity, consts.k
    EPS = gaps_rng.EPSILON
    dev = M.device

    idx = torch.arange(B, device=dev)
    n = atoms.n.to(torch.int64)
    u_gibbs, u_exp, u_acc = uni[2:5]
    (keep, is_birth, is_death, is_move, is_exch, a1c, a2c, e_birth, elem1,
     elem2, m1, m2, r1, c1, r2, c2) = propose(uni, atoms, remaining, consts)

    # ---- alpha parameters for all lanes (used where kept)
    ab = model.alpha(mstate, M, AddrBatch(r1=r1, c1=c1, r2=r2, c2=c2))
    can1 = model.col_nz[c1] > 0.5
    can2 = model.col_nz[c2] > 0.5
    log_u = gaps_rng.log_uniform(u_acc)
    # a Gibbs draw whose s_mu is below the model's float32 noise floor
    # is refused (cogaps_tpu/ops/sweep.py:331-335)
    rel1 = torch.abs(ab.smu1) > ab.err1
    rel_pair = torch.abs(ab.smu_pair) > ab.err_pair
    zero = torch.zeros_like(m1)
    same_elem = elem1 == elem2

    # the three Gibbs-mass draws — birth (h:131-149), death rebirth
    # (h:154-188, withChange(-m1): s_mu' = s_mu + m1*s) and exchange
    # (h:228-257: no lambda, bounds (-m1, m2)) — as one call over 3B
    # lanes; lambda 0 gives the exchange form exactly
    b_s = ab.s1 * temp
    b_smu = ab.smu1 * temp
    d_s = ab.s1 * temp
    d_smu = (ab.smu1 + m1 * ab.s1) * temp
    p_s = ab.s_pair * temp
    p_smu = ab.smu_pair * temp
    mgm = mass.max_gibbs_mass.expand_as(m1)
    lam = mass.lam.expand_as(m1)
    gm, gm_ok = gaps_rng.gibbs_mass(
        u_gibbs.repeat(3), torch.cat([b_s, d_s, p_s]),
        torch.cat([b_smu, d_smu, p_smu]), torch.cat([zero, zero, -m1]),
        torch.cat([mgm, mgm, m2]), torch.cat([lam, lam, zero]))
    g_mass, d_gm, x_mass = gm.split(B)
    g_ok, d_gok, x_ok = gm_ok.split(B)

    # birth
    e_mass = gaps_rng.exponential(u_exp, mass.lam)
    b_mass = torch.where(can1, g_mass, e_mass)
    b_has = torch.where(can1, g_ok & rel1, True)
    birth_acc = is_birth & b_has & (b_mass > EPS)

    # death
    rel_d = torch.abs(ab.smu1 + m1 * ab.s1) > ab.err1
    rebirth = torch.where(can1 & d_gok & rel_d, d_gm, m1)
    dll_death = rebirth * (d_smu - d_s * rebirth * 0.5)
    death_rebirth = is_death & (log_u < dll_death)
    death_kill = is_death & ~(log_u < dll_death)

    # move (h:192-223)
    dll_move = -m1 * (p_smu + p_s * m1 * 0.5)
    move_acc = is_move & ~same_elem & (log_u < dll_move)

    # exchange; same-bin exchanges redistribute the pooled mass by a
    # truncated gamma(2), auto-accepted, matrix untouched
    # (ProposalQueue.cpp:267-277). The Newton inversion runs only when
    # some lane needs it.
    if bool((is_exch & same_elem).any()):
        new_sb = gaps_rng.trunc_gamma2_y(
            u_gibbs, (m1 + m2) * mass.lam) / mass.lam
    else:
        new_sb = zero
    d_sb = torch.where(m1 > m2, new_sb - m1, m2 - new_sb)
    nm1 = torch.where(same_elem, m1 + d_sb, m1 + x_mass)
    nm2 = torch.where(same_elem, m2 - d_sb, m2 - x_mass)
    ex_ok = ((same_elem & is_exch)
             | (~same_elem & (can1 | can2) & x_ok & rel_pair))
    ex_acc = is_exch & ex_ok & (nm1 > EPS) & (nm2 > EPS)

    # ---- matrix changes, clamped like safelyChangeMatrix
    # (DenseNormalModel.cpp:117-123)
    d1 = torch.where(birth_acc, b_mass, 0.0)
    d1 = torch.where(death_kill, -m1, d1)
    d1 = torch.where(death_rebirth, rebirth - m1, d1)
    d1 = torch.where(move_acc, -m1, d1)
    d1 = torch.where(ex_acc & ~same_elem, nm1 - m1, d1)
    d2 = torch.where(move_acc, m1, 0.0)
    d2 = torch.where(ex_acc & ~same_elem, nm2 - m2, d2)

    up_r = torch.cat([r1, r2])
    up_c = torch.cat([c1, c2])
    up_e = up_r * K + up_c
    M_flat = M.reshape(-1)
    old = M_flat[up_e]
    actual = torch.clamp(old + torch.cat([d1, d2]), min=0.0) - old
    M = M_flat.clone().index_add_(0, up_e, actual).reshape(M.shape)
    mstate = model.apply(mstate, ApplyBatch(rows=up_r, cols=up_c,
                                            deltas=actual))

    # ---- atom table writes, keeping it compact. Index C is a dump slot
    # for lanes that write nothing.
    write_a1 = death_kill | death_rebirth | move_acc | ex_acc
    mass_v1 = torch.where(death_kill, 0.0,
                          torch.where(death_rebirth, rebirth,
                                      torch.where(ex_acc, nm1, m1)))
    elem_v1 = torch.where(death_kill, -1, torch.where(move_acc, elem2, elem1))

    birth_rank = torch.cumsum(birth_acc, 0)
    bslot = (n + birth_rank - 1) & (C - 1)  # in bounds: capacity guard

    mass_arr = torch.cat([atoms.mass, zero[:1]])
    elem_arr = torch.cat([atoms.elem, atoms.elem.new_full((1,), -1)])
    sa = torch.where(write_a1, a1c, C)
    sb = torch.where(birth_acc, bslot, C)
    mass_arr[sa] = mass_v1
    mass_arr[torch.where(ex_acc, a2c, C)] = nm2
    mass_arr[sb] = b_mass
    elem_arr[sa] = elem_v1.to(torch.int32)
    elem_arr[sb] = e_birth.to(torch.int32)

    n_b = birth_acc.sum()
    n_d = death_kill.sum()
    n_new = n + n_b - n_d

    # holes below n_new are refilled from the live slots of the tail
    # [n_new, n + n_b); the k-th hole takes the k-th tail atom
    hole_mask = torch.zeros(C + 1, dtype=torch.bool, device=dev)
    hole_mask[torch.where(death_kill, a1c, C)] = True
    t_slot = (n_new + idx) & (C - 1)
    t_valid = idx < n_d
    t_filler = t_valid & ~hole_mask[t_slot]
    f_rank = torch.cumsum(t_filler, 0)
    hole = death_kill & (a1c < n_new)
    h_rank = torch.cumsum(hole, 0)
    rank_to_src = torch.zeros(B + 2, dtype=torch.int64, device=dev)
    rank_to_src[torch.where(t_filler, f_rank, B + 1)] = t_slot
    src = rank_to_src[torch.clamp(h_rank, max=B)] & (C - 1)
    fill_elem = elem_arr[src]
    fill_mass = mass_arr[src]
    sh = torch.where(hole, a1c, C)
    elem_arr[sh] = fill_elem
    mass_arr[sh] = fill_mass
    # clear the discarded tail last
    st = torch.where(t_valid, t_slot, C)
    elem_arr[st] = -1
    mass_arr[st] = 0.0

    atoms = AtomTable(mass=mass_arr[:C], elem=elem_arr[:C],
                      n=n_new.to(torch.int32))

    def cnt(*ms):
        return torch.stack(ms).sum(dim=1, dtype=torch.int32)

    counts = SweepCounts(
        processed=cnt(is_birth, is_death, is_move, is_exch),
        accepted=cnt(birth_acc, death_kill | death_rebirth, move_acc,
                     ex_acc))
    return atoms, M, mstate, keep.sum(), counts


def run_updates(blocks: Callable[[int], torch.Tensor], atoms: AtomTable,
                M: torch.Tensor, mstate, temp: float, n_steps: int,
                consts: SamplerConsts, mass: MassParams, *, model,
                max_sweeps=None):
    """Process `n_steps` proposals of one chain in batched sweeps — the
    analog of GibbsSampler::update(nSteps) (reference:
    AsynchronousGibbsSampler.h:89-121). `blocks(i)` gives sweep i's
    (16, B) uniform block. Progress is guaranteed: the first active
    proposal of every sweep survives. `max_sweeps` stops early (for
    sweep-by-sweep comparisons).

    Returns (atoms, M, mstate, n_done, n_sweeps, counts)."""
    done = 0
    i = 0
    processed = torch.zeros(4, dtype=torch.int32, device=M.device)
    accepted = torch.zeros_like(processed)
    while done < n_steps and (max_sweeps is None or i < max_sweeps):
        atoms, M, mstate, n_proc, c = sweep(
            blocks(i), atoms, M, mstate, temp, n_steps - done, consts,
            mass, model=model)
        done += int(n_proc)
        i += 1
        processed = processed + c.processed
        accepted = accepted + c.accepted
    return atoms, M, mstate, done, i, SweepCounts(processed, accepted)
