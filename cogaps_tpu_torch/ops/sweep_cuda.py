"""One sampler's update call for NCH chains: the CUDA sweep kernel
(csrc/sweep.cu) and its wrapper.

``run_updates_multi`` runs every chain's ``update(nSteps)`` — all sweeps
until each chain's budget is spent — as one kernel launch with one
thread block per chain. It replaces cogaps_tpu/ops/pallas_sweep.py::
_kernel_b and its wrapper run_updates_pallas_multi. For tensors on the
CPU it runs the plain version (ops/sweep.run_updates, chain by chain);
for CUDA tensors it launches the kernel or raises.

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

The kernel is built from csrc/sweep.cu with nvcc at first use, into
cogaps_tpu_torch/_build/, keyed by a hash of the source and the flags,
and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Union

import torch

from ..models import dense
from . import rng as gaps_rng
from .atoms import AtomTable, stack_atoms
from .sweep import (MassParams, SamplerConsts, SweepCounts, UniformSource,
                    run_updates)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sweep.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false: every float operation rounds on its own, as the separate
# PyTorch operations of the plain version do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
MAX_BATCH = 1024
_N_OUT = 10  # done, sweeps, processed[4], accepted[4]
_PLAIN_CHUNK = 8  # sweeps of uniforms the plain version draws at once


class PhiloxKey(NamedTuple):
    """Fast-mode key: chain c's blocks are philox((lane, row group,
    sweep, c), (key0[c], key1))."""

    key0: torch.Tensor  # (NCH,) int64 per-chain seed words, on the device
    key1: int  # (phase, iteration, sampler) word


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


@functools.cache
def build() -> tuple:
    """Compile csrc/sweep.cu (once per source hash) and load it.
    Returns (ctypes library, compiler report)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"libcogaps_sweep_{digest[:16]}.so"
    report_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        report_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.cogaps_sweep_launch
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    report = report_path.read_text() if report_path.exists() else ""
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
    NCH = M.shape[0]
    B = consts.batch
    if isinstance(rand, PhiloxKey):
        key = rand

        def rand(c, first, n):
            return gaps_rng.philox_uniforms(key.key0[c], key.key1, c, first,
                                            n, B, device=M.device)

    budgets = [int(x) for x in n_steps.tolist()]
    outs = []
    for c in range(NCH):
        slab = {}

        def blocks(i, c=c, slab=slab):
            # draw _PLAIN_CHUNK sweeps' blocks at a time
            first = i - i % _PLAIN_CHUNK
            if first not in slab:
                slab.clear()
                slab[first] = rand(c, first, _PLAIN_CHUNK).reshape(
                    _PLAIN_CHUNK, 16, B)
            return slab[first][i - first]

        model = dense.make_model(dense.DensePhase(
            SQ=phase.SQ[c], Z=phase.Z[c], col_nz=phase.col_nz[c]))
        outs.append(run_updates(
            blocks, atoms.chain(c), M[c], dense.DenseCache(Y=Y[c]), temp,
            budgets[c], consts,
            MassParams(lam=mass.lam[c], max_gibbs_mass=mass.max_gibbs_mass[c]),
            model=model, max_sweeps=max_sweeps))
    ints = functools.partial(torch.tensor, dtype=torch.int32,
                             device=M.device)
    return (stack_atoms([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2].Y for o in outs]),
            ints([o[3] for o in outs]), ints([o[4] for o in outs]),
            SweepCounts(processed=torch.stack([o[5].processed for o in outs]),
                        accepted=torch.stack([o[5].accepted for o in outs])))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _run_kernel(atoms, M, Y, phase, temp, n_steps, consts, mass, rand,
                s_max, max_sweeps):
    NCH, NR, K = M.shape
    B, C = consts.batch, consts.capacity
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
    if C <= 0 or C & (C - 1):
        raise ValueError(f"capacity {C} is not a power of two")
    if (NR, K) != (consts.n_rows, consts.k):
        raise ValueError("factor shape does not match the sampler constants")
    dev = M.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("atoms.mass", atoms.mass, f32, (NCH, C)),
            ("atoms.elem", atoms.elem, i32, (NCH, C)),
            ("atoms.n", atoms.n, i32, (NCH,)), ("M", M, f32, (NCH, NR, K)),
            ("Y", Y, f32, (NCH, NR, K)), ("SQ", phase.SQ, f32, (NCH, NR, K)),
            ("Z", phase.Z, f32, (NCH, NR * K, K)),
            ("col_nz", phase.col_nz, torch.bool, (NCH, K)),
            ("lam", mass.lam, f32, (NCH,)),
            ("max_gibbs_mass", mass.max_gibbs_mass, f32, (NCH,)),
            ("n_steps", n_steps, i32, (NCH,))):
        _check(name, t, dt, shape, dev)
    # the kernel works in place on copies of the state
    mass_t, elem_t = atoms.mass.clone(), atoms.elem.clone()
    n_t = atoms.n.clone()
    M_t, Y_t = M.clone(), Y.clone()
    SQ, Z, lam, mgm, budget = (phase.SQ, phase.Z, mass.lam,
                               mass.max_gibbs_mass, n_steps)
    colnz = phase.col_nz.to(i32)
    scratch = torch.empty(NCH * (NR + 2 * C + 2), dtype=i32, device=dev)
    out = torch.empty((NCH, _N_OUT), dtype=i32, device=dev)
    lib, _ = build()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(budget_t, uni, s_lim, key0, key1):
        with torch.cuda.device(dev):
            err = lib.cogaps_sweep_launch(
                NCH, B, C, NR, K, int(consts.local_moves),
                float(consts.alpha * consts.n_bins),
                float(consts.domain_length), float(temp),
                lam.data_ptr(), mgm.data_ptr(), budget_t.data_ptr(),
                mass_t.data_ptr(), elem_t.data_ptr(), n_t.data_ptr(),
                M_t.data_ptr(), Y_t.data_ptr(), SQ.data_ptr(), Z.data_ptr(),
                colnz.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                uni.data_ptr() if uni is not None else None, s_lim,
                key0.data_ptr() if key0 is not None else None, key1,
                stream)
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
        run_updates_multi.launches += 1

    if isinstance(rand, PhiloxKey):
        _check("key0", rand.key0, torch.int64, (NCH,), dev)
        launch(budget, None, 0, rand.key0, rand.key1 & 0xFFFFFFFF)
        done, n_sweeps = out[:, 0], out[:, 1]
        counts = SweepCounts(processed=out[:, 2:6], accepted=out[:, 6:10])
    else:
        # exact mode: slabs of s_max blocks until every budget is spent.
        # Unfinished chains have all run the same number of sweeps.
        target = budget.cpu()
        total = torch.zeros((NCH, _N_OUT), dtype=i32)
        swept = 0
        while bool((total[:, 0] < target).any()):
            s_lim = s_max
            if max_sweeps is not None:
                s_lim = min(s_max, max_sweeps - swept)
                if s_lim <= 0:
                    break
            offs = total[:, 1].tolist()
            uni = torch.stack([rand(c, offs[c], s_lim) for c in range(NCH)]
                              ).to(device=dev, dtype=f32).contiguous()
            _check("uniforms", uni, f32, (NCH, s_lim * 16, B), dev)
            left = (target - total[:, 0]).to(device=dev)
            launch(left, uni, s_lim, None, 0)
            total += out.cpu()
            swept += s_lim
        done, n_sweeps = total[:, 0].to(dev), total[:, 1].to(dev)
        counts = SweepCounts(processed=total[:, 2:6].to(dev),
                             accepted=total[:, 6:10].to(dev))
    return (AtomTable(mass=mass_t, elem=elem_t, n=n_t), M_t, Y_t, done,
            n_sweeps, counts)
