"""One sparse-model update call for NCH chains: the CUDA CSR sweep kernel
(csrc/atlas.cu) and its wrapper.

``run_updates_atlas_multi`` runs every chain's ``update(nSteps)`` of the
sparse normal model in one launch, one thread block per chain, reading
each proposal's data row through the CSR layout (models/sparse.
CsrMatrix) and the frozen partner factor: no per-row tables. It
replaces cogaps_tpu/ops/pallas_atlas.py::_kernel_atlas and its wrapper
run_updates_atlas. For tensors on the CPU it runs the plain version,
ops/sweep.run_updates with models/sparse.make_model chain by chain; for
CUDA tensors it launches the kernel or raises. The random modes are
those of ops/sweep_cuda.py (exact: a UniformSource; fast: a PhiloxKey).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ..models import sparse
from . import cuda_build
from .atoms import AtomTable, stack_atoms
from .sweep import MassParams, SamplerConsts, UniformSource, run_updates
from .sweep_cuda import (KernelState, PhiloxKey, drive, plain_chains,
                         stack_counts)


MAX_K = 64  # csrc/atlas.cu holds a factor row in two registers a thread


def build() -> tuple:
    """Compile csrc/atlas.cu (once per source hash) and load it. Returns
    (ctypes library, compiler report)."""
    lib, report = cuda_build.load("atlas")
    fn = lib.cogaps_atlas_launch
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * 16 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, report


def run_updates_atlas_multi(atoms: AtomTable, M: torch.Tensor,
                            csr: sparse.CsrMatrix, other: torch.Tensor,
                            temp: float, n_steps: torch.Tensor,
                            consts: SamplerConsts, mass: MassParams,
                            rand: Union[PhiloxKey, UniformSource], *,
                            s_max: int = 32,
                            max_sweeps: Optional[int] = None):
    """Sparse-model update calls of NCH chains. atoms: (NCH, C) tables
    with n (NCH,); M: (NCH, n_rows, k) the sampled factor; csr: the data
    rows of every chain in this orientation; other: (NCH, m, k) the
    frozen partner factor; n_steps (NCH,) int32 budgets; mass fields
    (NCH,). The inputs are left untouched.

    Returns (atoms, M, done, n_sweeps, counts), chain-stacked."""
    if max_sweeps is not None and isinstance(rand, PhiloxKey):
        raise ValueError("max_sweeps needs a UniformSource (exact mode)")
    if M.device.type == "cpu":
        return run_updates_atlas_multi_plain(
            atoms, M, csr, other, temp, n_steps, consts, mass, rand,
            max_sweeps=max_sweeps)
    if M.device.type != "cuda":
        raise ValueError(f"no sweep for tensors on {M.device}")
    return _run_kernel(atoms, M, csr, other, temp, n_steps, consts, mass,
                       rand, s_max, max_sweeps)


run_updates_atlas_multi.launches = 0


@torch.inference_mode()
def run_updates_atlas_multi_plain(atoms, M, csr, other, temp, n_steps,
                                  consts, mass, rand, max_sweeps=None):
    """The plain version of run_updates_atlas_multi: ops/sweep.run_updates
    with models/sparse.make_model over each chain's rows as ELL (built
    from the CSR once and kept), on whatever device the tensors are."""

    def one(c, blocks, budget, chain_mass):
        model = sparse.make_model(csr.ell(c),
                                  sparse.make_sparse_phase(other[c]))
        return run_updates(blocks, atoms.chain(c), M[c], (), temp, budget,
                           consts, chain_mass, model=model,
                           max_sweeps=max_sweeps)

    outs = plain_chains(one, rand, n_steps, consts.batch, mass, M.device)
    return (stack_atoms([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]), *stack_counts(outs, M.device))


def _run_kernel(atoms, M, csr, other, temp, n_steps, consts, mass, rand,
                s_max, max_sweeps):
    NCH, NR, K = M.shape
    m = other.shape[1]
    dev = M.device
    if K > MAX_K:
        raise ValueError(f"the CSR sweep kernel takes k <= {MAX_K}, not {K}")
    st = KernelState.make(atoms, M, consts, mass, n_steps)
    cuda_build.check("other", other, torch.float32, (NCH, m, K), dev)
    cuda_build.check("csr.indptr", csr.indptr, torch.int64, (NCH, NR + 1),
                     dev)
    nnz = csr.idx.shape[0]
    cuda_build.check("csr.idx", csr.idx, torch.int32, (nnz,), dev)
    cuda_build.check("csr.val", csr.val, torch.float32, (nnz,), dev)
    # Z2 and canUseGibbs from the frozen partner factor, as the plain
    # version's make_sparse_phase forms them
    phase = sparse.make_sparse_phase(other)
    Z2 = phase.Z2.contiguous()
    colnz = phase.col_nz.to(torch.int32)
    lib, _ = build()

    def launch(budget_t, uni, s_lim, key0, key1, stream):
        err = lib.cogaps_atlas_launch(
            NCH, consts.batch, consts.capacity, NR, K, m,
            int(consts.local_moves), float(consts.alpha * consts.n_bins),
            float(consts.domain_length), float(temp),
            mass.lam.data_ptr(), mass.max_gibbs_mass.data_ptr(),
            budget_t.data_ptr(), st.mass.data_ptr(), st.elem.data_ptr(),
            st.n.data_ptr(), st.M.data_ptr(), other.data_ptr(),
            Z2.data_ptr(), csr.indptr.data_ptr(), csr.idx.data_ptr(),
            csr.val.data_ptr(), colnz.data_ptr(), st.scratch.data_ptr(),
            st.out.data_ptr(), uni.data_ptr() if uni is not None else None,
            s_lim, key0.data_ptr() if key0 is not None else None, key1,
            stream)
        if err != 0:
            raise RuntimeError(f"atlas kernel launch failed: CUDA error {err}")
        run_updates_atlas_multi.launches += 1

    done, n_sweeps, counts = drive(launch, st, n_steps, consts.batch, rand,
                                   s_max, max_sweeps)
    return st.atoms(), st.M, done, n_sweeps, counts
