"""The H100 counterparts of the JAX package's Mosaic and DMA probes.

tools/probe_mosaic*.py and tools/probe_dma*.py measured, on the TPU, the
primitives the Pallas kernels rest on: skinny batched contractions, lane
prefix sums, first-wins conflict tests, one-hot minima, elementwise
chains, loops with a trip count in device memory, 3-D reductions,
in-kernel random bits, and row gathers and scatters. Here each primitive
is a function with a kernel written for Hopper and a plain PyTorch
version beside it:

* ``mosaic.py`` — F1 bdot, F2 prefix, F3 first_wins, F4 claim_min,
  F5 elem_chain, F6 while_sum, F7 reduce3d, F8 uniform
  (csrc/probe_mosaic.cu);
* ``dma.py`` — F9 gather_rows / gather_block / gather_passes /
  gather_batched, F10 scatter_slots, F11 strided_sum (csrc/probe_dma.cu).

A wrapper checks its inputs (ops/cuda_build.check: device, dtype, shape,
contiguity), then runs the plain version on CPU tensors and launches the
kernel on CUDA tensors, or raises; it counts its launches in
``launches``. Beside each wrapper,
``<name>_counts`` gives the bytes the function must read and write (each
once) and its operations, for ``bound_ms``.

``python -m cogaps_tpu_torch.probes`` runs every function on the card at
the probes' shapes and at the port's own (``__main__.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 outside the
# tensor cores; 32-bit integer operations are counted against the same
# rate, and it is the float64 tensor-core rate too, so it also bounds the
# span kernel's float64 rebuild. chip_smoke.py bounds every kernel with
# bound_ms.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = 67e12
H100_TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores

_CTYPES = {"i": ctypes.c_int, "f": ctypes.c_float, "p": ctypes.c_void_p}


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = H100_OPS_PER_S) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate (float32
    outside the tensor cores unless `ops_per_s` names another), in ms,
    and which of the two it is ("bytes" or "operations")."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bind(name: str, signatures: dict) -> tuple:
    """Compile csrc/<name>.cu (once per source hash), load it, and set the
    argument types of its C entry points: `signatures` maps each to a
    string of i (int), f (float) and p (pointer) letters, the stream
    last. Every entry point returns a CUDA error code. Returns (library,
    compiler report)."""
    lib, report = cuda_build.load(name)
    for fn_name, letters in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [_CTYPES[c] for c in letters]
        fn.restype = ctypes.c_int
    return lib, report


def on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no probe kernel for tensors on {t.device}")


def launch(wrapper, fn, *args) -> None:
    """Call C entry point `fn` with `args` and the current stream, raise
    on a nonzero status, and count the launch on `wrapper`."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"CUDA error {err}")
    wrapper.launches += 1
