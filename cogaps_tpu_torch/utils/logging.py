"""Logging discipline — a copy of cogaps_tpu/utils/logging.py
(log_message, log_worker) without the JAX process-index check: the port
runs as one process (reference: src/utils/GapsPrint.h:3-15 and the
worker start/finish lines GapsRunner.cpp:429-433,495-501); and
build_report, the port's runtime report."""

from __future__ import annotations

import sys


def log_message(msg: str) -> None:
    print(msg, file=sys.stdout, flush=True)


def log_worker(worker_id: int, msg: str) -> None:
    print(f"    worker {worker_id} {msg}", file=sys.stdout, flush=True)


def build_report() -> str:
    """Runtime/environment report — the analog of the reference's
    buildReport() (reference: src/utils/GlobalConfig.h:27-55, surfaced
    through getBuildReport_cpp): the package's version, torch's and its
    CUDA's, the devices, the kernel libraries built in _build/ and whether
    the native parser is built. It builds nothing."""
    import torch

    import cogaps_tpu_torch
    from ..io import native
    from ..ops import cuda_build

    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        devices = f"{torch.cuda.get_device_name(0)} x {n}"
    else:
        devices = "cpu"
    kernels = sorted(p.name for p in cuda_build.BUILD_DIR.glob("libcogaps_*.so"))
    try:
        lib = native.library_path()
        parser = (f"built ({lib.name})" if lib.exists()
                  else "not built (built at first use)")
    except Exception as e:  # noqa: BLE001 — no compiler or no source
        parser = f"cannot be built ({type(e).__name__}: {e})"
    lines = [
        f"cogaps_tpu_torch version: {cogaps_tpu_torch.__version__}",
        f"torch: {torch.__version__}, CUDA: {torch.version.cuda}",
        f"devices: {devices}",
        f"kernel libraries in {cuda_build.BUILD_DIR.name}/: "
        + (", ".join(kernels) if kernels else "none built"),
        f"native parser: {parser}",
        "sweep kernels: CUDA sm_90a (csrc/) on CUDA tensors, plain "
        "PyTorch on CPU tensors",
        "checkpoints: enabled",
    ]
    return "\n".join(lines)
