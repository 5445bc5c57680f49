"""nvcc builds of the package's CUDA sources (csrc/), at first use.

Each source is compiled on its own into a shared library with a plain C
interface under cogaps_tpu_torch/_build/, keyed by a hash of the source,
the headers beside it and the flags, and loaded with ctypes. A build
that fails raises with nvcc's output; ptxas's register and shared-memory
report is kept beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: every float operation rounds on its own, as the separate
# PyTorch operations of the plain versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


@functools.cache
def load(name: str) -> tuple:
    """Compile csrc/<name>.cu (once per hash) and load it. Returns
    (ctypes library, compiler report). Its span counts 1 where nvcc
    ran."""
    with trace.span("build.load", compiled=0) as sp:
        source = CSRC / f"{name}.cu"
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for part in [source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(part.read_bytes())
        lib_path = BUILD_DIR / f"libcogaps_{name}_{h.hexdigest()[:16]}.so"
        report_path = lib_path.with_suffix(".log")
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            report_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
            sp.add(compiled=1)
        lib = ctypes.CDLL(str(lib_path))
        report = report_path.read_text() if report_path.exists() else ""
    return lib, report


def check(name, t, dtype, shape, device):
    """Raise unless tensor `t` is what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index`."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
