"""The benchmark of cogaps_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the package cogaps_tpu_torch. The
cell's files are under benchmark/ (workloads/, configs/, traffic/), its
metrics are BENCHMARK.json's and each metric's reader is
metrics/<metric>.py. The run prints the launch counters and the numbers
that decide `correct` on standard error, and as the last line of standard
output one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 a breakdown of the traced stretch, and last the
checks, each number with its limit. It exits with another code than 0,
and prints no result, where no CUDA card is found, or where the process
has loaded JAX or the JAX package by the window's close.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

# every build and kernel cache in the checkout, at fixed paths (the
# program's own nvcc builds go to cogaps_tpu_torch/_build/)
CACHE = HERE / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "cogaps_tpu")


def norm_seed(seed: int) -> int:
    """--seed as a whole number in [0, 2^63): any integer maps to one."""
    return int(seed) % (1 << 63)


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        sys.exit(f"the cell needs {n} CUDA devices, "
                 f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def forbidden_modules() -> list:
    """Modules of sys.modules whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        sys.exit(f"no cell {args.workload!r} in BENCHMARK.json")
    require_cards(int(cells[args.workload]["chips"]))

    import torch

    from benchmark import harness
    result = harness.run_cell(bench, args.workload, norm_seed(args.seed),
                              args.seconds, bool(args.trace),
                              torch.device("cuda"), T_START)
    found = forbidden_modules()
    if found:
        sys.exit("the run loaded " + ", ".join(found)
                 + ": nothing the benchmark runs may load JAX or the JAX "
                 "package")
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
