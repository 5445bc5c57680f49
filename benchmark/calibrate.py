"""The readings that a cell's limits are set from: on each seed, one run
of the cell as run.py makes it (set-up, burn-in, the window), and then on
the state the window left both the program's numbers and the control's,
the reference put in the program's place in TF32 (reference/check.py).
With --fault, the named fault of benchmark/faults.py is planted under the
timed path from burn-in on, and the run's numbers are the fault's
readings (no control).

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault <name>]

One JSON line a seed: {"seed", "program": {...}, "control": {...},
"metrics"}, then each number's largest reading of the program and
smallest of the control (or, with --fault, each number's smallest
reading). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, run  # noqa: E402  (sets the caches' dirs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args()
    run.require_cards(1)

    import torch

    from benchmark import harness
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    plant = faults.FAULTS[args.fault][0] if args.fault else None
    lows, highs = {}, {}
    for seed in args.seeds:
        r = harness.run_cell(bench, args.workload, run.norm_seed(seed),
                             args.seconds, False, torch.device("cuda"),
                             time.perf_counter(), faults=plant,
                             control=plant is None)
        prog = {n: c["value"] for n, c in r["checks"].items()}
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "program": prog, "control": r.get("control"),
                          "metrics": r["metrics"]}), flush=True)
        for n, v in prog.items():
            if v is None:
                continue
            pick = min if plant else max
            lows[n] = pick(lows.get(n, v), v)
        for n, v in (r.get("control") or {}).items():
            highs[n] = min(highs.get(n, v), v)
    key = "smallest_fault" if plant else "largest_program"
    print(json.dumps({key: lows, "smallest_control": highs,
                      "fault": args.fault,
                      "device": torch.cuda.get_device_name()}), flush=True)


if __name__ == "__main__":
    main()
