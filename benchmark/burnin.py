"""The atom counts of a cell's chains from the empty state, as its set-up
burns them in: the last `--equil` iterations of the equilibration phase
(temperature 1), then `--sampling` iterations of the sampling phase, in
chunks of the cell's `chunk_iters`, each chunk's mean atom counts (A, P;
over the chains) and wall ms an iteration. The curve sets a cell's
`burn_in`: the fewest iterations after which the counts stay within
their stationary spread.

    python3 benchmark/burnin.py --workload <cell> --seed <n> --equil 20000 \
        --sampling 5000 [--set '{"a_density": 0.3}']

`--set` replaces keys of the cell's configuration for this run (to try a
setting before it goes into the file). Each chunk's line also gives the
worst entry's drift of a factor from its atoms (|M - the sum of its
atoms' masses|, over both factors and the chains; CoGAPS's maximumDrift
is 0.01) and chi^2 as a share of the zero model's (sum D^2 / S^2), the
worst chain's. One JSON line a chunk, then a summary line. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402  (sets the caches' directories)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--equil", type=int, default=20000)
    ap.add_argument("--sampling", type=int, default=5000)
    ap.add_argument("--set", default="{}")
    args = ap.parse_args()
    run.require_cards(1)

    import torch

    from benchmark import data, harness
    from cogaps_tpu_torch.engine import EQUILIBRATION, SAMPLING

    cell = harness.load_cell(args.workload)
    cell["config_spec"].update(json.loads(args.set))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    D = data.generate(cell["config_spec"], run.norm_seed(args.seed), dev)
    s = harness.Setup(cell, D, run.norm_seed(args.seed), dev)
    del D
    print(json.dumps({"setup_s": time.perf_counter() - t0,
                      **s.shapes()}), flush=True)
    d = s.eng.data
    zero_chisq = (d.D * d.D * d.invS2).sum(dim=(1, 2))
    k = s.config.n_patterns

    def drift(atoms, M):
        per = torch.zeros(M.shape[0], M.shape[1] * k, device=dev)
        live = atoms.elem >= 0
        per.scatter_add_(1, atoms.elem.clamp(min=0).long(),
                         torch.where(live, atoms.mass, 0.0))
        return float((per.reshape(M.shape) - M).abs().max())

    n = s.config.n_iterations
    chunk = int(cell["traffic_spec"]["chunk_iters"])
    rows = []
    for phase, lo, hi in ((EQUILIBRATION, n - args.equil, n),
                          (SAMPLING, 0, args.sampling)):
        for a in range(lo, hi, chunk):
            b = min(a + chunk, hi)
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.state, s.stats = s.eng.run_phase(s.state, s.stats, s.rand,
                                               phase, a, b)
            n_a = s.state.atoms_a.n.float().mean().item()
            n_p = s.state.atoms_p.n.float().mean().item()
            ms = (time.perf_counter() - t) * 1e3 / (b - a)
            done = (b - (n - args.equil) if phase == EQUILIBRATION
                    else args.equil + b)
            row = {"iters_from_empty": done, "phase": phase, "n_a": n_a,
                   "n_p": n_p, "ms_per_iter": round(ms, 4),
                   "drift": max(drift(s.state.atoms_a, s.state.M_a),
                                drift(s.state.atoms_p, s.state.M_p)),
                   "chisq_share": float((s.eng.chisq(s.state)
                                         / zero_chisq).max())}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary": args.workload, "seed": args.seed,
                      "chunks": len(rows), "capacity_a":
                      s.config.capacity_a, "capacity_p": s.config.capacity_p,
                      "device": torch.cuda.get_device_name()}), flush=True)


if __name__ == "__main__":
    main()
