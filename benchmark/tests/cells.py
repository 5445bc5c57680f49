"""The benchmark's cells cut to a size the CPU runs in seconds: each
cell's configuration, traffic and limits as its files give them, the
shapes and iterations cut."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell at a small size: its configuration, traffic and limits as the
# files give them, the shapes and iterations cut; a window of WINDOW_S
# runs the whole sampling phase, 200 iterations
WINDOW_S = 120.0
SMALL = {
    "gwcogaps-bulk-20k.fused": dict(n_genes=80, n_samples=12,
                                    n_patterns=3, n_iterations=200),
}
# the limits of the numbers that judge the sampler's moves and sums, at
# the small size: 200 iterations from the empty state fit 80 x 12 less
# closely than the cell's burned-in chains fit theirs (sound runs read
# fit_share 0.09 and 0.24 with a history, stats_gap 0.03-0.04; the planted
# faults 1.0 or more and 0.50)
SMALL_LIMITS = {"fit_share": 0.5, "stats_gap": 0.4}
# the check's chi^2 history path, which the cell does not take: the small
# cell with a history every 20 iterations, so the per-call route runs,
# held to the chi^2 limit that the per-call cell was (PERF.md, section 7)
HISTORY = "gwcogaps-bulk-20k.fused+history"
HISTORY_CHISQ_LIMIT = 2e-6
CASES = sorted(SMALL) + [HISTORY]


def small_cell(name: str) -> dict:
    from benchmark import harness
    base = name.split("+")[0]
    cell = harness.load_cell(base)
    cell["config_spec"].update(SMALL[base])
    cell["traffic_spec"].update(chunk_iters=20, trace_skip_chunks=1,
                                trace_chunks=1)
    cell["burn_in"] = 200
    cell["limits"].update(SMALL_LIMITS)
    if name == HISTORY:
        cell["name"] = name
        cell["traffic_spec"]["output_frequency"] = 20
        cell["limits"]["chisq_gap"] = HISTORY_CHISQ_LIMIT
    return cell
