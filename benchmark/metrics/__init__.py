"""One reader a metric, metrics/<metric>.py, each with `read(ctx)`: the
metric's value, or None where the run gives it nothing to read (the
harness then leaves the metric out of the result's line).

ctx holds, from the run: setup_s, window_s, iterations, updates (all
chains' atom updates of the window), chains, chunks (each chunk's
iterations, seconds and whether it ran under the profiler), shapes
(chains, genes, samples, k, nnz of the stacked subsets), cell (its
files' contents) and, in a traced run, trace: device and host events of
the traced stretch, each (name, start_ns, duration_ns), its wall_s and
its iterations.
Helpers shared by the readers are here."""

from __future__ import annotations

import re


def traced(ctx: dict):
    """The traced stretch, or None where the run traced nothing or the
    stretch ran no iteration."""
    tr = ctx.get("trace")
    if not tr or not tr["iterations"] or not tr["device"]:
        return None
    return tr


def kernels(tr: dict, pattern: str) -> list:
    """The traced device events whose names match `pattern`, in time
    order."""
    rx = re.compile(pattern)
    return sorted((e for e in tr["device"] if rx.search(e[0])),
                  key=lambda e: e[1])


def busy_ns(intervals) -> int:
    """Length of the union of [start, end) intervals (the arithmetic of
    cogaps_tpu_torch/profile_iter.busy_ns)."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


# kernel names of the port's CUDA sources
SPAN = r"\bspan_kernel\b"
