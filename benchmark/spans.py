"""The program's own spans in a traced run, and the device's idle time
they hold.

cogaps_tpu_torch/utils/trace.py marks the fused route's steps; while
torch.profiler records, each span is a host event of the profile under
its name, on the clock of the device's events. A program without those
spans gives a profile without such events, and each function here then
finds nothing.
"""

from __future__ import annotations

from .metrics import busy_ns

# the spans of cogaps_tpu_torch/utils/trace.py's callers
PROGRAM_SPANS = ("run_phase", "run_span", "span.prepare", "span.shape",
                 "span.normals", "span.launch", "build.load")
OUTSIDE = "(outside the program)"


def host_spans(tr: dict, name: str) -> list:
    """(start_ns, end_ns) of the traced stretch's spans `name`, in time
    order."""
    return sorted((s, s + d) for n, s, d in tr["host"] if n == name)


def idle_ns(tr: dict, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) outside the union of device operations."""
    busy = busy_ns((max(s, lo), min(s + d, hi)) for _, s, d in tr["device"]
                   if s < hi and s + d > lo)
    return max(0, hi - lo - busy)


def idle_gaps(tr: dict) -> list:
    """The idle gaps between the traced stretch's device operations, as
    harness.breakdown finds them: (lo, hi) in time order."""
    iv = sorted((s, s + d) for _, s, d in tr["device"])
    gaps, reach = [], (iv[0][1] if iv else None)
    for s, e in iv[1:]:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    return gaps


def idle_by_span(tr: dict, top=10) -> list:
    """The idle gaps of idle_gaps, each labelled by the innermost program
    span over its middle (OUTSIDE where none is), summed by label: the
    `top` largest (all with None), each [name, seconds]."""
    spans = sorted((s, s + d, n) for n, s, d in tr["host"]
                   if n in PROGRAM_SPANS)
    by, active, j = {}, [], 0
    for lo, hi in idle_gaps(tr):
        mid = (lo + hi) / 2
        while j < len(spans) and spans[j][0] <= mid:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[1] >= mid]
        inner = min(active, key=lambda sp: sp[1] - sp[0], default=None)
        label = inner[2] if inner else OUTSIDE
        by[label] = by.get(label, 0) + (hi - lo)
    return [[n, t * 1e-9] for n, t in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]
