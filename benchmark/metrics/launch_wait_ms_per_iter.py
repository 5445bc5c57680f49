"""The device's idle milliseconds an iteration between the start of each
of the traced stretch's run_phase spans (cogaps_tpu_torch/utils/trace.py:
MultichainEngine.run_phase, one a chunk) and the first span kernel (K3)
after it: the wait that the program's host work before its first launch
imposes at each chunk's start, over the stretch's iterations."""

from ..spans import host_spans, idle_ns
from . import SPAN, kernels, traced


def read(ctx):
    tr = traced(ctx)
    if tr is None:
        return None
    starts = [s for _, s, _ in kernels(tr, SPAN)]
    waits = []
    for lo, _ in host_spans(tr, "run_phase"):
        first = next((s for s in starts if s >= lo), None)
        if first is not None:
            waits.append(idle_ns(tr, lo, first))
    return sum(waits) * 1e-6 / tr["iterations"] if waits else None
