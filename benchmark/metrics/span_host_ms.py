"""The median host milliseconds of the traced stretch's run_span spans
(cogaps_tpu_torch/utils/trace.py: ops/span_cuda.run_span, one a K3
launch): the host's busy time a launch, which on the card enqueues."""

import statistics

from ..spans import host_spans
from . import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None:
        return None
    spans = host_spans(tr, "run_span")
    return (statistics.median((e - s) * 1e-6 for s, e in spans)
            if spans else None)
