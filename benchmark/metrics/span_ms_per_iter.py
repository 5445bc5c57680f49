"""Device milliseconds of the fused span kernel (csrc/span.cu: K3, whole
iterations of both samplers a launch) an iteration, over the traced
stretch."""

from . import SPAN, kernels, traced


def read(ctx):
    tr = traced(ctx)
    if tr is None:
        return None
    ev = kernels(tr, SPAN)
    return sum(d for _, _, d in ev) * 1e-6 / tr["iterations"] if ev else None
