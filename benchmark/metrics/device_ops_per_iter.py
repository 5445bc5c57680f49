"""Device operations (kernels, copies, sets) of the traced stretch over
its iterations: the engine route's launches an iteration."""

from . import traced


def read(ctx):
    tr = traced(ctx)
    return len(tr["device"]) / tr["iterations"] if tr else None
