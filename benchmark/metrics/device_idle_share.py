"""The device's idle share of the traced stretch: 1 - the union of the
device's operation intervals over the stretch's wall time, both from the
profiler's trace (the arithmetic of cogaps_tpu_torch/profile_iter).
The profiler slows the host's launches on the per-call route (CUPTI's
cost a launch), so a traced stretch runs slower than an untraced one and
this share reads higher than the device's idle share in an untraced
run; the kernels' durations it records are the device's."""

from . import busy_ns, traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or tr["wall_s"] <= 0:
        return None
    busy = busy_ns((s, s + d) for _, s, d in tr["device"]) * 1e-9
    return 1.0 - busy / tr["wall_s"]
