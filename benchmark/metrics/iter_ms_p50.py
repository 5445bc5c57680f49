"""The median over the window's chunks that ran without the profiler of
milliseconds an iteration: beside iter_ms, which takes all the window's
time, a statistic that the host's bursts of slowness move less."""

import statistics


def read(ctx):
    per = [1e3 * sec / n for n, sec, traced in ctx.get("chunks") or []
           if n > 0 and not traced]
    return statistics.median(per) if per else None
