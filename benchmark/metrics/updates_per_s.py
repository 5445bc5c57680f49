"""All chains' atom updates (stats.upd, totalUpdates as the port counts
them) of the window over its wall time."""


def read(ctx):
    return ctx["updates"] / ctx["window_s"] if ctx["window_s"] > 0 else None
