"""The window's wall time over the sampling iterations it completed (all
chains in lockstep): milliseconds an iteration."""


def read(ctx):
    return (ctx["window_s"] * 1e3 / ctx["iterations"]
            if ctx["iterations"] else None)
