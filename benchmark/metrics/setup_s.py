"""Seconds from the run's start to its window: the libraries' load (and
build, in a checkout's first run), the data, the engine and burn-in."""


def read(ctx):
    return ctx["setup_s"]
