"""Kernel launches a train step: the host's launch records in the traced
window over its steps. A count that repeats exactly for the same code."""


def read(ctx):
    return ctx["trace"].launches / ctx["work"]["steps"]
