"""The card's idle share of the traced train steps' window, %."""

from portbench.metrics import _shapes


def read(trace):
    return _shapes.idle_share(trace)
