"""The policy kernel's share of its roofline in collect calls, %."""

from portbench.metrics import _shapes


def read(trace):
    return _shapes.policy_roofline(trace)
