"""Device operations (kernels, copies, memsets) a train step launches."""


def read(trace):
    return len(trace.device_ops) / trace.units if trace.units else None
