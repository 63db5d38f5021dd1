"""Device ms a train step spends outside the policy kernel and K4: GAE,
the minibatch layout, the shuffles, Adam, the loss means."""

from portbench.metrics import _shapes


def read(trace):
    if not trace.units:
        return None
    total = sum(e - s for _, s, e in trace.device_ops) * 1e-9
    pol, _ = trace.kernel(_shapes.policy_kernel(trace))
    upd, _ = trace.kernel(*_shapes.update_kernels(trace))
    return 1e3 * (total - pol - upd) / trace.units
