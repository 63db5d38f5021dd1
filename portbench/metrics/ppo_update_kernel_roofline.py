"""K4's share of its roofline: its least time for one minibatch over the
device time of one launch (its pack, gradient and reduce kernels), %."""

from portbench import yardstick
from portbench.metrics import _shapes


def read(trace):
    fam, nx, nu, h, B, T = _shapes.of(trace)
    names = _shapes.update_kernels(trace)
    sec, _ = trace.kernel(*names)
    _, launches = trace.kernel(names[0])
    if launches == 0:
        return None
    mb = B * T // int(trace.job.cell.traffic["minibatches"])
    return 100.0 * yardstick.least_seconds(*yardstick.update_call(nx, nu, h, mb)) / (sec / launches)
