"""The whole collect call's share of the card's float32 peak: what the
rollout needs (yardstick.model_ops_rollout), whatever computes it, over the
traced window's time, %."""

from portbench import yardstick
from portbench.metrics import _shapes


def read(trace):
    fam, nx, nu, h, B, T = _shapes.of(trace)
    ops = yardstick.model_ops_rollout(fam.STEP_OPS, nx, nu, h, B * T)
    return 100.0 * ops * trace.units / (trace.window_s * yardstick.PEAK_F32_OPS_S)
