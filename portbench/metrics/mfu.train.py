"""The whole train step's share of the card's float32 peak: what a PPO
train step needs (yardstick.model_ops_train_step), whatever computes it,
over the traced window's time, %."""

from portbench import yardstick
from portbench.metrics import _shapes


def read(trace):
    fam, nx, nu, h, B, T = _shapes.of(trace)
    tr, ppo = trace.job.cell.traffic, trace.job.cell.config["ppo"]
    ops = yardstick.model_ops_train_step(fam.STEP_OPS, nx, nu, h, B, T, int(ppo["opt_epochs"]),
                                         int(tr["minibatches"]))
    return 100.0 * ops * trace.units / (trace.window_s * yardstick.PEAK_F32_OPS_S)
