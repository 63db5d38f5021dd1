"""Shapes and kernel names of a traced job, for the metric readers."""

from __future__ import annotations

from portbench import families, yardstick


def of(trace):
    """(family module, nx, nu, hidden, B, T) of the job behind a trace."""
    cfg, job = trace.job.cell.config, trace.job
    fam = families.load(cfg["family"])
    nx, nu = fam.DIMS
    return fam, nx, nu, int(cfg["ppo"]["hidden_dim"]), job.B, job.T


def policy_kernel(trace):
    return trace.job.cell.config["program"]["policy_kernel"]


def update_kernels(trace):
    return trace.job.cell.config["program"]["update_kernels"]


def policy_roofline(trace):
    """The policy kernel's least time over its mean device time a launch, %."""
    fam, nx, nu, h, B, T = of(trace)
    sec, n = trace.kernel(policy_kernel(trace))
    if n == 0:
        return None
    return 100.0 * yardstick.least_seconds(
        *yardstick.policy_call(fam.STEP_OPS, fam.STATE_ROWS, nx, nu, h, B, T)) / (sec / n)


def idle_share(trace):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
