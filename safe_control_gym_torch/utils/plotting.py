"""Plotting utilities for experiment logs and trajectory post-analysis.

Port of ``safe_control_gym_tpu/utils/plotting.py`` (reference
safe_control_gym/utils/plotting.py:66-398): crawl per-metric text logs
across seed runs, align, interpolate and smooth them, plot mean +/- std
learning curves, and the LQR-style post-analysis of one trajectory.  All of
it is host-side NumPy.  Matplotlib is imported only where a plot is drawn.
"""

from __future__ import annotations

import os

import numpy as np


def load_from_log_file(path: str):
    """Read a '<step> <value>' metric log (reference plotting.py:66-90)."""
    steps, values = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                steps.append(float(parts[0]))
                values.append(float(parts[1]))
    return np.asarray(steps), np.asarray(values)


def load_from_logs(log_dir: str) -> dict:
    """Crawl a run's logs/ dir into {metric: (steps, values)}."""
    out = {}
    logs = os.path.join(log_dir, "logs")
    if not os.path.isdir(logs):
        return out
    for fname in os.listdir(logs):
        if fname.endswith(".log"):
            out[fname[:-4]] = load_from_log_file(os.path.join(logs, fname))
    return out


def window_func(xs, ys, window: int = 10, fn=np.mean):
    """Sliding-window smoothing (reference plotting.py:96-120)."""
    if len(ys) < window:
        return xs, ys
    smoothed = np.array([fn(ys[max(0, i - window + 1) : i + 1]) for i in range(len(ys))])
    return xs, smoothed


def interpolate_runs(runs, num_points: int = 200):
    """Align runs with different step grids onto a common grid
    (reference plotting.py:130-170)."""
    lo = max(r[0][0] for r in runs)
    hi = min(r[0][-1] for r in runs)
    grid = np.linspace(lo, hi, num_points)
    ys = np.stack([np.interp(grid, s, v) for s, v in runs])
    return grid, ys


def plot_from_logs(log_dirs, metric: str, out_path: str | None = None, window: int = 10):
    """Mean +/- std learning curve across seeds (reference plotting.py:198+)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # FileLogger flattens '/' in metric names to '_' on disk; accept either.
    key = metric.replace("/", "_")
    runs = []
    for d in log_dirs:
        data = load_from_logs(d)
        if key in data:
            runs.append(window_func(*data[key], window=window))
    if not runs:
        raise ValueError(f"metric {metric!r} not found in any of {log_dirs}")
    grid, ys = interpolate_runs(runs)
    mean, std = ys.mean(0), ys.std(0)
    fig, ax = plt.subplots()
    ax.plot(grid, mean)
    ax.fill_between(grid, mean - std, mean + std, alpha=0.3)
    ax.set_xlabel("step")
    ax.set_ylabel(metric)
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return grid, mean, std


def post_analysis(goal_stack, state_stack, input_stack, env=None,
                  state_labels=None, action_labels=None,
                  plot: bool = False, save_plot: bool = False,
                  plot_dir: str = ".", ite_counter: int = 0):
    """Trajectory post-analysis (reference lqr_utils.py post_analysis):
    per-state RMSE (angle errors wrapped to [-pi, pi]) and optional
    state/input trajectory plots vs the goal.

    Returns {"state_rmse": (nx,), "state_rmse_scalar": float}.
    """
    goal_stack = np.asarray(goal_stack)
    state_stack = np.asarray(state_stack)
    input_stack = np.asarray(input_stack)
    n = min(goal_stack.shape[0], state_stack.shape[0])
    err = state_stack[:n] - goal_stack[:n]
    if state_labels is None and env is not None and hasattr(env.config, "quad_type"):
        from safe_control_gym_torch.envs import quadrotor

        state_labels = quadrotor.STATE_LABELS[quadrotor.QuadType(int(env.config.quad_type))]
    # Wrap angular errors (reference wrap2pi_vec over STATE_UNITS == 'rad').
    if state_labels is not None:
        for k, name in enumerate(state_labels):
            if any(s in name for s in ("theta", "phi", "psi")) and "dot" not in name:
                err[:, k] = (err[:, k] + np.pi) % (2 * np.pi) - np.pi
    state_rmse = np.sqrt(np.mean(err**2, axis=0))
    state_rmse_scalar = float(np.sqrt(np.mean(np.sum(err**2, axis=1))))

    if plot or save_plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        dt = 1.0 / getattr(env, "ctrl_freq", 50) if env is not None else 1.0
        times = np.arange(n) * dt
        nx = state_stack.shape[1]
        fig, axs = plt.subplots(nx, figsize=(8, 1.6 * nx), sharex=True)
        axs = np.atleast_1d(axs)
        for k in range(nx):
            axs[k].plot(times, state_stack[:n, k], label="actual")
            axs[k].plot(times, goal_stack[:n, k], "r", label="desired")
            if state_labels is not None and k < len(state_labels):
                axs[k].set_ylabel(state_labels[k])
        axs[0].set_title("State Trajectories")
        axs[0].legend(ncol=2)
        axs[-1].set_xlabel("time (sec)")
        if save_plot:
            fig.savefig(f"{plot_dir}/state_ite{ite_counter}.png", dpi=100)
        nu = input_stack.shape[1]
        fig2, axs2 = plt.subplots(nu, figsize=(8, 1.6 * nu), sharex=True)
        axs2 = np.atleast_1d(axs2)
        for k in range(nu):
            axs2[k].plot(times[: min(n, input_stack.shape[0])],
                         input_stack[: min(n, input_stack.shape[0]), k])
            if action_labels is not None and k < len(action_labels):
                axs2[k].set_ylabel(action_labels[k])
            else:
                axs2[k].set_ylabel(f"input {k}")
        axs2[0].set_title("Input Trajectories")
        axs2[-1].set_xlabel("time (sec)")
        if save_plot:
            fig2.savefig(f"{plot_dir}/input_ite{ite_counter}.png", dpi=100)
        plt.close(fig)
        plt.close(fig2)
    return {"state_rmse": state_rmse, "state_rmse_scalar": state_rmse_scalar}
