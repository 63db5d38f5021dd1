"""Sim2real analysis tools: trial alignment, averaging, batched system ID.

Port of ``safe_control_gym_tpu/competition/sim2real.py`` (reference
dev-sim2real/{sim_data_utils.py,trial_data_utils.py,save_average_run.py,
compare_sim2real.py}): load recorded flights, align and average repeated
trials (NumPy, as in the JAX package), and fit simulator physical
parameters to a real trajectory.

The reference fits parameters by wrapping its sequential firmware simulator
in ``scipy.optimize.basinhopping`` (compare_sim2real.py:23,190).  Here the
fit is a batched rollout: every candidate (mass, thrust-coefficient scale)
steps at once, one K1 launch (``ops/quad_substeps.py``, RK4, one substep,
no actuation) per recorded step, the squared position error accumulates on
the device, and one read-back returns the argmin.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from safe_control_gym_torch.envs.quadrotor import J_DIAG
from safe_control_gym_torch.ops.quad_substeps import quad3d_substeps
from safe_control_gym_torch.utils.device import resolve_device

__all__ = [
    "load_flight_csv",
    "align_trials",
    "average_runs",
    "fit_quad3d_params",
    "rollout_rmse",
]


def load_flight_csv(path: str) -> Dict[str, np.ndarray]:
    """Load a flight CSV into {"t", "state", "control"} arrays.

    Accepts the drone_logger CSV contract (header ``t,<16 state>,<12 ctrl>``)
    and the reference's average-run format (``time,x,y,z,qx,qy,qz,qw``,
    sim_data_utils.py:3-11), told apart by their column count.
    """
    raw = np.genfromtxt(path, delimiter=",", names=True)
    cols = raw.dtype.names
    data = np.stack([raw[c] for c in cols], axis=-1)
    t = data[:, 0]
    if data.shape[1] == 8:  # reference average-run: time, xyz, quaternion
        return {"t": t, "state": data[:, 1:], "control": None}
    return {"t": t, "state": data[:, 1:17], "control": data[:, 17:]}


def _resample(t_src, y_src, t_dst):
    out = np.empty((len(t_dst), y_src.shape[1]))
    for k in range(y_src.shape[1]):
        out[:, k] = np.interp(t_dst, t_src, y_src[:, k])
    return out


def align_trials(trials: Sequence[Dict[str, np.ndarray]],
                 hz: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-base each trial's clock and resample onto a common grid
    (trial_data_utils.align_data): returns (t, stack), ``stack`` (n_trials,
    T, dims).  The grid spans the shortest trial at ``hz`` (default: the
    median sample rate of the first trial)."""
    zeroed = [(tr["t"] - tr["t"][0], tr["state"]) for tr in trials]
    t_end = min(t[-1] for t, _ in zeroed)
    if hz is None:
        dt = np.median(np.diff(zeroed[0][0]))
        hz = 1.0 / max(dt, 1e-6)
    grid = np.arange(0.0, t_end, 1.0 / hz)
    stack = np.stack([_resample(t, y, grid) for t, y in zeroed])
    return grid, stack


def average_runs(trials: Sequence[Dict[str, np.ndarray]],
                 hz: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Average repeated trials (reference save_average_run.py): the mean
    trajectory and the per-sample std envelope."""
    grid, stack = align_trials(trials, hz=hz)
    return {"t": grid, "state": stack.mean(0), "std": stack.std(0)}


def rollout_rmse(masses, kf_scales, pos_ref, acts, x0, dt: float):
    """Position RMSE of every candidate's open-loop rollout.

    ``masses`` and ``kf_scales`` (N,), ``pos_ref`` (T, 3), ``acts`` (T, 4)
    per-motor forces, ``x0`` (12,), all float32 on one device.  Each step is
    one ``quad3d_substeps`` call over the N candidates (thrust ``acts[t] *
    kf_scale``, no external force, RK4, one substep of ``dt``, no
    actuation); the squared error sums on the device.  Returns (N,)."""
    N, T = masses.shape[0], acts.shape[0]
    x = x0.expand(N, x0.shape[0]).contiguous()
    ext = torch.zeros((N, 3), dtype=x.dtype, device=x.device)
    j = torch.tensor(J_DIAG, dtype=x.dtype, device=x.device).expand(N, 3).contiguous()
    kf = kf_scales[:, None]
    err = torch.zeros(N, dtype=x.dtype, device=x.device)
    for t in range(T):
        x = quad3d_substeps(x, acts[t] * kf, ext, masses, j, dt=dt, n_sub=1, euler=False,
                            actuation=False)
        d = x[:, 0:5:2] - pos_ref[t]  # x, y, z
        err = err + (d * d).sum(-1)
    return torch.sqrt(err / T)


def fit_quad3d_params(
    pos_traj: np.ndarray,
    actions: np.ndarray,
    dt: float,
    init_state: np.ndarray,
    mass_range: Tuple[float, float] = (0.025, 0.045),
    kf_scale_range: Tuple[float, float] = (0.7, 1.3),
    num_candidates: int = 4096,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Fit (mass, thrust-coefficient scale) to a recorded flight.

    ``pos_traj``: (T, 3) measured positions; ``actions``: (T, 4) per-motor
    forces commanded at rate 1/dt; ``init_state``: (12,) initial full state.
    Draws ``num_candidates`` pairs uniformly from the ranges (a generator
    seeded with ``seed``), rolls them all out (:func:`rollout_rmse`) and
    returns the best pair and its position RMSE.  Runs on ``device`` (CUDA
    where None; raises without a card)."""
    dev = resolve_device(device)
    T = min(len(pos_traj), len(actions))
    f32 = dict(dtype=torch.float32, device=dev)
    pos_ref = torch.as_tensor(np.asarray(pos_traj[:T], np.float32), **f32)
    acts = torch.as_tensor(np.asarray(actions[:T], np.float32), **f32)
    x0 = torch.as_tensor(np.asarray(init_state, np.float32), **f32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    masses = torch.empty(num_candidates, **f32).uniform_(*mass_range, generator=gen)
    kf_scales = torch.empty(num_candidates, **f32).uniform_(*kf_scale_range, generator=gen)
    rmse = rollout_rmse(masses, kf_scales, pos_ref, acts, x0, dt)
    best = torch.argmin(rmse).reshape(1)
    mass, kf, err = torch.stack([masses, kf_scales, rmse], 1).index_select(0, best)[0].tolist()
    return {"mass": mass, "kf_scale": kf, "rmse": err, "candidates": num_candidates}
