"""Linear MPC.

Port of ``safe_control_gym_tpu/controllers/linear_mpc.py`` (reference
safe_control_gym/controllers/mpc/linear_mpc.py): the dynamics are the exact
(matrix-exponential) discretization of the model linearized at the hover
equilibrium (X_EQ, U_EQ) (linear_mpc.py:81-108), in delta variables.  The
linearization and its discretization run in float64 on the env's device
and are cast to float32.  With linear dynamics and a quadratic cost the
AL-iLQR inner solves are exact LQR steps, so few iterations suffice.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.controllers.mpc import MPC
from safe_control_gym_torch.ops.integrators import discretize_linear_system


def hover_linearization(env):
    """(Ad, Bd, x_eq, u_eq) of ``env.symbolic`` linearized at X_EQ = 0, U_EQ
    = U_GOAL (quadrotor.py:327-329) and discretized exactly, in float64 on
    the env's device, cast to float32."""
    model, dev = env.symbolic, env.device
    f64 = dict(dtype=torch.float64, device=dev)
    A, B = model.df_func(torch.zeros(model.nx, **f64),
                         torch.as_tensor(np.asarray(env.u_goal), **f64))
    Ad, Bd = discretize_linear_system(A, B, model.dt, exact=True)
    return (Ad.float(), Bd.float(), torch.zeros(model.nx, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(env.u_goal), dtype=torch.float32, device=dev))


def linear_fd(x, u, Ad, Bd, x_eq, u_eq):
    """x_eq + Ad (x - x_eq) + Bd (u - u_eq) on states with any leading dims."""
    return x_eq + (x - x_eq) @ Ad.mT + (u - u_eq) @ Bd.mT


class _LinModel:
    """The frozen linearization in the place of the RK4 model."""

    def __init__(self, model, Ad, Bd, x_eq, u_eq):
        self.nx, self.nu, self.dt = model.nx, model.nu, model.dt
        self.lin = (Ad, Bd, x_eq, u_eq)

    def fd_func(self, x, u, dt=None):
        return linear_fd(x, u, *self.lin)


class LinearMPC(MPC):
    def __init__(self, env, **kwargs):
        self._Ad, self._Bd, self._x_eq, self._u_eq_lin = hover_linearization(env)
        super().__init__(env, **kwargs)

    def _make_solver(self):
        # The parent's solver around the frozen linearization
        # (linear_mpc.py:81-108).
        real_model = self.model
        self.model = _LinModel(real_model, self._Ad, self._Bd, self._x_eq, self._u_eq_lin)
        try:
            return MPC._make_solver(self)
        finally:
            self.model = real_model
