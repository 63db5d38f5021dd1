"""A-priori dynamics model shipped from an env to its controllers.

Port of ``safe_control_gym_tpu/models/dynamics_model.py`` (the counterpart
of the reference's CasADi ``SymbolicModel``, symbolic_systems.py): a
closed-form ``fc(x, u)`` on one state and input, and everything else
derived with ``torch.func``:

  * ``fd_func``        - one RK4 step;
  * ``df_func``        - continuous-time Jacobians (A, B) by ``jacfwd``;
  * ``fd_linear_func`` - Jacobians of the RK4 step;
  * ``loss``           - the quadratic cost and its derivatives;
  * ``batch_linearize`` / ``batch_fd`` - the same along a trajectory or
    batch, by ``vmap``.

``fc`` must be functional (no in-place writes), as the envs' ``quad_fc_*``
and ``cartpole_fc`` are, so that ``jacfwd`` and ``vmap`` go through it.
The Jacobians evaluate ``fc`` on a batch of one (:func:`_on_batch_of_one`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import jacfwd, vmap

from safe_control_gym_torch.ops.integrators import rk4_step


def _identity(x, u):
    return x


def _on_batch_of_one(f):
    """``f`` on a batch of one, for ``jacfwd``: under ``torch.func.jvp`` a
    0-dim float32 tensor times a Python float gets a float64 tangent (torch
    2.13), and ops that take two tangents (``torch.linalg.cross`` in the 3D
    quadrotor) then refuse the mix.  On (1, n) tensors every slice keeps a
    batch dim and the tangents keep the primal's dtype."""
    return lambda x, u: f(x[None], u[None])[0]


@dataclasses.dataclass(frozen=True)
class DynamicsModel:
    fc_func: Callable  # x' = fc(x, u), continuous time, on one (nx,) state
    nx: int
    nu: int
    dt: float  # the controller's sampling time
    g_func: Callable = None  # y = g(x, u); the identity on x by default

    def __post_init__(self):
        if self.g_func is None:
            object.__setattr__(self, "g_func", _identity)

    @property
    def ny(self) -> int:
        return self.nx

    def fd_func(self, x, u, dt=None):
        """One RK4 step of the continuous dynamics."""
        return rk4_step(self.fc_func, x, u, self.dt if dt is None else dt)

    def df_func(self, x, u):
        """Continuous-time Jacobians (dfdx, dfdu) at (x, u)."""
        return jacfwd(_on_batch_of_one(self.fc_func), argnums=(0, 1))(x, u)

    def dg_func(self, x, u):
        """Observation Jacobians (dgdx, dgdu) at (x, u)."""
        return jacfwd(_on_batch_of_one(self.g_func), argnums=(0, 1))(x, u)

    def fc_linear(self, x, u, x_eq, u_eq):
        """Linearized continuous dynamics: fc(x_eq, u_eq) + A dx + B du."""
        A, B = self.df_func(x_eq, u_eq)
        return self.fc_func(x_eq, u_eq) + A @ (x - x_eq) + B @ (u - u_eq)

    def fd_linear_func(self, x_eq, u_eq, dt=None):
        """Discrete-time Jacobians of the RK4 step at (x_eq, u_eq)."""
        dt = self.dt if dt is None else dt
        fc = _on_batch_of_one(self.fc_func)
        return jacfwd(lambda x, u: rk4_step(fc, x, u, dt), argnums=(0, 1))(x_eq, u_eq)

    @staticmethod
    def loss(x, u, Xr, Ur, Q, R):
        """Quadratic cost and its derivatives (reference
        symbolic_systems.py:96-123): l, l_x, l_xx, l_u, l_uu, l_xu."""
        dx, du = x - Xr, u - Ur
        return {
            "l": 0.5 * dx @ Q @ dx + 0.5 * du @ R @ du,
            "l_x": Q @ dx,
            "l_xx": Q,
            "l_u": R @ du,
            "l_uu": R,
            "l_xu": torch.zeros((Q.shape[0], R.shape[0]), dtype=Q.dtype, device=Q.device),
        }

    def batch_linearize(self, xs, us):
        """Jacobians along a trajectory or batch: xs (T, nx), us (T, nu)."""
        return vmap(self.df_func)(xs, us)

    def batch_fd(self, xs, us, dt=None):
        return vmap(lambda x, u: self.fd_func(x, u, dt))(xs, us)
