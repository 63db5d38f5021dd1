"""Explicit integrators for closed-form dynamics.

Port of ``safe_control_gym_tpu/ops/integrators.py``.  The op order of
``rk4_step`` is the JAX package's (k1..k4, x + dt/6*(k1+2k2+2k3+k4)).
"""

import torch


def rk4_step(f, x, u, dt):
    """One classical Runge-Kutta-4 step of ``x' = f(x, u)``."""
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def euler_step(f, x, u, dt):
    """One explicit-Euler step."""
    return x + dt * f(x, u)


def substeps(step_fn, f, x, u, dt, n: int):
    """``n`` fixed substeps of ``step_fn`` with a constant input ``u``."""
    for _ in range(n):
        x = step_fn(f, x, u, dt)
    return x


def discretize(f, dt, method="rk4"):
    """A discrete-time transition ``fd(x, u) -> x_next``."""
    if method == "rk4":
        return lambda x, u: rk4_step(f, x, u, dt)
    if method == "euler":
        return lambda x, u: euler_step(f, x, u, dt)
    raise ValueError(f"unknown integrator {method!r}")


def discretize_linear_system(A, B, dt, exact=False):
    """Discretize ``dx/dt = Ax + Bu`` (reference mpc_utils.py:24-56):
    forward Euler, or with ``exact=True`` the matrix exponential of the
    stacked ``[[A, B], [0, 0]]`` block.  Leading batch dims are kept."""
    n, m = A.shape[-1], B.shape[-1]
    if exact:
        top = torch.cat([A, B], -1)
        M = torch.cat([top, torch.zeros(*top.shape[:-2], m, n + m, dtype=A.dtype,
                                         device=A.device)], -2)
        Md = torch.linalg.matrix_exp(M * dt)
        return Md[..., :n, :n], Md[..., :n, n:]
    return torch.eye(n, dtype=A.dtype, device=A.device) + A * dt, B * dt
