"""Explicit integrators for closed-form dynamics.

Port of ``safe_control_gym_tpu/ops/integrators.py``.  The op order of
``rk4_step`` is the JAX package's (k1..k4, x + dt/6*(k1+2k2+2k3+k4)).
"""


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
