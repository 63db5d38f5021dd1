"""Pure-NumPy fallback for the port's native runtime library.

Used where no C++ toolchain can build ``scg_native.cpp``: the same float64
semantics as the C library in its own order of operations (it agrees to
~1e-12, not bit for bit) — RK4 rollouts with the cmd2pwm/pwm2rpm actuation
map (reference safe_control_gym/envs/gym_pybullet_drones/quadrotor_utils.py
cmd2pwm/pwm2rpm) and a bounded ring-buffer telemetry logger (reference
safe_control_gym/utils/logging.py high-rate drone logger role).  It is the
port's own copy of the JAX package's fallback, and the plain version the
compiled library is held against.
"""

from __future__ import annotations

import numpy as np
import torch

# Crazyflie cf2x actuation constants (reference assets/cf2x.urdf properties;
# same values as envs/quadrotor.py).
KF = 3.16e-10
KM_OVER_KF = 7.94e-12 / KF  # torque-to-thrust ratio km/kf
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM, MAX_PWM = 20000.0, 65535.0
GRAVITY = 9.8


def as_host_f64(a):
    """A contiguous float64 host array of ``a``: a numpy array or sequence, or
    a torch tensor on any device, copied explicitly to the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to(device="cpu", dtype=torch.float64).contiguous().numpy()
    return np.ascontiguousarray(a, np.float64)


def _rk4(fc, x, dt):
    k1 = fc(x)
    k2 = fc(x + dt / 2 * k1)
    k3 = fc(x + dt / 2 * k2)
    k4 = fc(x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def cartpole_rollout(x0, forces, dt, n_sub, pole_length, pole_mass, cart_mass):
    x0 = as_host_f64(x0).reshape(4)
    forces = as_host_f64(forces).reshape(-1)
    T = forces.shape[0]
    out = np.empty((T + 1, 4), np.float64)
    out[0] = x0
    x = x0.copy()
    # Half-pole length, as in the gym/reference derivation (scg_native.cpp
    # cartpole_fc; reference cartpole.py symbolic model).
    length = pole_length / 2.0
    ml, mc = pole_mass * length, cart_mass + pole_mass
    for t in range(T):
        u = forces[t]

        def fc(s):
            _, xd, th, thd = s
            ct, st = np.cos(th), np.sin(th)
            tmp = (u + ml * thd**2 * st) / mc
            thdd = (GRAVITY * st - ct * tmp) / (
                length * (4.0 / 3.0 - pole_mass * ct**2 / mc)
            )
            xdd = tmp - ml * thdd * ct / mc
            return np.array([xd, xdd, thd, thdd])

        for _ in range(n_sub):
            x = _rk4(fc, x, dt)
        out[t + 1] = x
    return out


def thrust_to_forces(thrust):
    """Commanded thrust(s) -> 4 motor forces (scg_thrust_to_forces): nu=1 is
    total thrust split over 4 motors, nu=2 is paired, nu=4 per-motor."""
    thrust = as_host_f64(thrust).reshape(-1)
    nu = thrust.shape[0]
    n_motor = 4 // nu
    pwm_u = (np.sqrt(np.maximum(thrust, 0.0) / n_motor / KF) - PWM2RPM_CONST) / PWM2RPM_SCALE
    if nu == 1:
        pwm = np.repeat(pwm_u, 4)
    elif nu == 2:
        pwm = np.array([pwm_u[0], pwm_u[1], pwm_u[1], pwm_u[0]])
    else:
        pwm = pwm_u
    rpm = PWM2RPM_SCALE * np.clip(pwm, MIN_PWM, MAX_PWM) + PWM2RPM_CONST
    return KF * rpm**2


def _rot_xyz(phi, theta, psi):
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    cs, ss = np.cos(psi), np.sin(psi)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    ry = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]])
    rz = np.array([[cs, -ss, 0], [ss, cs, 0], [0, 0, 1]])
    return rz @ ry @ rx


def quad3d_rollout(x0, thrusts, dt, n_sub, mass, j_diag, arm_length=0.0397):
    """f64 RK4 quad-3D rollout from commanded per-motor thrusts, matching
    scg_native.cpp scg_quad3d_rollout: thrust -> pwm -> rpm -> forces, then
    the closed-form rigid body (envs/quadrotor.py quad_fc_3d numerics)."""
    x0 = as_host_f64(x0).reshape(12)
    thrusts = as_host_f64(thrusts).reshape(-1, 4)
    j = as_host_f64(j_diag).reshape(3)
    T = thrusts.shape[0]
    out = np.empty((T + 1, 12), np.float64)
    out[0] = x0
    x = x0.copy()
    L = arm_length / np.sqrt(2.0)

    for t in range(T):
        f = thrust_to_forces(thrusts[t])

        def fc(s):
            vel = s[[1, 3, 5]]
            phi, th, psi = s[6], s[7], s[8]
            pqr = s[9:12]
            R = _rot_xyz(phi, th, psi)
            fz_b = np.array([0.0, 0.0, f.sum()])
            acc = R @ fz_b / mass - np.array([0.0, 0.0, GRAVITY])
            mx = L * (f[0] + f[1] - f[2] - f[3])
            my = L * (-f[0] + f[1] + f[2] - f[3])
            mz = KM_OVER_KF * (f[0] - f[1] + f[2] - f[3])
            p, q, r = pqr
            pqr_dot = np.array([
                (mx - (j[2] - j[1]) * q * r) / j[0],
                (my - (j[0] - j[2]) * p * r) / j[1],
                (mz - (j[1] - j[0]) * p * q) / j[2],
            ])
            cp, sp = np.cos(phi), np.sin(phi)
            ct, tt = np.cos(th), np.tan(th)
            rpy_dot = np.array([
                p + sp * tt * q + cp * tt * r,
                cp * q - sp * r,
                sp / ct * q + cp / ct * r,
            ])
            d = np.empty(12)
            d[[0, 2, 4]] = vel
            d[[1, 3, 5]] = acc
            d[6:9] = rpy_dot
            d[9:12] = pqr_dot
            return d

        for _ in range(n_sub):
            x = _rk4(fc, x, dt)
        out[t + 1] = x
    return out


class PyFlightLogger:
    """Bounded ring-buffer telemetry logger (NativeFlightLogger fallback)."""

    def __init__(self, capacity: int, width: int, header: str = ""):
        self.capacity = int(capacity)
        self.width = int(width)
        self.header = header
        self._buf = np.zeros((self.capacity, self.width), np.float64)
        self._count = 0

    def append(self, records):
        rec = as_host_f64(records).reshape(-1, self.width)
        for row in rec:
            self._buf[self._count % self.capacity] = row
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self):
        n = min(self._count, self.capacity)
        if self._count <= self.capacity:
            return self._buf[:n].copy()
        start = self._count % self.capacity
        return np.concatenate([self._buf[start:], self._buf[:start]])

    def flush_csv(self, path: str):
        data = self.snapshot()
        try:
            with open(path, "w") as fh:
                if self.header:
                    fh.write(self.header + "\n")
                for row in data:
                    fh.write(",".join(f"{v:.17g}" for v in row) + "\n")
        except OSError as e:
            raise IOError(f"flush_csv failed: {path}") from e
