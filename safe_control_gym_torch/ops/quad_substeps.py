"""K1: batched 3D-quadrotor actuation + physics substeps.

Port of ``safe_control_gym_tpu/ops/pallas_quad.py`` (TPU kernel
``_substeps_kernel``).  :func:`quad3d_substeps` launches the CUDA kernel
``csrc/quad3d_substeps.cu`` for CUDA float32 tensors, and its float64
instance for CUDA float64 tensors (the fidelity path, which the JAX package
sends to its XLA chain, ``pallas_quad.py:228-242``), and takes the plain
PyTorch version :func:`quad3d_substeps_plain` for CPU tensors; anything else
raises.  The plain version repeats the kernel's arithmetic op for op on
per-component ``(B,)`` rows; it is the CPU path and the kernel's yardstick
of correctness, not of speed.

On the card the kernel is bound neither by its bytes nor by its flops (at
B = 4096, 0.57 MB and ~2k flops per env: 0.17 us of the card) but by each
env's chain of accurate sin/cos, sqrt and divisions; one env runs over a
group of lanes that takes them side by side (:func:`launch_plan`, the
source note in ``csrc/quad3d_substeps.cu``, PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

# cf2x.urdf constants (envs/quadrotor.py; reference assets/cf2x.urdf).
GRAVITY = 9.8
ARM_L = 0.0397
KF = 3.16e-10
KM_OVER_KF = 7.94e-12 / KF
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM = 20000.0
MAX_PWM = 65535.0

NX = 12  # [x, vx, y, vy, z, vz, phi, theta, psi, p, q, r]

# K1's launch (csrc/quad3d_substeps.cu): one env over a group of lanes of a
# warp, BLOCK threads a block.  GROUPS: the group sizes the source builds,
# for float32 and float64.  A group pays while the card has idle issue
# slots and loses once its lanes' repeated arithmetic fills them, so the
# plan takes the widest group whose largest batch in PLAN_MAX_B is at
# least B, one lane above them all.  On an H100 that was the fastest group
# at every B measured from 256 to 65536, both scalar types, and blocks of
# 32-256 threads were within 2% of each other (PERF.md).
GROUPS = (1, 2, 4, 8)
BLOCK = 64
PLAN_MAX_B = {torch.float32: {8: 2048, 4: 8192, 2: 32768},
              torch.float64: {8: 2048, 4: 8192, 2: 16384}}


def plan_group(B: int, dtype=torch.float32) -> int:
    """The widest group whose largest batch in PLAN_MAX_B of ``dtype`` is
    at least B; one lane above them all."""
    fit = [g for g, most in PLAN_MAX_B[dtype].items() if B <= most]
    return max(fit, default=1)


def launch_plan(B: int, dtype=torch.float32, group: int | None = None):
    """K1's launch for B envs of ``dtype``: (lanes per env, threads per
    block, blocks).  Each env is one group of ``group`` lanes
    (:func:`plan_group` where None) inside a warp, BLOCK // group envs a
    block; the lanes of the last block's groups past env B - 1 run env
    B - 1 and store nothing.  The kernel refuses a group size it was not
    built with."""
    g = plan_group(B, dtype) if group is None else group
    if g not in GROUPS:
        raise ValueError(f"K1 is built for groups of {GROUPS} lanes, not {g}")
    return g, BLOCK, -(-B // (BLOCK // g))


def _f32(v) -> float:
    """A Python scalar rounded to float32, as a weakly typed constant is."""
    return float(np.float32(v))


def div(a, c: float):
    """``a / c`` as a true division on every device.  PyTorch's CUDA division
    by a Python scalar multiplies by the scalar's reciprocal instead, which
    rounds differently from the kernels' (and the JAX package's) division."""
    return a / torch.full_like(a, c)


def cmd2pwm(thrust):
    """Per-motor thrust commands -> motor PWMs, clipped (reference
    quadrotor_utils.py:21-67, 4-motor form)."""
    pwm = div(torch.sqrt(div(torch.clamp_min(thrust, 0.0), KF)) - PWM2RPM_CONST, PWM2RPM_SCALE)
    return torch.clamp(pwm, MIN_PWM, MAX_PWM)


def pwm2rpm(pwm):
    return PWM2RPM_SCALE * pwm + PWM2RPM_CONST


def actuate(t):
    """Per-motor thrust command -> realized force: cmd2pwm -> clip ->
    pwm2rpm -> rpm^2 * KF (pallas_quad.py:98-106)."""
    rpm = pwm2rpm(cmd2pwm(t))
    return rpm * rpm * KF


def fc_rows(s, f, ext, minv, j, g, l_sq2, km_over_kf):
    """Rigid-body derivative on per-component rows (pallas_quad.py:49-91)."""
    vx, vy, vz = s[1], s[3], s[5]
    phi, theta, psi = s[6], s[7], s[8]
    p, q, r = s[9], s[10], s[11]
    f1, f2, f3, f4 = f

    T = f1 + f2 + f3 + f4
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    zb_x = cpsi * sth * cphi + spsi * sphi
    zb_y = spsi * sth * cphi - cpsi * sphi
    zb_z = cth * cphi
    ax = (zb_x * T + ext[0]) * minv
    ay = (zb_y * T + ext[1]) * minv
    az = (zb_z * T + ext[2]) * minv - g

    mx = l_sq2 * (f1 + f2 - f3 - f4)
    my = l_sq2 * (-f1 + f2 + f3 - f4)
    mz = km_over_kf * (f1 - f2 + f3 - f4)
    jx, jy, jz = j
    gx = q * (jz * r) - r * (jy * q)
    gy = r * (jx * p) - p * (jz * r)
    gz = p * (jy * q) - q * (jx * p)

    tth = sth / cth
    phi_dot = p + sphi * tth * q + cphi * tth * r
    theta_dot = cphi * q - sphi * r
    psi_dot = sphi / cth * q + cphi / cth * r
    return (vx, ax, vy, ay, vz, az, phi_dot, theta_dot, psi_dot,
            (mx - gx) / jx, (my - gy) / jy, (mz - gz) / jz)


def axpy(x, a, k):
    return tuple(xi + a * ki for xi, ki in zip(x, k))


def substeps_rows(s, fc, n_sub, euler, dt):
    """``n_sub`` RK4 (or Euler) substeps on component rows
    (pallas_quad.py:126-137)."""
    for _ in range(n_sub):
        if euler:
            s = axpy(s, dt, fc(s))
        else:
            k1 = fc(s)
            k2 = fc(axpy(s, dt / 2, k1))
            k3 = fc(axpy(s, dt / 2, k2))
            k4 = fc(axpy(s, dt, k3))
            s = tuple(si + dt / 6 * (a + 2 * b + 2 * c + d)
                      for si, a, b, c, d in zip(s, k1, k2, k3, k4))
    return s


def quad3d_substeps_plain(x, thrust, ext, mass, j_diag, *, dt, n_sub, euler=False,
                          g=GRAVITY, arm_l=ARM_L, km_over_kf=KM_OVER_KF,
                          actuation=False):
    """Plain PyTorch version of K1.  x (B, 12), thrust (B, 4), ext (B, 3),
    mass (B,), j_diag (B, 3) -> (B, 12)."""
    f = tuple(thrust[:, i] for i in range(4))
    if actuation:
        f = tuple(actuate(fi) for fi in f)
    e = tuple(ext[:, i] for i in range(3))
    j = tuple(j_diag[:, i] for i in range(3))
    minv = 1.0 / mass
    l_sq2 = arm_l / (2.0**0.5)

    def fc(s):
        return fc_rows(s, f, e, minv, j, g, l_sq2, km_over_kf)

    s = substeps_rows(tuple(x[:, i] for i in range(NX)), fc, n_sub, euler, dt)
    return torch.stack(s, -1)


def quad3d_substeps(x, thrust, ext, mass, j_diag, *, dt, n_sub, euler=False,
                    g=GRAVITY, arm_l=ARM_L, km_over_kf=KM_OVER_KF,
                    actuation=False, group=None):
    """K1: actuation (if ``actuation``) then ``n_sub`` substeps for a batch.

    CPU tensors take :func:`quad3d_substeps_plain`; CUDA float32 tensors
    launch ``csrc/quad3d_substeps.cu`` and CUDA float64 tensors its float64
    instance (``quad3d_substeps_f64``, scalars passed in double), with
    ``group`` lanes per env (None: :func:`launch_plan`'s pick); anything
    else raises."""
    args = (x, thrust, ext, mass, j_diag)
    if all(a.device.type == "cpu" for a in args):
        return quad3d_substeps_plain(
            x, thrust, ext, mass, j_diag, dt=dt, n_sub=n_sub, euler=euler, g=g,
            arm_l=arm_l, km_over_kf=km_over_kf, actuation=actuation)
    B = x.shape[0]
    shapes = ((B, NX), (B, 4), (B, 3), (B,), (B, 3))
    dtype = x.dtype
    for a, shp in zip(args, shapes):
        if a.device != x.device or a.device.type != "cuda" or a.dtype != dtype \
                or dtype not in (torch.float32, torch.float64) or tuple(a.shape) != shp:
            raise ValueError(
                "quad3d_substeps takes float32 or float64 tensors of one dtype on one CUDA "
                f"device with shapes {shapes}; "
                f"got {[(tuple(t.shape), t.dtype, str(t.device)) for t in args]}")
    from safe_control_gym_torch import kernels

    args = tuple(a.contiguous() for a in args)
    out = torch.empty_like(args[0])
    if B == 0:
        return out
    if dtype == torch.float32:
        entry, name, cast = kernels.lib().quad3d_substeps, "quad3d_substeps", _f32
    else:
        entry, name, cast = kernels.lib().quad3d_substeps_f64, "quad3d_substeps_f64", float
    code = entry(
        *(a.data_ptr() for a in args), out.data_ptr(), B,
        cast(dt), cast(dt / 2), cast(dt / 6), int(n_sub), int(bool(euler)),
        cast(g), cast(arm_l / (2.0**0.5)), cast(km_over_kf), int(bool(actuation)),
        *launch_plan(B, dtype, group), kernels.stream_ptr(x.device))
    kernels.check(code, name)
    quad3d_substeps.launches += 1
    return out


quad3d_substeps.launches = 0
