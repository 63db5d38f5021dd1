"""SDFormat rotation utilities.

Port of ``safe_control_gym_tpu/ops/rotations.py``.  Angle inputs may carry
leading batch dimensions; matrices stack into the trailing two axes.
"""

import numpy as np
import torch


def _mat(rows):
    """(..., 3, 3) from three rows of three same-shaped tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_z(psi):
    """Rotation about Z (SDFormat convention).  Returns (..., 3, 3)."""
    c, s = torch.cos(psi), torch.sin(psi)
    z, o = torch.zeros_like(psi), torch.ones_like(psi)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def rot_y(theta):
    """Rotation about Y (SDFormat convention).  Returns (..., 3, 3)."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[c, z, s], [z, o, z], [-s, z, c]])


def rot_x(phi):
    """Rotation about X (SDFormat convention).  Returns (..., 3, 3)."""
    c, s = torch.cos(phi), torch.sin(phi)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    return _mat([[o, z, z], [z, c, -s], [z, s, c]])


def rot_xyz(phi, theta, psi):
    """Extrinsic X-Y-Z Euler rotation (body->world), R = Rz(psi) Ry(theta)
    Rx(phi), composed in closed form.  Returns (..., 3, 3)."""
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    return torch.stack(
        [
            torch.stack([cpsi * cth, cpsi * sth * sphi - spsi * cphi,
                         cpsi * sth * cphi + spsi * sphi], -1),
            torch.stack([spsi * cth, spsi * sth * sphi + cpsi * cphi,
                         spsi * sth * cphi - cpsi * sphi], -1),
            torch.stack([-sth, cth * sphi, cth * cphi], -1),
        ],
        -2,
    )


def body_z_world(phi, theta, psi):
    """Third column of rot_xyz: the body z-axis in the world frame (the
    thrust direction).  Returns (..., 3)."""
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    return torch.stack(
        [cpsi * sth * cphi + spsi * sphi, spsi * sth * cphi - cpsi * sphi, cth * cphi],
        -1,
    )


def euler_jacobian(phi, theta):
    """The matrix taking body rates (p, q, r) to Euler-angle rates (the 3D
    quadrotor's kinematics).  Returns (..., 3, 3)."""
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    tth, cth = torch.tan(theta), torch.cos(theta)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    return _mat([[o, sphi * tth, cphi * tth], [z, cphi, -sphi], [z, sphi / cth, cphi / cth]])


def unit_vector(v, axis=-1, eps=0.0):
    """``v`` normalized along ``axis``."""
    n = torch.sqrt(torch.sum(v * v, dim=axis, keepdim=True))
    return v / (n + eps)


def projection_matrix(point, normal):
    """4x4 orthogonal projection onto the plane through ``point`` with
    ``normal``.  Host-side (env build time), float64 NumPy."""
    point = np.asarray(point, dtype=np.float64)[:3]
    normal = np.asarray(normal, dtype=np.float64)[:3]
    normal = normal / np.linalg.norm(normal)
    M = np.eye(4)
    M[:3, :3] -= np.outer(normal, normal)
    M[:3, 3] = np.dot(point, normal) * normal
    return M


def transform_trajectory(pos, vel, point, normal):
    """Project a planar (T, 3) trajectory onto a plane in 3D: positions take
    the affine map, velocities are multiplied by the same augmented matrix
    (as the reference does).  Host-side, float64 NumPy."""
    M = projection_matrix(point, normal)
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    aug_pos = np.concatenate([pos, np.ones((pos.shape[0], 1))], -1)
    aug_vel = np.concatenate([vel, np.ones((vel.shape[0], 1))], -1)
    return (aug_pos @ M.T)[:, :3], (aug_vel @ M.T)[:, :3]
