"""SDFormat rotation utilities.

Port of ``safe_control_gym_tpu/ops/rotations.py`` (the parts the quadrotor
env and the whole-rollout engine use).  Angle inputs may carry leading batch
dimensions; matrices stack into the trailing two axes.
"""

import numpy as np
import torch


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
