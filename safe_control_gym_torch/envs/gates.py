"""Analytic gate/obstacle geometry for the competition maze.

Port of ``safe_control_gym_tpu/envs/gates.py`` (the constants and the
closed-form queries that replace the reference's PyBullet contact and ray
tests, quadrotor.py:1046-1112).  Dimensions come from the reference URDFs:

  * gate (portal.urdf / low_portal.urdf): square frame of 0.5x0.05x0.05
    bars around the aperture (inner half-width 0.2, outer 0.25), slab
    thickness 0.05, aperture center at height 1.0 (type 0) or 0.525
    (type 1), support leg below the frame;
  * obstacle (obstacle.urdf): vertical cylinder, radius 0.05, height 1.05;
  * the drone is a sphere of radius ``DRONE_RADIUS``.

Batched: ``pos`` is (..., 3); per-gate arrays carry a gate axis after the
batch axes, (..., NG, k), and results are (..., NG).
"""

from __future__ import annotations

import torch

DRONE_RADIUS = 0.06
GATE_HEIGHTS = (1.0, 0.525)  # by type: 0 = tall portal, 1 = low portal
RAY_HALF_LENGTH = 0.1875  # quadrotor.py:1068
RAY_SPACING = 0.05  # quadrotor.py:1069-1070
N_RAY_OFFSETS = 3
VISIBILITY_RANGE = 0.45  # quadrotor.py:1094
GATE_INNER_HALF = 0.2  # aperture half-width (bars at 0.225 +/- 0.025)
GATE_OUTER_HALF = 0.25
GATE_SLAB_HALF = 0.025  # frame thickness / 2
OBSTACLE_RADIUS = 0.05
OBSTACLE_HEIGHT = 1.05
# Ground contact when the cf2x collision cylinder's bottom face reaches the
# plane (cylinder length 0.025 centered at the base link origin).
GROUND_COLLISION_Z = 0.0125


def _point_vertical_segment_dist(p, seg_xy, z_lo, z_hi):
    """Distance from points p (..., 3) to vertical segments (..., 2) over
    [z_lo, z_hi]."""
    dxy = p[..., :2] - seg_xy
    dz = torch.minimum(torch.maximum(p[..., 2], z_lo), z_hi) - p[..., 2]
    return torch.sqrt((dxy * dxy).sum(-1) + dz * dz)


def gate_pass_hit(pos, gate_xy, gate_yaw, gate_height, drone_radius=DRONE_RADIUS):
    """Does the drone sphere intersect each gate's 7-ray fan? -> (..., NG)."""
    offsets = torch.arange(-N_RAY_OFFSETS, N_RAY_OFFSETS + 1, dtype=pos.dtype,
                           device=pos.device) * RAY_SPACING
    d = torch.stack([torch.cos(gate_yaw), torch.sin(gate_yaw)], -1)  # (..., NG, 2)
    seg_xy = gate_xy[..., :, None, :] + offsets[:, None] * d[..., :, None, :]
    z_lo = (gate_height - RAY_HALF_LENGTH)[..., None]
    z_hi = (gate_height + RAY_HALF_LENGTH)[..., None]
    dist = _point_vertical_segment_dist(pos[..., None, None, :], seg_xy, z_lo, z_hi)
    return (dist < drone_radius).any(-1)


def gate_in_range(pos, gate_xy, gate_height, rng=VISIBILITY_RANGE):
    """Closest-point visibility test (quadrotor.py:1096-1106), approximated
    by the distance to the frame center minus its circumscribed radius."""
    center = torch.cat([gate_xy, gate_height[..., None]], -1)
    d = torch.linalg.norm(pos[..., None, :] - center, dim=-1)
    return d < (rng + GATE_OUTER_HALF + GATE_SLAB_HALF)


def gate_collision(pos, gate_xy, gate_yaw, gate_height, drone_radius=DRONE_RADIUS):
    """Drone sphere vs. gate frame + support leg -> (..., NG) bool."""
    rel = pos[..., None, :2] - gate_xy
    c, s = torch.cos(gate_yaw), torch.sin(gate_yaw)
    # In-plane lateral axis u = (cos, sin); normal n = (-sin, cos).
    u = rel[..., 0] * c + rel[..., 1] * s
    n = -rel[..., 0] * s + rel[..., 1] * c
    w = pos[..., None, 2] - gate_height  # height above aperture center
    in_slab = n.abs() < (GATE_SLAB_HALF + drone_radius)
    in_outer = (u.abs() < GATE_OUTER_HALF + drone_radius) & (
        w.abs() < GATE_OUTER_HALF + drone_radius)
    in_inner = (u.abs() < GATE_INNER_HALF - drone_radius) & (
        w.abs() < GATE_INNER_HALF - drone_radius)
    frame_hit = in_slab & in_outer & ~in_inner
    leg = (torch.sqrt(rel[..., 0] ** 2 + rel[..., 1] ** 2)
           < OBSTACLE_RADIUS + drone_radius) & (
        pos[..., None, 2] < gate_height - GATE_OUTER_HALF)
    return frame_hit | leg


def gate_frame_margin(pos, gate_xy, gate_yaw, gate_height, drone_radius=DRONE_RADIUS):
    """Signed clearance (m) of the drone sphere to each gate frame: the max
    of the three box violations, positive means clear.  -> (..., NG)."""
    rel = pos[..., None, :2] - gate_xy
    c, s = torch.cos(gate_yaw), torch.sin(gate_yaw)
    u = rel[..., 0] * c + rel[..., 1] * s
    n = -rel[..., 0] * s + rel[..., 1] * c
    w = pos[..., None, 2] - gate_height
    uw = torch.maximum(u.abs(), w.abs())
    f_slab = n.abs() - (GATE_SLAB_HALF + drone_radius)
    f_outer = uw - (GATE_OUTER_HALF + drone_radius)
    f_inner = (GATE_INNER_HALF - drone_radius) - uw
    frame_m = torch.maximum(torch.maximum(f_slab, f_outer), f_inner)
    leg_m = torch.maximum(
        torch.sqrt(rel[..., 0] ** 2 + rel[..., 1] ** 2) - (OBSTACLE_RADIUS + drone_radius),
        pos[..., None, 2] - (gate_height - GATE_OUTER_HALF),
    )
    return torch.minimum(frame_m, leg_m)


def obstacle_margin(pos, obs_xy, drone_radius=DRONE_RADIUS):
    """Signed clearance (m) to each obstacle cylinder -> (..., NO)."""
    rel = pos[..., None, :2] - obs_xy
    radial = torch.sqrt((rel * rel).sum(-1)) - (OBSTACLE_RADIUS + drone_radius)
    above = pos[..., None, 2] - (OBSTACLE_HEIGHT + drone_radius)
    return torch.maximum(radial, above)


def obstacle_collision(pos, obs_xy, drone_radius=DRONE_RADIUS):
    """Drone sphere vs. obstacle cylinders -> (..., NO) bool."""
    rel = pos[..., None, :2] - obs_xy
    radial = torch.sqrt((rel * rel).sum(-1)) < (OBSTACLE_RADIUS + drone_radius)
    in_z = pos[..., None, 2] < OBSTACLE_HEIGHT + drone_radius
    return radial & in_z


def ground_collision(pos):
    return pos[..., 2] < GROUND_COLLISION_Z
