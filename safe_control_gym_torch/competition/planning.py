"""Time-optimal point-mass-model (PMM) planning through gates.

The port's copy of ``safe_control_gym_tpu/competition/planning.py``
(NumPy, results equal to the JAX package's bit for bit), the counterpart
of reference competition/planning.py: per-axis
bang-bang minimum-time segments (planning.py:76-210), a layered search over
sampled gate-crossing velocity cones, obstacle pruning, and iterative cone
refocusing (plan_time_optimal_trajectory_through_gates, planning.py:329-375).

Design differences from the reference:
  * the gate-layer graph is a *layered DAG*, so the networkx shortest-path
    call (planning.py:262-320) reduces to a forward dynamic program over
    layers — one vectorized table update per gate instead of a general graph
    search;
  * segment times for all (prev-state, candidate) pairs in a layer are
    evaluated as vectorized NumPy array ops.

Planning runs once per episode on the host (its output — a dense reference
path — feeds the on-device MPCC), so host NumPy is the right tool here.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from safe_control_gym_torch.competition.trajectory import PiecewiseTrajectory, Trajectory


class State(NamedTuple):
    position: np.ndarray
    velocity: np.ndarray


class Limits(NamedTuple):
    lower: np.ndarray
    upper: np.ndarray


@dataclasses.dataclass
class CylinderObstacle:
    """Vertical cylinder (reference planning.py Cylinder)."""

    position: np.ndarray
    radius: float
    height: float

    def min_distance(self, points: np.ndarray) -> float:
        """Min distance from sampled trajectory points to the cylinder."""
        d_xy = np.linalg.norm(points[:, :2] - np.asarray(self.position)[:2], axis=-1)
        below = points[:, 2] <= self.height
        d = np.where(below, d_xy - self.radius, np.sqrt(np.maximum(d_xy - self.radius, 0) ** 2 + (points[:, 2] - self.height) ** 2))
        return float(d.min())


# -- scalar bang-bang minimum time (planning.py:76-133), re-derived ------------

def _real_roots(a, b, c):
    with np.errstate(invalid="ignore", divide="ignore"):
        disc = b * b - 4.0 * a * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        r1 = (-b + sq) / (2 * a)
        r2 = (-b - sq) / (2 * a)
    valid = disc >= 0
    return r1, r2, valid


def scalar_pmm_min_time(p0, v0, p1, v1, u0, u2):
    """Minimum time for 1D double integrator, accel u0 then u2 (vectorized)."""
    p0, v0, p1, v1 = (np.asarray(x, float) for x in (p0, v0, p1, v1))
    u0 = np.broadcast_to(np.asarray(u0, float), p0.shape)
    u2 = np.broadcast_to(np.asarray(u2, float), p0.shape)
    gamma = u0 / np.where(u2 == 0, np.inf, u2)
    beta = (v1 - v0) / np.where(u2 == 0, np.inf, u2)
    a = (u0 / 2) * (1 - gamma)
    b = v0 * (1 - gamma)
    c = beta * (v1 + v0) / 2.0 + (p0 - p1)
    t1a, t1b, valid = _real_roots(a, b, c)
    T = np.full(p0.shape, np.inf)
    for t1 in (t1a, t1b):
        Tc = (1 - gamma) * t1 + beta
        ok = valid & (t1 >= 0) & (Tc >= t1) & np.isfinite(Tc)
        T = np.where(ok & (Tc < T), Tc, T)
    # Degenerate cases (zero accelerations) fall back to the piecewise
    # closed forms of the reference (planning.py:76-117).
    both_zero = (u0 == 0) & (u2 == 0)
    T = np.where(both_zero & (p0 == p1) & (v0 == v1), 0.0, T)
    return T


def pmm_min_time(p0, v0, p1, v1, u_lower, u_upper):
    """Synchronized minimum time over 3 axes: max over axes of the better of
    (accelerate-then-brake, brake-then-accelerate)."""
    Ta = scalar_pmm_min_time(p0, v0, p1, v1, u_upper, u_lower)
    Tb = scalar_pmm_min_time(p0, v0, p1, v1, u_lower, u_upper)
    return np.max(np.minimum(Ta, Tb), axis=-1)


def _scalar_policy_fixed_time(p0, v0, p1, v1, u_lo, u_hi, T):
    """Per-axis switch time and acceleration scale alpha for fixed total T
    (reference scalar_pmm_bang_bang_control_policy, planning.py:144-169)."""
    if T <= 0:
        return 0.0, 0.0
    gamma = u_lo / u_hi
    beta = (v1 - v0) / u_hi
    a = ((u_lo / 2) * T**2) / (1 - gamma)
    b = v0 * T - (u_lo * beta * T) / (1 - gamma) + (p0 - p1)
    c = ((u_hi * beta**2) / 2) / (1 - gamma)
    best_alpha = 0.0
    if abs(a) < 1e-14:
        roots = [-c / b] if abs(b) > 1e-14 else []
    else:
        disc = b * b - 4 * a * c
        roots = [(-b + np.sqrt(disc)) / (2 * a), (-b - np.sqrt(disc)) / (2 * a)] if disc >= 0 else []
    for alpha in roots:
        if alpha == 0.0:
            continue
        t1 = (T - beta / alpha) / (1 - gamma)
        if t1 < -1e-12 or T - t1 < -1e-12:
            continue
        if abs(alpha) > abs(best_alpha):
            best_alpha = alpha
    if best_alpha == 0.0:
        return T, 0.0
    t1 = float(np.clip((T - beta / best_alpha) / (1 - gamma), 0.0, T))
    return t1, best_alpha


def pmm_segment(p0, v0, p1, v1, u_lower, u_upper) -> Optional[PiecewiseTrajectory]:
    """Build the synchronized 3-axis bang-bang trajectory
    (reference pmm_time_optimal_trajectory, planning.py:191-210)."""
    p0, v0, p1, v1 = (np.asarray(x, float) for x in (p0, v0, p1, v1))
    T = pmm_min_time(p0, v0, p1, v1, u_lower, u_upper)
    if not np.isfinite(T) or T < 0:
        return None
    if T == 0:
        return PiecewiseTrajectory([Trajectory([np.array([p0[i]]) for i in range(3)], 0.0, 1e-6)])
    t1s, alphas = np.zeros(3), np.zeros(3)
    for i in range(3):
        t1s[i], alphas[i] = _scalar_policy_fixed_time(
            p0[i], v0[i], p1[i], v1[i], u_lower[i], u_upper[i], T
        )
    if np.any(np.abs(alphas) > 1):
        # Rescale accelerations into limits and stretch T (planning.py:176-183).
        scale = np.max(np.abs(alphas))
        alphas = alphas / scale
        T = pmm_min_time(p0, v0, p1, v1, np.asarray(u_lower) * np.abs(alphas), np.asarray(u_upper) * np.abs(alphas))
        for i in range(3):
            t1s[i], alphas[i] = _scalar_policy_fixed_time(
                p0[i], v0[i], p1[i], v1[i], u_lower[i], u_upper[i], T
            )
        alphas = np.clip(alphas, -1, 1)

    # Build piecewise constant-acceleration segments at the sorted switch
    # times; axis i accelerates at alpha*u_lo before t1[i], alpha*u_hi after.
    times = np.concatenate([[0.0], np.sort(t1s), [T]])
    p, v = p0.copy(), v0.copy()
    segments = []
    for k in range(len(times) - 1):
        dt = times[k + 1] - times[k]
        if dt <= 1e-12:
            continue
        t_mid = 0.5 * (times[k] + times[k + 1])
        u = np.where(t_mid < t1s, np.asarray(u_lower), np.asarray(u_upper)) * alphas
        coeffs = [np.array([p[i], v[i], u[i] / 2.0]) for i in range(3)]
        segments.append(Trajectory(coeffs, 0.0, dt))
        p = p + v * dt + 0.5 * u * dt**2
        v = v + u * dt
    if not segments:
        return None
    return PiecewiseTrajectory(segments)


# -- layered search through gates ---------------------------------------------

def _spherical2cartesian(rtp):
    r, th, ph = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    return np.stack(
        [r * np.cos(th) * np.cos(ph), r * np.cos(th) * np.sin(ph), r * np.sin(th)], -1
    )


def _cartesian2spherical(v):
    r = np.linalg.norm(v, axis=-1)
    theta = np.arcsin(np.clip(v[..., 2] / np.maximum(r, 1e-9), -1, 1))
    phi = np.arctan2(v[..., 1], v[..., 0])
    return np.stack([r, theta, phi], -1)


def _gate_rotation(yaw):
    """Gate normal direction = rotated +y? The fly-through direction is the
    gate plane normal: (−sin yaw, cos yaw, 0) given the reference's lateral
    axis (cos yaw, sin yaw, 0)."""
    c, s = np.cos(yaw), np.sin(yaw)
    # Columns: gate x (lateral), gate y (normal), gate z (up).
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def insert_obstacle_detours(start, goal, waypoints, obstacles_xy,
                            r_safe: float, min_leg: float = 0.8):
    """Weave lateral via-points into a gate-waypoint list so no straight leg
    passes within ``r_safe`` (in xy) of an obstacle center.

    Obstacle poses are only known NOMINALLY (levels 2/3 randomize them by
    ±0.15 per axis and there is no in-flight sighting channel), so a plan
    that merely satisfies the collision-pruned DP can thread within a few cm
    of where the true cylinder actually spawned.  For each leg between
    consecutive waypoints (including start -> first and last -> goal) whose
    straight line clips the ``r_safe`` disc of an obstacle, this inserts a
    via-point at the closest approach, pushed out radially to ``r_safe`` —
    the DP then routes the leg around the uncertainty disc while its own
    hard pruning (tracking-margin radius) keeps feasibility.

    ``waypoints``: [(pos(3,), dir_angle)] as consumed by
    :func:`plan_time_optimal_trajectory_through_gates`; ``obstacles_xy``:
    (N, 2) nominal obstacle centers.  Legs shorter than ``min_leg`` (the
    pre/center/post triple around a gate aperture) are left alone.  Returns
    a new waypoint list.
    """
    obstacles_xy = np.asarray(obstacles_xy, float).reshape(-1, 2)
    if not len(obstacles_xy) or not waypoints:
        return list(waypoints)
    pts = [np.asarray(start, float)] + [np.asarray(w[0], float) for w in waypoints] \
        + [np.asarray(goal, float)]
    out = []
    for i in range(len(pts) - 1):
        a, b = pts[i], pts[i + 1]
        d = b[:2] - a[:2]
        leg = float(np.linalg.norm(d))
        detours = []
        if leg > min_leg:
            dir_angle = float(np.arctan2(d[1], d[0]))
            for o in obstacles_xy:
                t = float(np.dot(o - a[:2], d) / (leg * leg))
                t = min(max(t, 0.1), 0.9)  # keep vias off the waypoints
                c = a + t * (b - a)
                radial = c[:2] - o
                dist = float(np.linalg.norm(radial))
                if dist >= r_safe:
                    continue
                if dist < 1e-6:  # dead-on: push perpendicular to the leg
                    radial = np.array([-d[1], d[0]]) / leg
                    dist = 1.0
                via_xy = o + radial / dist * r_safe
                detours.append((t, (np.array([via_xy[0], via_xy[1], c[2]]),
                                    dir_angle)))
        if i > 0:
            out.append(waypoints[i - 1])
        out.extend(w for _, w in sorted(detours, key=lambda x: x[0]))
    return out


def plan_with_obstacle_uncertainty(
    initial_state: State,
    final_state: State,
    waypoints,
    acceleration_limits: Limits,
    velocity_limits: Limits,
    obstacles_xy,
    r_safe: float,
    max_detour_rounds: int = 3,
    **plan_kwargs,
):
    """Plan through gate waypoints, then push the PLANNED path out of the
    obstacle-uncertainty discs and re-plan until clear.

    ``insert_obstacle_detours`` only checks straight chords; the chosen PMM
    segments curve with the sampled crossing velocities and can bow back
    inside the disc a chord clears.  Each round samples the actual planned
    trajectory, finds the deepest xy incursion into any ``r_safe`` disc
    around a nominal obstacle center, inserts a via-point there (pushed out
    radially to ``r_safe``), and re-plans.  The DP's own hard pruning
    (tracking-margin cylinders in ``plan_kwargs['obstacles']``) is
    unchanged, so feasibility is preserved.
    """
    obstacles_xy = np.asarray(obstacles_xy, float).reshape(-1, 2)
    wps = insert_obstacle_detours(
        initial_state.position, final_state.position, waypoints,
        obstacles_xy, r_safe,
    )
    traj = None
    for round_i in range(max_detour_rounds + 1):
        traj = plan_time_optimal_trajectory_through_gates(
            initial_state, final_state, wps,
            acceleration_limits, velocity_limits, **plan_kwargs,
        )
        if traj is None or not len(obstacles_xy):
            return traj
        ts = np.linspace(0.0, traj.duration, 300)
        pts = np.array([np.asarray(traj.position(t)).reshape(-1) for t in ts])
        d = np.linalg.norm(
            pts[:, None, :2] - obstacles_xy[None, :, :], axis=-1
        )  # (T, N)
        depth = r_safe - d.min()
        if depth <= 1e-3:
            return traj
        if round_i == max_detour_rounds:
            # No planning round left to consume a new via-point; inserting
            # one here would never be replanned.  Return the best-so-far.
            return traj
        ti, oi = np.unravel_index(np.argmin(d), d.shape)
        c = pts[ti]
        o = obstacles_xy[oi]
        radial = c[:2] - o
        dist = float(np.linalg.norm(radial))
        if dist < 1e-6:
            radial, dist = np.array([1.0, 0.0]), 1.0
        via = np.array([*(o + radial / dist * r_safe), c[2]])
        # Insert between the polyline leg nearest to the incursion point.
        poly = [np.asarray(initial_state.position, float)] \
            + [np.asarray(w[0], float) for w in wps] \
            + [np.asarray(final_state.position, float)]
        best_i, best_d = 0, np.inf
        for i in range(len(poly) - 1):
            a, b = poly[i][:2], poly[i + 1][:2]
            ab = b - a
            L2 = float(ab @ ab)
            t = 0.0 if L2 < 1e-12 else float(np.clip((c[:2] - a) @ ab / L2, 0, 1))
            dd = float(np.linalg.norm(a + t * ab - c[:2]))
            if dd < best_d:
                best_i, best_d = i, dd
        dir_angle = float(np.arctan2(
            poly[best_i + 1][1] - poly[best_i][1],
            poly[best_i + 1][0] - poly[best_i][0]))
        wps = list(wps)
        wps.insert(best_i, (via, dir_angle))
    return traj


def plan_time_optimal_trajectory_through_gates(
    initial_state: State,
    final_state: State,
    gate_poses: Sequence[Tuple[np.ndarray, float]],  # (xyz, yaw) per gate
    acceleration_limits: Limits,
    velocity_limits: Limits,
    max_iterations: int = 5,
    num_cone_samples: int = 3,
    cone_refocusing_factor: float = 0.8,
    convergence_epsilon: float = 1.0,
    obstacles: Optional[List[CylinderObstacle]] = None,
    safe_obstacle_distance: float = 0.3,
    collision_samples: int = 60,
):
    """Layered DP through velocity-cone samples at each gate, with obstacle
    pruning and cone refocusing (reference planning.py:262-375)."""
    obstacles = obstacles or []
    n_gates = len(gate_poses)
    vel_limits = [velocity_limits] * n_gates
    best_time = np.inf
    best_traj = None

    for it in range(1, max_iterations + 1):
        # Sample velocity cones per gate in the gate frame.
        layers = []  # list of list[State]
        for i, (gpos, gyaw) in enumerate(gate_poses):
            lo, hi = vel_limits[i]
            grid = np.stack(
                np.meshgrid(*[np.linspace(lo[d], hi[d], num_cone_samples) for d in range(3)]),
                -1,
            ).reshape(-1, 3)
            R = _gate_rotation(gyaw)
            vels = _spherical2cartesian(grid) @ R.T
            layers.append([State(np.asarray(gpos, float), v) for v in vels])
        layers.append([final_state])

        # Forward DP over layers.
        costs = [np.array([0.0])]
        back = []
        trajs = []
        states_prev = [initial_state]
        feasible = True
        for layer in layers:
            n_prev, n_cur = len(states_prev), len(layer)
            seg_T = np.full((n_prev, n_cur), np.inf)
            seg_traj = [[None] * n_cur for _ in range(n_prev)]
            for j, sp in enumerate(states_prev):
                for k, sc in enumerate(layer):
                    traj = pmm_segment(
                        sp.position, sp.velocity, sc.position, sc.velocity,
                        acceleration_limits.lower, acceleration_limits.upper,
                    )
                    if traj is None:
                        continue
                    # Obstacle pruning (planning.py:295-313).
                    if obstacles:
                        _, pts, _ = traj.sample(collision_samples)
                        if any(o.min_distance(pts[:, :3]) <= 0 for o in obstacles):
                            continue
                    seg_T[j, k] = traj.duration
                    seg_traj[j][k] = traj
            total = costs[-1][:, None] + seg_T
            if not np.isfinite(total.min()):
                feasible = False
                break
            costs.append(total.min(0))
            back.append(total.argmin(0))
            trajs.append(seg_traj)
            states_prev = layer
        if not feasible:
            vel_limits = [velocity_limits] * n_gates  # reset cones and retry
            continue

        # Backtrack.
        path = [0]
        for i in range(len(back) - 1, -1, -1):
            path.append(int(back[i][path[-1]]))
        path = path[::-1]  # node index per layer, starting at layer 0
        segs = []
        chosen_states = [initial_state]
        cur = 0
        for i, layer in enumerate(layers):
            nxt = path[i + 1]
            segs.extend(trajs[i][cur][nxt].segments)
            chosen_states.append(layer[nxt])
            cur = nxt
        trajectory = PiecewiseTrajectory(segs)

        if abs(best_time - trajectory.duration) < convergence_epsilon:
            best_traj = trajectory
            break
        if trajectory.duration < best_time:
            best_time = trajectory.duration
            best_traj = trajectory

        # Cone refocusing around the chosen gate velocities (planning.py:355-370).
        for i, (gpos, gyaw) in enumerate(gate_poses):
            v = chosen_states[i + 1].velocity
            R = _gate_rotation(gyaw)
            rtp = _cartesian2spherical(R.T @ v)
            f = cone_refocusing_factor ** (1.0 / it)
            vel_limits[i] = Limits(lower=(1 - f) * rtp, upper=(1 + f) * rtp)

    return best_traj
