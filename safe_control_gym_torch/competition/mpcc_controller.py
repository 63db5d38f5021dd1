"""Model Predictive Contouring Control (MPCC) for gate racing.

Port of ``safe_control_gym_tpu/competition/mpcc_controller.py`` (the
counterpart of reference competition/mpcc_controller.py, Romero TRO'22
style): the drone races along a planned reference path parameterized by
progress theta; the optimizer trades contouring/lag error against progress
speed.

  * extended state [quad(12), rate-bounded thrusts rbf(4), theta,
    theta_dot] with inputs [delta_rbf(4), theta_dd]: thrust SLEW is the
    decision variable, matching the reference's rate-bounded actuator model
    (mpcc_controller.py:250-318);
  * inequality bounds through the augmented-Lagrangian outer loop of the
    port's batch-first ``ops/trajopt.py::al_ilqr_solve`` at a batch of one,
    with warm-started multipliers: per-motor thrust min/max, thrust slew,
    inclination <= 60 deg, |body rate|, 0 <= theta_dot <= max, |theta_dd|
    (mpcc_controller.py:745-790);
  * cost = lag + variable-weight contour (Gaussian kernels around gates and
    obstacles baked into a per-theta table) + body-rate, progress-acc and
    thrust-slew quadratics - a speed-bump-modulated progress incentive +
    a hinge^2 repulsion from gate frames and obstacles;
  * the path lookup p(theta)/tangent(theta) is a dense table interpolated by
    :func:`interp`, the port's ``jnp.interp``: it clamps at the ends, takes
    the bracket ``searchsorted(side='right')`` takes (at a knot, the segment
    to its right), and runs under ``torch.func``'s ``vmap`` and ``jacfwd``
    (the bracket is a count of grid points at or below theta, not a
    ``searchsorted``, and holds on any sorted grid, uniform or not).

The hinges are ``torch.maximum`` against a zero tensor and the minima
``torch.minimum``/``amin``, which split a derivative at a tie as
``jnp.maximum``/``jnp.min`` do (``clamp`` and ``min(dim)`` would not).  The
solve's per-step inputs (the start state, the gate frames and their bands)
are built on the host in NumPy and reach the device in one copy; the
warm start (shifted inputs and multipliers) stays on the device; the solve
makes one read back, its states.

Fault (c) of the JAX package (the warm-solve cut keys on the solve count
alone, mpcc_controller.py:460) is not copied: a change of the frames or
bands by more than ``FRAMES_TOL`` restarts the count, so the next
``warm_after`` solves use the cold iteration counts.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.envs.gates import (DRONE_RADIUS, GATE_INNER_HALF, GATE_OUTER_HALF,
                                               GATE_SLAB_HALF, OBSTACLE_RADIUS)
from safe_control_gym_torch.envs.quadrotor import GRAVITY_ACC, J_DIAG, MASS, quad_fc_3d
from safe_control_gym_torch.ops.integrators import rk4_step
from safe_control_gym_torch.ops.quad_substeps import div
from safe_control_gym_torch.ops.trajopt import al_ilqr_solve
from safe_control_gym_torch.utils.device import resolve_device

# Extended-state layout (shared by the class and the module-level solver).
_RBF = slice(12, 16)
_TH = 16
_THD = 17
N_CONSTRAINTS = 18
# A change of the frames or bands larger than this (m, rad) restarts the
# warm-solve count (fault (c) of the JAX package, not copied).
FRAMES_TOL = 1e-3

# Trust-region for the internal rollout: iLQR line-search candidates can
# visit |theta| ~ pi/2 where the Euler kinematics blow up (tan/sec),
# poisoning the whole solve with NaNs.  Clip attitude/rates/velocity after
# each internal step; the optimum stays far inside the box.
_ROLLOUT_LIM = np.asarray(
    [5.0, 8.0, 5.0, 8.0, 5.0, 8.0, 1.2, 1.2, 3.2, 25.0, 25.0, 25.0], np.float32)

# The path tables' columns: position (3), unit tangent (3), contour weight,
# plan speed.
_P, _T, _W, _S = slice(0, 3), slice(3, 6), 6, 7


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` of a scalar ``x`` on a sorted grid ``xp``
    (N,) over every column of ``fp`` (N, C) -> (C,): the bracket of
    ``searchsorted(xp, x, side='right')`` clipped to [1, N-1], a zero-width
    bracket's left value, ``fp[0]`` below the grid and ``fp[-1]`` above.
    Batches under ``torch.func.vmap`` and differentiates under ``jacfwd``
    and ``grad`` (in ``x``)."""
    n = xp.shape[0]
    # index_select, not xp[i]: a 0-dim index tensor would be read back as
    # an int, which vmap refuses.
    i = torch.clamp((xp <= x).sum(), 1, n - 1).reshape(1)
    x0, x1 = xp.index_select(0, i - 1)[0], xp.index_select(0, i)[0]
    f0, f1 = fp.index_select(0, i - 1)[0], fp.index_select(0, i)[0]
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                    else np.float64).eps))
    dx0 = dx.abs() <= eps  # a zero-width bracket: no NaN gradient
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _f32(v) -> float:
    """A Python float rounded to float32 (the JAX package's f32 scalars)."""
    return float(np.float32(v))


def _mpcc_solve(tables, scal, x0_ext, us_init, mu0, frames, bands, *, al_iters, inner_iters):
    """One MPCC AL-iLQR solve on a batch of one: ``x0_ext`` (1, 18),
    ``us_init`` (1, T, 5), ``mu0`` (1, T, 18), ``frames`` (G, 4), ``bands``
    (G,) -> (xs (1, T+1, 18), us (1, T, 5), cost (1,), mu (1, T, 18)).

    ``tables``: the plan's device tensors (``grid`` (N,), ``path`` (N, 8),
    ``gate_positions`` (G, 3), ``obst_xy`` (O, 2), and the constants
    ``mass``, ``j_diag``, ``lim``, ``zero``, ``tiny``, ``ten``,
    ``theta_max``); ``scal``: the weights and bounds as Python floats
    (float32 values)."""
    dt = scal["dt"]
    grid, path = tables["grid"], tables["path"]
    zero, lim = tables["zero"], tables["lim"]
    obst_xy, gate_positions = tables["obst_xy"], tables["gate_positions"]
    sig2 = _f32(scal["speed_bump_sigma"] * np.float32(scal["speed_bump_sigma"]))

    # The stage cost and the constraints take one-element slices (x[k:k+1]),
    # never 0-dim ones: under torch.func's jvp a 0-dim float32 tensor met by
    # a Python float gets a float64 tangent, which a nonlinear op then
    # carries into a float64 Hessian (torch 2.13).

    def lookup(theta):
        th = torch.minimum(torch.maximum(theta, zero), tables["theta_max"])
        row = interp(th, grid, path)
        t = row[_T]
        t_norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        return row[_P], t / torch.maximum(t_norm, tables["tiny"]), row[_W:_W + 1], row[_S:_S + 1]

    def fc(x, u):
        # Quad driven by the CURRENT rate-bounded thrusts; thrust slew and
        # the theta double-integrator are exact Euler chains (reference
        # mpcc_controller.py:295-298 uses the same forward-Euler form).
        quad = quad_fc_3d(x[..., :12], x[..., _RBF], tables["mass"], tables["j_diag"],
                          tables["z3"])
        return torch.cat([quad, u[..., :4], x[..., _THD:_THD + 1], u[..., 4:5]], -1)

    def fd(x, u):
        xn = rk4_step(fc, x, u, dt)
        return torch.cat([torch.minimum(torch.maximum(xn[..., :12], -lim), lim), xn[..., 12:]],
                         -1)

    def repulsion_cost(pos):
        """Hinge^2 on proximity to gate-frame material and obstacle
        cylinders.  Gate margin math mirrors envs/gates.py gate_frame_margin
        (incl. the support leg); obstacles use their NOMINAL xy (never
        measured in flight) with a radius that covers the +-0.15 pose
        randomization.  (1,)"""
        cost = zero.reshape(1)
        if frames.shape[0]:
            rel = pos[None, :2] - frames[:, :2]
            c, s = torch.cos(frames[:, 2]), torch.sin(frames[:, 2])
            uu = rel[:, 0] * c + rel[:, 1] * s
            nn = -rel[:, 0] * s + rel[:, 1] * c
            ww = pos[2:3] - frames[:, 3]
            uw = torch.maximum(uu.abs(), ww.abs())
            f_slab = nn.abs() - (GATE_SLAB_HALF + DRONE_RADIUS)
            f_outer = uw - (GATE_OUTER_HALF + DRONE_RADIUS)
            f_inner = (GATE_INNER_HALF - DRONE_RADIUS) - uw
            frame_m = torch.maximum(torch.maximum(f_slab, f_outer), f_inner)
            leg_m = torch.maximum(
                torch.sqrt(rel[:, 0] ** 2 + rel[:, 1] ** 2 + 1e-12)
                - (OBSTACLE_RADIUS + DRONE_RADIUS),
                pos[2:3] - (frames[:, 3] - GATE_OUTER_HALF))
            m = torch.minimum(frame_m, leg_m)
            cost = cost + scal["w_rep"] * torch.sum(torch.maximum(bands - m, zero) ** 2, -1,
                                                    keepdim=True)
        if obst_xy.shape[0]:
            d = torch.sqrt(torch.sum((pos[None, :2] - obst_xy) ** 2, -1) + 1e-12)
            cost = cost + scal["w_rep"] * torch.sum(
                torch.maximum(scal["obst_rep_r"] - d, zero) ** 2, -1, keepdim=True)
        return cost

    def stage_cost(x, u, k):
        pos = x[0:5:2]
        theta, theta_dot = x[_TH:_TH + 1], x[_THD:_THD + 1]
        p_ref, t_hat, w_contour, plan_spd = lookup(theta)
        e = pos - p_ref
        e_lag = torch.sum(e * t_hat, -1, keepdim=True)
        e_cont = e - e_lag * t_hat
        # Progress incentive with the reference's speed-bump modulation
        # (mpcc_controller.py:360-400): near a gate, above the speed
        # threshold, the incentive collapses (goes negative) and the
        # optimizer brakes.
        v_ms = theta_dot * plan_spd
        if gate_positions.shape[0]:
            d2 = torch.sum((pos[None] - gate_positions) ** 2, -1)
            proximity = torch.exp(div(-0.5 * torch.amin(d2, -1, keepdim=True), sig2))
        else:
            proximity = zero.reshape(1)
        speed_factor = torch.exp(1.0 + div(scal["speed_bump_k"]
                                           * (v_ms - scal["speed_bump_threshold"]),
                                           scal["speed_bump_threshold"]))
        incentive_w = scal["mu"] * (1.0 - proximity * torch.minimum(speed_factor,
                                                                     tables["ten"]))
        cost = (scal["q_lag"] * e_lag**2
                + w_contour * torch.sum(e_cont**2, -1, keepdim=True)
                + scal["q_body_rate"] * (x[9:10] ** 2 + x[10:11] ** 2)
                + scal["r_theta_dd"] * u[4:5] ** 2
                + scal["r_delta"] * torch.sum(u[:4] ** 2, -1, keepdim=True)
                - incentive_w * theta_dot * dt
                + repulsion_cost(pos))
        return cost[0]

    def term_cost(x):
        return stage_cost(x, x.new_zeros(5), 0) * 2.0

    def constraint_fn(x, u):
        """g <= 0 rows (mpcc_controller.py:745-790 subject_to set)."""
        rbf = x[_RBF]
        rate2 = _f32(scal["rate_max"] * np.float32(scal["rate_max"]))
        return torch.cat([
            scal["f_min"] - rbf,  # per-motor floor (4)
            rbf - scal["f_max"],  # per-motor ceiling (4)
            u[:4].abs() - scal["slew_max"],  # thrust slew (4)
            x[6:8].abs() - scal["incl_max"],  # |roll|, |pitch|
            x[9:10] ** 2 + x[10:11] ** 2 - rate2,  # |body rate|^2
            -x[_THD:_THD + 1],  # theta_dot >= 0
            x[_THD:_THD + 1] - scal["theta_dot_max"],
            u[4:5].abs() - scal["theta_dd_max"],
        ])

    res, mu = al_ilqr_solve(fd, stage_cost, term_cost, constraint_fn, x0_ext, us_init,
                            al_iters=al_iters, inner_iters=inner_iters, mu0=mu0)
    return res.xs, res.us, res.cost, mu


class MPCCController:
    def __init__(
        self,
        trajectory,  # PiecewiseTrajectory from the planner
        dt: float,
        horizon: int = 20,
        q_contour_min: float = 25.0,   # MPCC_CONTOUR_ERROR_WEIGHT_MIN
        q_contour_max: float = 45.0,   # MPCC_CONTOUR_ERROR_WEIGHT_MAX
        contour_sigma: float = 0.4,    # MPCC_CONTOUR_ERROR_GAUSSIAN_SIGMA (m)
        q_lag: float = 45.0,           # MPCC_LAG_ERROR_WEIGHT
        q_body_rate: float = 1.4,      # MPCC_BODY_ORIENTATION_RATE_WEIGHT_DIAG
        mu_progress: float = 6.0,      # progress incentive (dt-scaled form)
        r_delta: float = 0.05,         # thrust-slew quadratic
        r_theta_dd: float = 0.08,      # MPCC_CONTOUR_RATE_CHANGE_WEIGHT
        speed_bump_k: float = 5.0,     # MPCC_SPEED_BUMP_K
        speed_bump_threshold: float = 1.2,  # m/s
        speed_bump_sigma: float = 0.4,      # m
        gate_thetas=(),                # progress values at gate crossings
        gate_positions=(),             # (G, 3) gate centers for kernels
        obstacle_positions=(),         # (O, 2 or 3) obstacle xy for kernels
        gate_frames=None,              # (G, 4) x,y,yaw,height for repulsion
        w_rep: float = 800.0,          # frame-repulsion hinge weight
        rep_band: float = 0.12,        # repulsion standoff vs MEASURED frames (m)
        fuzzy_extra: float = 0.15,     # extra standoff while a pose is unmeasured
        obst_rep_r: float = 0.34,      # obstacle repulsion radius vs NOMINAL (m)
        theta_dot_max: float = 1.5,
        theta_dd_max: float = 4.0,
        slew_max: float = 2.0,         # N/s per motor
        incl_max: float = np.deg2rad(60.0),
        rate_max: float = 10.0,        # rad/s, |p|,|q| bound
        mass: float = MASS,
        table_points: int = 600,
        al_iters: int = 2,
        inner_iters: int = 6,
        warm_al_iters: int = 1,
        warm_inner_iters: int = 3,
        warm_after: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dt = dt
        self.T = horizon
        self.mass = mass
        ts, pos, vel, s = trajectory.arclength_table(table_points)
        # Parameterize by trajectory time: theta in [0, duration].  The
        # tables stay on the host in NumPy (the stage's lookups) and reach
        # the device once (the solver's).
        self.theta_grid = np.asarray(ts - ts[0], np.float32)
        self.path_pos = np.asarray(pos[:, :3], np.float32)
        # Tangents from central position differences, NOT velocities: the
        # retimed plan starts/ends at rest, and normalizing a ~zero velocity
        # yields a garbage direction that corrupts the lag/contour error
        # decomposition near theta=0.
        p3 = pos[:, :3]
        tang = np.gradient(p3, axis=0)
        tang = tang / np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-9)
        self.path_tan = np.asarray(tang, np.float32)
        self.path_vel = np.asarray(vel[:, :3], np.float32)
        # Plan speed profile |v|(theta): converts plan-relative theta_dot to
        # m/s for the reference's speed-bump terms.
        self.path_speed = np.asarray(np.linalg.norm(self.path_vel, axis=-1), np.float32)
        self.theta_max = float(self.theta_grid[-1])
        self.gate_thetas = np.asarray(gate_thetas, np.float32)
        gates3 = np.asarray(gate_positions, np.float32).reshape(-1, 3)
        self.gate_positions = gates3
        # Frame poses for the repulsion hinge (x, y, yaw, aperture height):
        # measured once the env reveals them in range, nominal + fuzzy_extra
        # standoff before (levels 2/3 randomize them by +-0.15 m/axis).
        self.frames0 = (np.asarray(gate_frames, np.float32).reshape(-1, 4)
                        if gate_frames is not None else np.zeros((0, 4), np.float32))
        self.rep_band = float(rep_band)
        self.fuzzy_extra = float(fuzzy_extra)
        self._obst_xy = np.asarray(obstacle_positions, np.float32).reshape(-1, 2)
        self._w_rep = float(w_rep)
        self._obst_rep_r = float(obst_rep_r)

        # Variable contour weight baked into a per-theta table
        # (mpcc_controller.py:536-560): MIN everywhere, +Gaussian kernels of
        # amplitude (MAX-MIN) around each gate (3D) and obstacle (2D).
        w = np.full(p3.shape[0], q_contour_min, np.float32)
        amp = q_contour_max - q_contour_min
        for g in gates3:
            d2 = np.sum((p3 - g[None]) ** 2, axis=-1)
            w += amp * np.exp(-0.5 * d2 / contour_sigma**2)
        for o in self._obst_xy:
            d2 = np.sum((p3[:, :2] - o[None]) ** 2, axis=-1)
            w += amp * np.exp(-0.5 * d2 / contour_sigma**2)
        self.contour_w = np.asarray(w, np.float32)

        self.params = dict(
            q_lag=q_lag, q_body_rate=q_body_rate, mu=mu_progress,
            r_delta=r_delta, r_theta_dd=r_theta_dd,
            speed_bump_k=speed_bump_k, speed_bump_threshold=speed_bump_threshold,
            speed_bump_sigma=speed_bump_sigma,
            theta_dot_max=theta_dot_max, theta_dd_max=theta_dd_max,
            slew_max=slew_max, incl_max=float(incl_max), rate_max=rate_max,
        )
        self.al_iters = al_iters
        self.inner_iters = inner_iters
        # Warm-solve iteration cut: after ``warm_after`` consecutive
        # warm-started solves on the same frames and bands, the shifted
        # (us, mu) pair is already near the new optimum, and 1x3 iterations
        # track it at a quarter of the 2x6 cold-solve cost.
        self.warm_al_iters = warm_al_iters
        self.warm_inner_iters = warm_inner_iters
        self.warm_after = int(warm_after)
        self._n_solves = 0
        self.hover = mass * GRAVITY_ACC / 4.0
        self.f_min = 0.25 * self.hover   # per-motor thrust floor
        self.f_max = 3.0 * self.hover    # per-motor ceiling (PWM-limit scale)
        self._us_prev = None
        self._mu_prev = None
        self._last_frames = None  # the previous solve's frames and bands (fault (c))
        self.last_iters = None  # (al_iters, inner_iters) of the last solve

        dev, f32 = self.device, torch.float32
        table = np.concatenate([self.path_pos, self.path_tan, self.contour_w[:, None],
                                self.path_speed[:, None]], 1)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        self._tables = dict(
            grid=t(self.theta_grid), path=t(table), gate_positions=t(gates3),
            obst_xy=t(self._obst_xy), mass=t(mass), j_diag=t(J_DIAG),
            z3=torch.zeros(3, dtype=f32, device=dev), lim=t(_ROLLOUT_LIM),
            zero=torch.zeros((), dtype=f32, device=dev), tiny=t(1e-6), ten=t(10.0),
            theta_max=t(self.theta_max))
        self._scal = dict(
            dt=_f32(self.dt), f_min=_f32(self.f_min), f_max=_f32(self.f_max),
            w_rep=_f32(self._w_rep), obst_rep_r=_f32(self._obst_rep_r),
            **{k: _f32(v) for k, v in self.params.items()})

    def reference_at(self, theta, theta_dot=1.0):
        """(pos, vel) on the planned path at progress ``theta`` — host-side
        lookup for trackers that follow the path geometry at the optimizer's
        chosen speed (velocity scales with theta_dot)."""
        th = float(np.clip(theta, 0.0, self.theta_max))
        p = np.array([np.interp(th, self.theta_grid, self.path_pos[:, i]) for i in range(3)])
        v = np.array([np.interp(th, self.theta_grid, self.path_vel[:, i])
                      for i in range(3)]) * float(theta_dot)
        return p, v

    def tangent_at(self, theta):
        """Host-side unit path tangent at progress ``theta`` (for the stage's
        along-track setpoint tether)."""
        th = float(np.clip(theta, 0.0, self.theta_max))
        t = np.array([np.interp(th, self.theta_grid, self.path_tan[:, i]) for i in range(3)])
        return t / max(np.linalg.norm(t), 1e-9)

    # Extended-state layout.
    _RBF = _RBF
    _TH = _TH
    _THD = _THD

    @property
    def n_constraints(self):
        return N_CONSTRAINTS

    def reset(self):
        self._us_prev = None
        self._mu_prev = None
        self._n_solves = 0
        self._last_frames = None

    def _iters(self, frames, bands):
        """(al_iters, inner_iters) of this solve: the warm cut after
        ``warm_after`` warm-started solves on unchanged frames and bands; a
        change of either by more than FRAMES_TOL restarts the count."""
        key = np.concatenate([frames.reshape(-1), bands.reshape(-1)])
        if (self._last_frames is not None
                and (self._last_frames.shape != key.shape
                     or np.abs(self._last_frames - key).max(initial=0.0) > FRAMES_TOL)):
            self._n_solves = 0
        self._last_frames = key
        warm = self._us_prev is not None and self._n_solves >= self.warm_after
        if warm:
            return self.warm_al_iters, self.warm_inner_iters
        return self.al_iters, self.inner_iters

    @torch.no_grad()
    def solve(self, obs, theta, theta_dot, rbf=None, frames=None, bands=None):
        """One MPCC solve.  obs: 12D quad state.  Returns (next reference
        state for FULLSTATE command, planned xs, new theta/theta_dot).

        ``frames``: (G, 4) best-known gate frame poses (x, y, yaw, height)
        for the repulsion hinge — measured where the env has revealed them,
        nominal otherwise.  ``bands``: (G,) per-gate standoff; defaults to
        the unmeasured-pose standoff (rep_band + fuzzy_extra) everywhere."""
        # Re-anchor progress to the drone's actual position: the virtual
        # theta integrator otherwise runs ahead whenever the tracker lags.
        # Closest path point in a local window around the carried theta,
        # never jumping more than the window per tick.
        pos = np.asarray([obs[0], obs[2], obs[4]], np.float32)
        grid = self.theta_grid
        win = (grid >= theta - 0.3) & (grid <= theta + 0.8)
        if win.any():
            d = np.linalg.norm(self.path_pos[win] - pos, axis=-1)
            theta = float(grid[win][int(d.argmin())])
        if rbf is None:
            rbf = self._us_prev_rbf if self._us_prev is not None else np.full(4, self.hover)
        if frames is None:
            frames = self.frames0
        if bands is None:
            bands = np.full(self.frames0.shape[0], self.rep_band + self.fuzzy_extra, np.float32)
        frames = np.asarray(frames, np.float32).reshape(-1, 4)
        bands = np.asarray(bands, np.float32).reshape(-1)
        al_iters, inner_iters = self._iters(frames, bands)
        # One host-to-device copy: the start state, the frames, the bands.
        G = frames.shape[0]
        host = np.concatenate([np.asarray(obs[:12], np.float32),
                               np.asarray(rbf, np.float32).reshape(4),
                               np.asarray([theta, theta_dot], np.float32),
                               frames.reshape(-1), bands]).astype(np.float32)
        dev = torch.from_numpy(host).to(self.device)
        x0, frames_t, bands_t = dev[None, :18], dev[18:18 + 4 * G].reshape(G, 4), dev[18 + 4 * G:]
        if self._us_prev is None:
            # Cold start with positive progress acceleration: the all-zero
            # slew trajectory is a saddle the line search cannot leave.
            us_init = torch.zeros((1, self.T, 5), dtype=torch.float32, device=self.device)
            us_init[..., 4] = 1.0
            mu0 = torch.zeros((1, self.T, N_CONSTRAINTS), dtype=torch.float32,
                              device=self.device)
        else:
            us_init = torch.cat([self._us_prev[:, 1:], self._us_prev[:, -1:]], 1)
            mu0 = torch.cat([self._mu_prev[:, 1:], self._mu_prev[:, -1:]], 1)
        xs, us, cost, mu = _mpcc_solve(self._tables, self._scal, x0, us_init, mu0, frames_t,
                                       bands_t, al_iters=al_iters, inner_iters=inner_iters)
        self.last_iters = (al_iters, inner_iters)
        self._n_solves += 1
        self._us_prev = us
        self._mu_prev = mu
        xs = xs[0].cpu().numpy()
        x_next = xs[1]
        # Carry the rate-bounded thrust state between solves.
        self._us_prev_rbf = x_next[12:16]
        return x_next, xs, float(x_next[_TH]), float(x_next[_THD])
