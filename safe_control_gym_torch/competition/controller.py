"""Competition controller template + default racing implementation.

Port of ``safe_control_gym_tpu/competition/controller.py`` (the counterpart
of reference competition/edit_this.py, the user-facing Controller with
__init__(initial_obs, initial_info) / cmdFirmware / cmdSimOnly /
interStepLearn / interEpisodeLearn hooks, and ek_controller_impl.py, the
Ekumen stack: plan through gates -> stage sequence: TakeOff -> race ->
Land).  The planner, the stage sequencer, the replanning and the gate
corrections stay NumPy on the host, as in the JAX package; the MPCC solves
and ``cmdSimOnly``'s PID run on ``device`` (CUDA unless the caller names
one).
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.competition.competition_utils import Command, timing_ep, timing_step
from safe_control_gym_torch.competition.mpcc_controller import MPCCController
from safe_control_gym_torch.competition.planning import (
    CylinderObstacle,
    Limits,
    State,
    plan_with_obstacle_uncertainty,
)
from safe_control_gym_torch.competition.stage_actions import (
    StageActionFinished,
    StageActionGotoXY,
    StageActionLand,
    StageActionMPCC,
    StageActionSpline,
    StageActionTakeOff,
    StageSequencer,
)
from safe_control_gym_torch.competition.risk import (
    GateCorrector,
    RateEstimator,
    RiskAdviser,
)
from safe_control_gym_torch.competition.trajectory import retime_trajectory
from safe_control_gym_torch.controllers.pid import PIDState, pid_control
from safe_control_gym_torch.envs.quadrotor import KF
from safe_control_gym_torch.utils.device import resolve_device


class Controller:
    """Default competition controller: time-optimal plan + staged flight.

    Matches the reference template's interface (edit_this.py:55-138) so user
    code written against the reference drops in.
    """

    def __init__(self, initial_obs, initial_info, use_firmware: bool = True,
                 use_mpcc: bool = True, verbose: bool = False,
                 forced_conservative: bool = True, device=None):
        self.device = resolve_device(device)
        self.CTRL_FREQ = initial_info["ctrl_freq"]
        self.CTRL_TIMESTEP = initial_info["ctrl_timestep"]
        self.initial_obs = np.asarray(initial_obs)
        self.verbose = verbose
        self.use_firmware = use_firmware

        gates = initial_info.get("nominal_gates_pos_and_type", [])
        obstacles = initial_info.get("nominal_obstacles_pos", [])
        goal = initial_info.get("x_reference", np.zeros(12))
        gate_dims = initial_info.get("gate_dimensions", {})
        heights = {0: gate_dims.get("tall", {}).get("height", 1.0),
                   1: gate_dims.get("low", {}).get("height", 0.525)}

        # Take off toward a point pulled inside the arena's constraint box
        # (|x|,|y| <= 3 in the competition levels): randomized spawns can sit
        # ~3 cm from the kill boundary with up to 0.1 rad of initial tilt —
        # climbing straight up drifts over the line before attitude settles
        # (done_on_violation ends the episode).  Pulling the takeoff/plan
        # start 15 cm inward makes the first commanded motion point away
        # from the boundary.
        ARENA, INSET = 3.0, 0.15
        start = np.array([
            np.clip(self.initial_obs[0], -(ARENA - INSET), ARENA - INSET),
            np.clip(self.initial_obs[2], -(ARENA - INSET), ARENA - INSET),
            1.0,
        ])
        goal_pos = np.array([goal[0], goal[2], goal[4]]) if len(goal) >= 6 else start
        # Same inward pull for the landing target: level2's stabilization
        # goal sits 10 cm from the |y|<=3 kill boundary, and residual race
        # momentum during LAND can drift over the line (observed: all 4 gates
        # passed, then y crossed 3.0 on descent).  The 0.15 m inset stays
        # inside the goal tolerance (0.15), so task completion is unaffected.
        goal_pos[:2] = np.clip(goal_pos[:2], -(ARENA - INSET), ARENA - INSET)
        # Planning inputs kept for per-episode re-planning under risk advice
        # (reference ek_controller_impl.py:77-92 flight-plan cache).
        self._plan_inputs = dict(
            start=start, goal_pos=goal_pos, heights=heights,
            obstacles=list(obstacles), use_mpcc=use_mpcc,
        )
        gate_poses = [
            (np.array([g[0], g[1], heights[int(g[6])]]), float(g[5])) for g in gates
        ]
        # Obstacles inflated by the drone radius + a tracking-error budget so
        # the tracked flight (not just the plan) stays clear.
        MARGIN = 0.20
        obs_models = [
            CylinderObstacle(np.array([o[0], o[1], 0.0]), 0.05 + MARGIN, 1.05 + 0.1)
            for o in obstacles
        ]
        # Standalone obstacles are never measured in flight (no sightings
        # channel — the reference's gate_data covers gates only), and levels
        # 2/3 randomize their poses by ±0.15 per axis, so a plan that
        # merely clears the DP's pruning radius around the NOMINAL pose can
        # thread within centimeters of the true cylinder.  Legs that clip
        # the uncertainty disc get a detour via-point (insert_obstacle_
        # detours); the DP's hard pruning stays at the tracking margin so
        # feasibility is unchanged.
        OBST_POSE_UNCERTAINTY = 0.15
        self._obst_safe_r = 0.05 + MARGIN + OBST_POSE_UNCERTAINTY
        # Gate frame side posts as virtual obstacles so planned segments clear
        # the frames of gates they merely pass near (the fly-through gate's
        # aperture center is a graph waypoint, so its own posts are cleared
        # by construction).
        for (gp, gyaw) in gate_poses:
            lateral = np.array([np.cos(gyaw), np.sin(gyaw), 0.0])
            for side in (-0.3, 0.3):
                post = gp + side * lateral
                obs_models.append(
                    CylinderObstacle(np.array([post[0], post[1], 0.0]), 0.05 + MARGIN, gp[2] + 0.25)
                )
        self.trajectory = None
        if gate_poses:
            # Plan through pre -> center -> post waypoints per gate, with the
            # velocity cone aligned to the *signed gate normal* (fly-through
            # direction chosen to continue the course): corners then sit
            # ~0.3 m clear of the frames, so a tracking controller cutting
            # corners stays inside the aperture.
            waypoints = []
            prev = start
            for gp, gyaw in gate_poses:
                normal = np.array([-np.sin(gyaw), np.cos(gyaw), 0.0])
                if np.dot(gp - prev, normal) < 0:
                    normal = -normal
                dir_angle = float(np.arctan2(normal[1], normal[0]))
                waypoints.append((gp - 0.3 * normal, dir_angle))
                waypoints.append((gp, dir_angle))
                waypoints.append((gp + 0.3 * normal, dir_angle))
                prev = gp
            self.trajectory = plan_with_obstacle_uncertainty(
                State(start, np.zeros(3)),
                State(goal_pos, np.zeros(3)),
                waypoints,
                Limits(np.array([-4.0, -4.0, -3.0]), np.array([4.0, 4.0, 3.0])),
                Limits(np.array([0.5, -0.3, -0.3]), np.array([2.0, 0.3, 0.3])),
                obstacles_xy=[list(o)[:2] for o in obstacles],
                r_safe=self._obst_safe_r,
                obstacles=obs_models,
                max_iterations=2,
                num_cone_samples=2,
            )
        # Retime the bang-bang plan with a smooth TOPP-style speed profile
        # (slow through apertures) — dynamically consistent to track.
        self.flight_traj = None
        if self.trajectory is not None:
            self.flight_traj = retime_trajectory(
                self.trajectory,
                gate_centers=[gp for gp, _ in gate_poses],
                # Fast between gates, slow through apertures; tuned with the
                # stock-gain firmware under level2 noise (4/4 gates, zero
                # collisions, seed 0 both episodes).
                v_max=2.0, v_gate=0.6, a_max=2.5, v_first=1.1,
            )
        stages = [StageActionTakeOff(self.CTRL_FREQ, height=1.0, duration=2.0)]
        if self.flight_traj is not None:
            if use_mpcc:
                gate_thetas = []
                ts, ps, _ = self.flight_traj.sample(300)
                for gp, _ in gate_poses:
                    d = np.linalg.norm(ps[:, :3] - gp, axis=-1)
                    gate_thetas.append(ts[int(d.argmin())] - ts[0])
                # theta is time-parameterized (MPCCController builds its table
                # from the retimed plan), so theta_dot = 1 rides the plan's
                # own TOPP speed profile; allow modest overspeed only.
                mpcc = MPCCController(
                    self.flight_traj, self.CTRL_TIMESTEP, gate_thetas=gate_thetas,
                    gate_positions=[gp for gp, _ in gate_poses],
                    obstacle_positions=[list(o)[:2] for o in obstacles],
                    # Frame poses for the in-cost repulsion hinge (updated to
                    # measured poses in flight by StageActionMPCC).
                    gate_frames=[
                        (gp[0], gp[1], gyaw, gp[2]) for gp, gyaw in gate_poses
                    ],
                    theta_dot_max=1.0,
                    device=self.device,
                )
                stages.append(StageActionMPCC(
                    self.CTRL_FREQ, mpcc,
                    gate_centers=[gp for gp, _ in gate_poses],
                ))
            else:
                stages.append(
                    StageActionSpline(
                        self.CTRL_FREQ, self.flight_traj, speed_scale=1.0,
                        # Crawl through apertures on top of the TOPP profile:
                        # the effective aperture margin is only ~0.14 m
                        # (inner half-edge minus drone radius), so tracking
                        # error at gates decides collisions.
                        # Wide smooth Gaussian slowdown, asymmetric around
                        # the crossing (long approach, short exit):
                        # decelerate early enough that the stock-gain
                        # Mellinger (KD_OMEGA_RP=200) sheds cross-track
                        # error before the aperture even under level2's
                        # +-0.1 N force noise.
                        gate_centers=[gp for gp, _ in gate_poses],
                        gate_slow_scale=0.28, gate_slow_radius=1.1,
                    )
                )
        if self.flight_traj is not None:
            # Settle at the (inset) goal before descending: the race stage
            # hands over with residual velocity, and LAND holds xy from a
            # MOVING state — observed drifting past the |y|<=3 boundary on
            # level2 (goal 10 cm from the line).  GOTO plans a poly7 from the
            # current full state to rest at the goal, shedding momentum
            # inside the arena.
            stages.append(StageActionGotoXY(
                self.CTRL_FREQ, goal_pos[0], goal_pos[1], z=goal_pos[2],
                duration=1.5,
            ))
        stages += [StageActionLand(self.CTRL_FREQ), StageActionFinished()]
        self.sequencer = StageSequencer(stages)
        # Flight-plan cache keyed by the gate tuple actually planned against
        # (reference ek_controller_impl.py:73-92).
        self._plan_cache = {}
        self._nominal_plan = None  # set after ctor completes (see below)
        # True while flying a plan built from MEASURED gate poses: online
        # gate-correction blending must then be off — the corrections are
        # exact-minus-nominal offsets already baked into the plan, and
        # adding them again double-shifts the track into the gate frames.
        self._plan_is_measured = False

        # cmdSimOnly support (software PID path, edit_this.py cmdSimOnly).
        self._act_bounds = initial_info.get("physical_action_bounds")
        self._gate_centers = [gp for gp, _ in gate_poses] if gate_poses else None
        self._ref_t = self.trajectory.start_time if self.trajectory is not None else 0.0
        self._pid_state = PIDState.create((1,), device=self.device)
        self.interstep_counter = 0
        self.interepisode_counter = 0

        # Meta-strategy stack (reference ek_controller_impl.py:52-57,113-135):
        # online vel/pqr estimation for pose-only obs streams, per-episode
        # risk advice, and gate-pose correction tracking.  Forced conservative
        # matches the reference's shipped configuration (:57).
        self.rate_estimator = RateEstimator(self.CTRL_TIMESTEP)
        self.risk_adviser = RiskAdviser(forced_conservative_mode=forced_conservative)
        self.gate_corrector = GateCorrector(gate_heights=heights)
        self._last_task_completed = False
        self._z_trim = self.Z_TRIM_INIT
        self._z_trim_last_des = None

    def replan(self, gates):
        """Rebuild trajectory + stage sequence against measured gate poses.

        ``gates`` rows are (x, y, z, r, p, yaw, type) env-config tuples.  Used
        by the risk adviser's RECKLESS branch (reference
        ek_controller_impl.py:119-127: re-configure against the most likely
        gate poses measured in earlier episodes).
        """
        key = tuple(tuple(np.round(np.asarray(g, float), 4)) for g in gates)
        if key in self._plan_cache:
            (self.trajectory, self.flight_traj, self.sequencer,
             self._gate_centers, self._ref_t) = self._plan_cache[key]
            self.sequencer.reset()
            return
        pi = self._plan_inputs
        fresh = Controller(
            self.initial_obs,
            {
                "ctrl_freq": self.CTRL_FREQ,
                "ctrl_timestep": self.CTRL_TIMESTEP,
                "nominal_gates_pos_and_type": list(gates),
                "nominal_obstacles_pos": pi["obstacles"],
                "x_reference": np.asarray(
                    [pi["goal_pos"][0], 0, pi["goal_pos"][1], 0, pi["goal_pos"][2], 0]
                ),
                "gate_dimensions": {
                    "tall": {"shape": "square", "height": pi["heights"][0]},
                    "low": {"shape": "square", "height": pi["heights"][1]},
                },
            },
            use_firmware=self.use_firmware,
            use_mpcc=pi["use_mpcc"],
            device=self.device,
        )
        self.trajectory = fresh.trajectory
        self.flight_traj = fresh.flight_traj
        self.sequencer = fresh.sequencer
        self._gate_centers = fresh._gate_centers
        self._ref_t = fresh._ref_t
        self._plan_cache[key] = (
            self.trajectory, self.flight_traj, self.sequencer,
            self._gate_centers, self._ref_t,
        )

    # -- firmware command path (edit_this.py cmdFirmware) -----------------------
    def cmdFirmware(self, time_s, obs, reward=None, done=None, info=None):
        obs = np.asarray(obs)
        pos = np.array([obs[0], obs[2], obs[4]])
        vel = np.array([obs[1], obs[3], obs[5]])
        rpy = obs[6:9]
        pqr = obs[9:12]
        # Vicon-style obs carry pose only; estimate the missing rates
        # (reference ek_controller_impl.py:142-145).
        est_vel, est_pqr = self.rate_estimator.estimate(pos, rpy)
        if not np.any(vel):
            vel = est_vel
        if not np.any(pqr) and self.rate_estimator.body_rates_enabled:
            pqr = est_pqr
        corrections = self.gate_corrector.update(info or {})
        if self._plan_is_measured:
            corrections = None
        if info:
            if info.get("task_completed"):
                self._last_task_completed = True
            if info.get("at_goal_position"):
                self._last_task_completed = True
        it = int(round(time_s * self.CTRL_FREQ))
        command, args = self.sequencer.run(it, pos, vel, rpy, pqr,
                                           corrections=corrections)
        return self._apply_z_trim(command, args, pos, vel)

    # Stock-firmware altitude trim: the Mellinger's internal vehicle mass
    # (0.032 kg, controller_mellinger.c) exceeds the cf2x's 0.027 kg, so the
    # closed loop hovers ~+10 cm above any commanded altitude (measured
    # +0.099 m steady, sigma 4 mm, under level2 noise).  At a low gate the
    # aperture margin is 0.14 m — the un-trimmed bias eats ~70% of it and was
    # the common cause of the top-bar clips on the randomized-level sweeps.
    # The reference entry shipped a dev-sim2real analysis pipeline for
    # exactly this class of plant/firmware mismatch (reference
    # dev-sim2real/README.md); here the trim is estimated ONLINE from the
    # steady-state error and applied to outgoing altitude commands.
    Z_TRIM_INIT = 0.10
    Z_TRIM_RANGE = (0.02, 0.18)

    def _apply_z_trim(self, command, args, pos, vel):
        if command == Command.FULLSTATE:
            des_z = float(args[0][2])
            # Slow online refinement while the vertical axis is quasi-steady.
            if self._z_trim_last_des is not None and abs(vel[2]) < 0.25:
                err = float(pos[2]) - self._z_trim_last_des
                self._z_trim = float(np.clip(
                    self._z_trim + 0.02 * err, *self.Z_TRIM_RANGE
                ))
            self._z_trim_last_des = des_z
            p = np.asarray(args[0], float).copy()
            p[2] = max(des_z - self._z_trim, 0.05)
            args = (p,) + tuple(args[1:])
        elif command == Command.GOTO:
            self._z_trim_last_des = None
            p = np.asarray(args[0], float).copy()
            if not args[3]:  # absolute target
                p[2] = max(p[2] - self._z_trim, 0.05)
            args = (p,) + tuple(args[1:])
        elif command == Command.TAKEOFF:
            # Trim the climb target too: an untrimmed takeoff hovers +10 cm
            # high and the race's first (trimmed) FULLSTATE then commands an
            # instant 0.2 m drop — a vertical kick into the underdamped
            # tracker right at the handoff.
            self._z_trim_last_des = None
            args = (max(float(args[0]) - self._z_trim, 0.1),) + tuple(args[1:])
        else:
            self._z_trim_last_des = None
        return command, args

    # -- simulation-only path (PID, edit_this.py cmdSimOnly) --------------------
    TAKEOFF_SEC = 2.0
    SIM_SPEED_SCALE = 0.5  # base reference speed scale (PID tracking lag)
    GATE_SLOW_SCALE = 0.15  # extra slowdown within GATE_SLOW_RADIUS of a gate
    GATE_SLOW_RADIUS = 0.7

    def cmdSimOnly(self, time_s, obs, reward=None, done=None, info=None):
        obs = np.asarray(obs)
        target_vel = np.zeros(3)
        if self.flight_traj is not None:
            if time_s < self.TAKEOFF_SEC:
                # Climb to the trajectory start before racing.
                target = self.flight_traj.position(self.flight_traj.start_time)[:3]
            else:
                t = min(time_s - self.TAKEOFF_SEC, self.flight_traj.end_time)
                target = self.flight_traj.position(t)[:3]
                target_vel = self.flight_traj.velocity(t)[:3]
        else:
            target = np.array([0.0, 0.0, 1.0])
        # One host-to-device copy of the PID's inputs (a batch of one).
        rows = np.stack([obs[[0, 2, 4]], obs[6:9], obs[[1, 3, 5]],
                         np.asarray(target, float).reshape(3),
                         np.asarray(target_vel, float).reshape(3)]).astype(np.float32)
        pos, rpy, vel, tgt, tgt_v = torch.from_numpy(rows).to(self.device)[:, None].unbind(0)
        rpm, self._pid_state, _, _ = pid_control(
            self._pid_state, self.CTRL_TIMESTEP, pos, rpy, vel, tgt, target_vel=tgt_v)
        return self._clip_forces(rpm[0])

    def _clip_forces(self, rpm):
        forces = rpm.cpu().numpy().astype(np.float64) ** 2 * KF
        if self._act_bounds is not None:
            # Keep the raw command inside the physical input bounds so the
            # f32 PID's rounding noise cannot trip the env's raw-input
            # constraint check (the reference PID computes in f64 and lands
            # exactly on the bound).
            lo, hi = self._act_bounds
            forces = np.clip(forces, lo, hi)
        return forces

    # -- learning hooks (edit_this.py interStepLearn/interEpisodeLearn) ---------
    @timing_step
    def interStepLearn(self, *args, **kwargs):
        self.interstep_counter += 1

    @timing_ep
    def interEpisodeLearn(self, *args, **kwargs):
        self.interepisode_counter += 1
        # Feed the episode outcome + gate sightings to the risk adviser
        # (reference ek_controller_impl.py:132-135) before resetting.
        self.risk_adviser.episode_results(
            self._last_task_completed,
            self.gate_corrector.nominal,
            self.gate_corrector.exact,
        )
        self._last_task_completed = False
        self.gate_corrector.reset()
        self.rate_estimator.reset()
        # Pre-episode risk advice (reference ek_controller_impl.py:113-127):
        # RECKLESS -> re-plan against the gate poses measured in episode 1;
        # CONSERVATIVE -> restore the nominal plan (a previous RECKLESS
        # episode may have swapped it out).
        profile, hint = self.risk_adviser.episode_advice()
        if self._nominal_plan is None:
            self._nominal_plan = (self.trajectory, self.flight_traj,
                                  self.sequencer, self._gate_centers, self._ref_t)
        if hint:
            gates = [hint[k] for k in sorted(hint)]
            self.replan(gates)
            self._plan_is_measured = True
            # The replanned MPCC's nominal frames ARE measured poses; its
            # repulsion band starts tight (corrections blending is off on
            # measured plans, so the stage never sees exact frames again).
            for st in self.sequencer.stages:
                if isinstance(st, StageActionMPCC):
                    st.frames_exact = True
        else:
            (self.trajectory, self.flight_traj, self.sequencer,
             self._gate_centers, self._ref_t) = self._nominal_plan
            self._plan_is_measured = False
            self.sequencer.reset()
        self._pid_state = PIDState.create((1,), device=self.device)

    def reset(self):
        self.sequencer.reset()
        self.rate_estimator.reset()
        self._pid_state = PIDState.create((1,), device=self.device)
