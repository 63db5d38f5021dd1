"""Stage actions and sequencer for the competition flight plan.

The port's copy of ``safe_control_gym_tpu/competition/stage_actions.py``
(NumPy, setpoints equal to the JAX package's bit for bit), the
counterpart of reference competition/stage_sequencer.py (:29-111)
and the stage_action_*.py modules: each stage exposes ``reset()`` and
``run(global_it, stage_it, pos, vel, rpy, pqr) -> (done, Command, args)``;
the sequencer runs stages in order until each reports done.
"""

from __future__ import annotations

import numpy as np

from safe_control_gym_torch.competition.competition_utils import Command


class StageAction:
    def reset(self):
        pass

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        raise NotImplementedError


class StageActionTakeOff(StageAction):
    """Reference stage_action_take_off.py: one TAKEOFF command, wait out the
    duration."""

    def __init__(self, ctrl_freq, height=1.0, duration=2.0):
        self.ctrl_freq = ctrl_freq
        self.height = height
        self.duration = duration

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        if stage_it == 0:
            return False, Command.TAKEOFF, (self.height, self.duration)
        done = stage_it >= self.duration * self.ctrl_freq
        return done, Command.NONE, ()


class StageActionLand(StageAction):
    def __init__(self, ctrl_freq, height=0.05, duration=2.0):
        self.ctrl_freq = ctrl_freq
        self.height = height
        self.duration = duration

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        if stage_it == 0:
            return False, Command.LAND, (self.height, self.duration)
        done = stage_it >= self.duration * self.ctrl_freq
        return done, Command.NONE, ()


class StageActionGotoXY(StageAction):
    def __init__(self, ctrl_freq, x, y, z=None, duration=3.0):
        self.ctrl_freq = ctrl_freq
        self.target = (x, y, z)
        self.duration = duration

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        if stage_it == 0:
            x, y, z = self.target
            z = pos[2] if z is None else z
            return False, Command.GOTO, ([x, y, z], 0.0, self.duration, False)
        done = stage_it >= self.duration * self.ctrl_freq
        return done, Command.NONE, ()


class StageActionSetPointStop(StageAction):
    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        return True, Command.NOTIFYSETPOINTSTOP, ()


class StageActionHardBrake(StageAction):
    """Full-state commands holding the current position (reference
    stage_action_hard_brake.py)."""

    def __init__(self, ctrl_freq, duration=0.5):
        self.ctrl_freq = ctrl_freq
        self.duration = duration
        self.hold = None

    def reset(self):
        self.hold = None

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        if self.hold is None:
            self.hold = np.asarray(pos)
        done = stage_it >= self.duration * self.ctrl_freq
        args = (self.hold, np.zeros(3), np.zeros(3), 0.0, np.zeros(3), global_it / self.ctrl_freq)
        return done, Command.FULLSTATE, args


def _gate_correction_offset(ref_p, corrections, radius=0.8):
    """Shift a reference point by the measured gate pose corrections.

    The env reveals the exact gate pose only once the drone is in range
    (reference ek_controller_impl.py:228-291); the offset is blended in with
    a Gaussian weight centered on each gate so the track deforms locally
    instead of jumping.  Both the NEXT and the PREVIOUS target gate
    contribute: when the target advances mid-crossing, the passed gate's
    correction must persist around its frame — dropping it snapped the
    setpoint ~8 cm at the aperture and clipped the frame edge (level2,
    stock-gain tracking).
    """
    if not corrections:
        return np.zeros(3)
    off = np.zeros(3)
    for which in ("next", "prev"):
        delta = np.asarray(corrections.get(f"{which}_gate_correction", np.zeros(3)))
        if not np.any(delta):
            continue
        gate = np.asarray(corrections.get(f"{which}_gate_location", np.full(3, 99.0)))
        d = np.linalg.norm(np.asarray(ref_p) - gate)
        off = off + delta * np.exp(-0.5 * (d / radius) ** 2)
    return off


class StageActionSpline(StageAction):
    """Track the planned trajectory with FULLSTATE commands (reference
    stage_action_spline.py).  Progress integrates with a gate-adaptive
    speed: crawl through apertures, race between them."""

    def __init__(self, ctrl_freq, trajectory, speed_scale=1.0,
                 gate_centers=None, gate_slow_scale=0.3, gate_slow_radius=0.7,
                 gate_exit_radius=None):
        self.ctrl_freq = ctrl_freq
        self.traj = trajectory
        self.speed_scale = speed_scale
        self.gate_centers = gate_centers or []
        self.gate_slow_scale = gate_slow_scale
        self.gate_slow_radius = gate_slow_radius
        # Asymmetric crawl: approach slowly over gate_slow_radius (shed
        # cross-track error before the aperture), exit over the shorter
        # gate_exit_radius (the frame is behind once crossed) — symmetric
        # wide crawls cost ~2x the course time for no extra safety.
        self.gate_exit_radius = (
            gate_slow_radius * 0.45 if gate_exit_radius is None else gate_exit_radius
        )
        # Plan times at which each gate is crossed (for the signed
        # before/after decision).
        self.gate_times = []
        if self.gate_centers:
            import numpy as _np

            ts = _np.linspace(trajectory.start_time, trajectory.end_time, 400)
            ps = _np.stack([trajectory.position(t).reshape(-1)[:3] for t in ts])
            for g in self.gate_centers:
                d = _np.linalg.norm(ps - _np.asarray(g)[None], axis=-1)
                self.gate_times.append(float(ts[int(d.argmin())]))
        self.reset()

    def reset(self):
        self.ref_t = self.traj.start_time

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        ref_p = self.traj.position(self.ref_t).reshape(-1)[:3]
        scale = self.speed_scale
        if self.gate_centers:
            # Continuous Gaussian blend toward the crawl speed near gates: a
            # hard radius switch steps the commanded velocity by >50%, which
            # rings the position loop through the stock Mellinger attitude
            # damping (KD_OMEGA_RP=200) and cost a gate collision.  The
            # radius is ASYMMETRIC around each gate's crossing time.
            w = 0.0
            for g, tg in zip(self.gate_centers, self.gate_times):
                d = np.linalg.norm(ref_p - g)
                r = self.gate_slow_radius if self.ref_t <= tg else self.gate_exit_radius
                w = max(w, np.exp(-0.5 * (d / max(r, 1e-6)) ** 2))
            scale = self.speed_scale + (self.gate_slow_scale - self.speed_scale) * w
        self.ref_t = min(self.ref_t + scale / self.ctrl_freq, self.traj.end_time)
        done = self.ref_t >= self.traj.end_time
        p = self.traj.position(self.ref_t).reshape(-1)[:3]
        p = p + _gate_correction_offset(p, corrections)
        v = self.traj.velocity(self.ref_t).reshape(-1)[:3] * scale
        args = (p, v, np.zeros(3), 0.0, np.zeros(3), global_it / self.ctrl_freq)
        return done, Command.FULLSTATE, args


class StageActionMPCC(StageAction):
    """Race along the planned path with MPCC, sending a look-ahead state of
    the optimized plan as a FULLSTATE command (reference
    stage_action_mpcc.py).  ``lead`` picks plan step k as the setpoint: the
    one-step state sits millimeters from the drone, which a
    position-dominant tracker ignores (it would hover while the virtual
    progress runs on); ~0.2 s of look-ahead gives it a real error to chase."""

    def __init__(self, ctrl_freq, mpcc, duration=None, lead=5,
                 gate_centers=None, gate_slow_scale=0.45, gate_slow_radius=0.9,
                 floor_rate=0.9, max_ahead=0.45,
                 tether_far=0.60, tether_gate=0.25, track_solution=False,
                 interlock_thresh=0.085, catchup="none"):
        # Defaults from the round-5 level2 seed sweep (fused loop, seeds
        # 0-7): floor_rate 0.9 rides the plan's TOPP profile on open track
        # (theta is time-parameterized, so rate 1.0 = the retimed plan's own
        # speed limits) while the asymmetric gate slowdown still multiplies
        # it on approach; tether 0.60/0.25 bounds the Mellinger chase
        # distance.  This config completed 4/4 gates with zero collisions on
        # every non-spawn-kill seed tested; faster settings (floor 1.0, or
        # slow_scale 0.55/radius 0.8) won ~80 steps but clipped a frame on
        # one seed each — the margin is collision rate, not lap time.
        self.ctrl_freq = ctrl_freq
        self.mpcc = mpcc
        self.theta = 0.0
        self.theta_dot = 0.0
        self.theta_cmd = 0.0
        self.duration = duration
        self.lead = lead
        # Same smooth Gaussian gate-proximity slowdown as the spline stage:
        # the commanded lead/velocity shrink near apertures so the tracker
        # sheds cross-track error before the frame.
        self.gate_centers = gate_centers or []
        self.gate_slow_scale = gate_slow_scale
        self.gate_slow_radius = gate_slow_radius
        # Commanded-progress integrator bounds: the setpoint always advances
        # at >= floor_rate (plan-time units/s) but never runs more than
        # max_ahead ahead of the re-anchored (true) progress.  Without the
        # floor the loop deadlocks: theta_dot collapses near a gate, the
        # commanded point lands millimeters from the drone, the
        # position-dominant Mellinger holds, the re-anchor then pins theta to
        # the unmoving drone — observed as the level2 "conservative stall"
        # (0 gates).  Without the cap the command runs away when the tracker
        # truly cannot follow (the round-1 vertical-runaway failure).
        self.floor_rate = floor_rate
        self.max_ahead = max_ahead
        self.tether_far = tether_far
        self.tether_gate = tether_gate
        self.track_solution = track_solution
        self.interlock_thresh = interlock_thresh
        # Catch-up policy for theta_cmd vs the re-anchored drone progress:
        # "none" (command advances only by integration; an ahead-running
        # drone brakes back onto the profile), "soft" (track within 0.15),
        # or "hard" (snap up — prone to overspeed feedback, kept for study).
        self.catchup = catchup
        # True when the MPCC's nominal frames are already MEASURED poses
        # (risk-adviser replan against episode-1 sightings): the repulsion
        # band then starts tight instead of widened by the pose uncertainty.
        self.frames_exact = False

    def reset(self):
        self.theta = 0.0
        self.theta_dot = 0.0
        self.theta_cmd = 0.0
        # Per-gate crossing state for the center-before-crossing interlock:
        # gate index -> {prev_n, crossed, held}.
        self._gate_state = {}
        # Slow position average for the tether anchor (see run()).
        self._pos_ema = None
        self.mpcc.reset()

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        obs12 = np.concatenate(
            [[pos[0], vel[0], pos[1], vel[1], pos[2], vel[2]], rpy, pqr]
        )
        # Best-known frame poses for the repulsion hinge: measured where the
        # env has revealed them (tight band), nominal + pose-uncertainty
        # standoff otherwise.
        frames = np.array(self.mpcc.frames0, copy=True)
        base_band = self.mpcc.rep_band + (
            0.0 if self.frames_exact else self.mpcc.fuzzy_extra
        )
        bands = np.full(frames.shape[0], base_band, np.float32)
        if corrections and frames.shape[0]:
            for gid, f in (corrections.get("gate_exact_frames") or {}).items():
                if 0 <= int(gid) < frames.shape[0]:
                    frames[int(gid)] = f
                    bands[int(gid)] = self.mpcc.rep_band
        x_next, xs, self.theta, self.theta_dot = self.mpcc.solve(
            obs12, self.theta, self.theta_dot, frames=frames, bands=bands
        )
        # Clamp the carried virtual progress speed: warm-started solutions
        # can ratchet it past the soft bound when tracking lags.
        self.theta_dot = float(
            np.clip(self.theta_dot, 0.0, self.mpcc.params["theta_dot_max"])
        )
        if self.track_solution:
            # Track the OPTIMIZED trajectory directly (the reference's
            # stage_action_mpcc.py sends the solver state as the FULLSTATE
            # command).  CAUTION — kept as an opt-in: the reference can
            # afford this because CasADi/IPOPT converges each solve; with
            # the fixed-iteration AL-iLQR an under-converged warm-shifted
            # solution closes a positive feedback loop (commanded speed ->
            # faster start state -> faster solution; observed running away
            # to 8.8 m/s into the ground on level2).  The default path
            # tracks the geometric plan with MPCC pacing instead.
            k = int(np.clip(self.lead, 1, xs.shape[0] - 1))
            xk = np.asarray(xs[k])
            p = xk[[0, 2, 4]]
            v = xk[[1, 3, 5]]
            p = p + _gate_correction_offset(p, corrections)
            # Arrive at rest: taper the feedforward at the plan end (the
            # level2 goal sits 10 cm from the |y|<=3 kill boundary).
            d_end = float(np.linalg.norm(
                np.asarray(self.mpcc.path_pos[-1]) - pos
            ))
            v = v * min(1.0, max(0.0, d_end / 0.8))
            speed = float(np.linalg.norm(v))
            if speed > 2.0:
                v = v * (2.0 / speed)
            done = self.theta >= self.mpcc.theta_max - 1e-3
            args = (p, v, np.zeros(3), 0.0, np.zeros(3),
                    global_it / self.ctrl_freq)
            return done, Command.FULLSTATE, args
        # Command the planned PATH at the optimizer's progress + chosen speed
        # rather than the raw iLQR state: the geometric plan is collision-free
        # by construction, while an under-converged plan state can cut gate
        # frames; MPCC still contributes the speed profile (theta/theta_dot).
        # Asymmetric gate slowdown: long approach, short exit.  Keeping the
        # symmetric slow zone after the plane parks the command at ~0.2 m/s
        # while the drone crosses at race speed — the overshoot then swings
        # back through the plane into the frame (the seed-2/5 post-crossing
        # collisions).  Once a gate is CROSSED its slow radius collapses so
        # the command accelerates away with the drone's momentum.
        slow = 1.0
        if self.gate_centers:
            ref_p, _ = self.mpcc.reference_at(self.theta, self.theta_dot)
            w_max = 0.0
            for jg, g in enumerate(self.gate_centers):
                crossed = self._gate_state.get(jg, {}).get("crossed", False)
                radius = 0.25 if crossed else self.gate_slow_radius
                dg_ref = np.linalg.norm(ref_p - g)
                w_max = max(
                    w_max, np.exp(-0.5 * (dg_ref / max(radius, 1e-6)) ** 2)
                )
            slow = 1.0 + (self.gate_slow_scale - 1.0) * w_max
        # Center-before-crossing interlock: braking with the Mellinger
        # pitches the quad and converts speed into ALTITUDE (observed +14 cm
        # at a low gate on level2 seed 5 — straight into the top bar).
        # While the drone is on the approach side of an uncrossed gate but
        # off the aperture axis, CAP the commanded progress at the gate's
        # crossing theta: the command parks at the aperture center (a safe
        # attractor even for a drone gliding through on momentum — freezing
        # it short of the plane instead left the command BEHIND the gliding
        # drone, which braked it into a swing back through the frame).  The
        # cap lifts once centered, once crossed, or after 2 s so a
        # persistent disturbance cannot deadlock the race.
        theta_cap = None
        if frames.shape[0]:
            centers = np.stack(
                [frames[:, 0], frames[:, 1], frames[:, 3]], axis=1
            )
            dists = np.linalg.norm(centers - pos, axis=1)
            j = int(dists.argmin())
            if dists[j] < 0.9:
                f = frames[j]
                rel = pos[:2] - f[:2]
                cy, sy = np.cos(f[2]), np.sin(f[2])
                u_g = rel[0] * cy + rel[1] * sy
                n_g = -rel[0] * sy + rel[1] * cy
                w_g = pos[2] - f[3]
                st = self._gate_state.setdefault(
                    j, {"prev_n": None, "first_n": n_g, "crossed": False,
                        "held": 0, "engaged": False}
                )
                if (st["prev_n"] is not None
                        and np.sign(n_g) != np.sign(st["prev_n"])
                        and abs(n_g) < 0.3):
                    st["crossed"] = True
                st["prev_n"] = n_g
                off_axis = max(abs(u_g), abs(w_g))
                # Hysteresis: engage above thresh, release only 4 cm below
                # it — toggling the cap at the tracker's swing frequency
                # would otherwise pump the oscillation it exists to absorb.
                if st["engaged"]:
                    st["engaged"] = off_axis > self.interlock_thresh - 0.04
                else:
                    st["engaged"] = off_axis > self.interlock_thresh
                gate_thetas = np.asarray(self.mpcc.gate_thetas)
                if (not st["crossed"]
                        and np.sign(n_g) == np.sign(st["first_n"])
                        and st["engaged"]
                        and st["held"] < 2.0 * self.ctrl_freq
                        and j < gate_thetas.shape[0]):
                    theta_cap = float(gate_thetas[j])
                    st["held"] += 1
        # Persistent command-progress: MPCC sets the pace (theta_dot), the
        # floor guarantees motion, the cap keeps the setpoint tethered to the
        # drone's actual progress.
        # Floor BEFORE the gate slowdown: the floor guarantees open-track
        # pace (the theta profile is already TOPP-retimed, so rate 1.0 rides
        # the plan's own speed limits), while the asymmetric gate slowdown
        # must keep braking the approach — flooring the slowed rate instead
        # disabled gate braking whenever theta_dot*slow < floor and put the
        # drone through frames at open-track pace (level2 seeds 1/4/6).
        rate = max(self.theta_dot, self.floor_rate) * slow
        # Soft start: ramp the command pace over the first ~1.5 s of the
        # race.  The takeoff->race handoff otherwise kicks the underdamped
        # stock-gain Mellinger (kd_xy << critical) into a +-0.35 m lateral
        # pendulum that persists to the first gate (observed on level2
        # seed 5, whose first leg is only 1.4 m).
        # Ramp floor 0.4: the very first commands must still pull the drone
        # off the spawn (level2 spawns can sit ~1 cm from the kill boundary
        # — hovering there while the ramp rises loses the boundary roulette).
        rate *= min(1.0, max(0.4, (stage_it + 1) / (1.5 * self.ctrl_freq)))
        # Catch-up policy (see __init__): hard catch-up to the re-anchored
        # drone progress creates positive feedback (drone overspeed ->
        # anchor jumps -> command jumps -> more feedforward; observed
        # 1.9 m/s into a gate on level2 seed 5); with "none" the command
        # advances only by its own integration — a drone running ahead sees
        # a BEHIND setpoint on the path and brakes back onto the speed
        # profile; the floor keeps the command moving if the drone stalls.
        if self.catchup == "hard":
            self.theta_cmd = max(self.theta_cmd, self.theta)
        elif self.catchup == "soft":
            self.theta_cmd = max(self.theta_cmd, self.theta - 0.15)
        elif self.catchup == "capped":
            # Follow the re-anchored drone progress at no more than 2x the
            # commanded rate: legit overspeed is tracked, but the jump
            # feedback is bounded by the OPTIMIZER's pace, not the drone's.
            self.theta_cmd = max(
                self.theta_cmd,
                min(self.theta, self.theta_cmd + 2.0 * rate / self.ctrl_freq),
            )
        self.theta_cmd = min(
            self.theta_cmd + rate / self.ctrl_freq,
            self.theta + self.max_ahead,
            self.mpcc.theta_max,
        )
        if theta_cap is not None and theta_cap >= self.theta:
            self.theta_cmd = min(self.theta_cmd, theta_cap)
        theta_lead = min(
            self.theta_cmd + self.lead / self.ctrl_freq * rate,
            self.mpcc.theta_max,
        )
        if theta_cap is not None and theta_cap >= self.theta:
            theta_lead = min(theta_lead, theta_cap)
        p, v = self.mpcc.reference_at(theta_lead, rate)
        p = p + _gate_correction_offset(p, corrections)
        # Spatial tether: cap the setpoint's DISTANCE from the drone.  The
        # plan-time cap (max_ahead) alone let the commanded point run ~0.5 m
        # ahead; the position-dominant Mellinger then chases at well over the
        # plan's speed profile and arrives hot at the gate — when the pace
        # drops at the crossing, the overshoot swings back through the gate
        # plane into the frame (diagnosed on level2 seed 2: crossed at
        # 1.4 m/s vs the plan's 0.6, clipped the frame on the return swing
        # at 5 mm margin).  Tether short near gates, longer between them.
        tether = self.tether_far
        if self.gate_centers:
            dg = min(np.linalg.norm(pos - g) for g in self.gate_centers)
            wg = np.exp(-0.5 * (dg / max(self.gate_slow_radius, 1e-6)) ** 2)
            tether = self.tether_far + (self.tether_gate - self.tether_far) * wg
        # Taper toward the end of the plan: chasing the STATIONARY final
        # point from a full tether away arrives at ~1.5 m/s and coasts past
        # the goal (level2's goal sits 10 cm from the |y|<=3 kill boundary).
        d_end = float(np.linalg.norm(
            np.asarray(self.mpcc.path_pos[-1]) - pos
        ))
        tether = min(tether, max(0.10, 0.5 * d_end))
        # Clip only the ALONG-TRACK component of the setpoint error: a
        # radial clip (p = pos + err*tether/d) turns the attractor into a
        # follower — with the drone 16 cm high at a gate, the clipped
        # setpoint's z tracked the drone and the error never shed.  Pulling
        # the command back along the path tangent caps the chase speed while
        # keeping the full cross-track centering pull.  The tether anchors
        # The clipped point is then floored to be MONOTONIC along-track: a
        # tether that follows the drone backward makes the attractor slosh
        # in phase with the underdamped Mellinger's swing (backward swing
        # drags the command back, forward swing re-releases it), pumping the
        # oscillation until it exits the arena (observed growing
        # +-0.35 -> +-0.8 m on seed 5).
        err = p - pos
        t_hat = self.mpcc.tangent_at(theta_lead)
        along = float(err @ t_hat)
        ff_scale = 1.0
        if along > tether:
            p = p - t_hat * (along - tether)
            ff_scale = tether / along
        if self._pos_ema is not None:
            back = float((p - self._pos_ema) @ t_hat)
            if back < 0.0:
                p = p - t_hat * back
        self._pos_ema = np.asarray(p, float).copy()
        # The Mellinger follows the velocity feedforward even when the
        # position error is small, so clipping the setpoint alone does not
        # slow the vehicle: scale the feedforward with the tether clip and
        # taper it to zero at the plan end (arrive at rest — the TOPP
        # profile's final leg otherwise carries ~1.5 m/s into the goal).
        v = v * min(ff_scale, max(0.0, d_end / 0.8))
        # Velocity feedforward bounded to what the tracker can realize.
        speed = float(np.linalg.norm(v))
        if speed > 2.0:
            v = v * (2.0 / speed)
        done = self.theta >= self.mpcc.theta_max - 1e-3
        args = (p, v, np.zeros(3), 0.0, np.zeros(3), global_it / self.ctrl_freq)
        return done, Command.FULLSTATE, args


class StageActionNone(StageAction):
    def __init__(self, steps=1):
        self.steps = steps

    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        return stage_it >= self.steps - 1, Command.NONE, ()


class StageActionFinished(StageAction):
    def run(self, global_it, stage_it, pos, vel, rpy, pqr, corrections=None):
        return False, Command.FINISHED, ()


class StageSequencer:
    """Run stages in order (reference stage_sequencer.py:29-111)."""

    def __init__(self, stages):
        self.stages = list(stages)
        self.reset()

    def reset(self):
        self.idx = 0
        self.stage_it = 0
        for s in self.stages:
            s.reset()

    def run(self, global_it, pos, vel, rpy, pqr, corrections=None):
        if self.idx >= len(self.stages):
            return Command.FINISHED, ()
        stage = self.stages[self.idx]
        done, command, args = stage.run(
            global_it, self.stage_it, pos, vel, rpy, pqr, corrections=corrections
        )
        self.stage_it += 1
        if done:
            self.idx += 1
            self.stage_it = 0
        return command, args
