"""Crazyflie firmware software-in-the-loop emulator.

Port of ``safe_control_gym_tpu/controllers/firmware.py`` (the counterpart of
the reference's FirmwareWrapper, safe_control_gym/controllers/firmware/
firmware_wrapper.py, which drives the SWIG-wrapped C firmware at 500 Hz
inside ``step()``).  The firmware pieces are reimplemented:

  * Mellinger controller math + power distribution —
    ``controllers/mellinger.py``;
  * 2-pole Butterworth LPFs on gyro/acc at 80/30 Hz
    (firmware_wrapper.py:133-138, lpf2pInit/lpf2pApply semantics);
  * finite-difference sensor emulation (rates and acc from consecutive env
    states, firmware_wrapper.py:245-268);
  * the high-level command queue: sendFullStateCmd / sendTakeoffCmd /
    sendLandCmd / sendGotoCmd / sendStopCmd / sendNotifySetpointStopCmd
    (firmware_wrapper.py:483-663), with 7th-order no-jerk setpoint
    polynomials (the firmware planner's ``poly7_nojerk``);
  * tick-gated controller cadence and tumble-detection motor kill
    (firmware_wrapper.py:413-466);
  * motor-order remap of the produced action ([3, 2, 1, 0],
    firmware_wrapper.py:277-278).

The wrapped env is the port's batched quadrotor at one env (B = 1) on its
device, so each 500 Hz tick steps the general engine once: K1
(``ops/quad_substeps.py``) once a tick.  Two loops run the ticks of one
control step:

  * the host loop (``fused=False``), the oracle: the env steps on the
    device, the sensors, filters (Python floats) and setpoints run on the
    host, the Mellinger tick on the device;
  * the fused block (``fused=True``, what ``getting_started.run`` uses): the
    carry (env state, Mellinger state, filter taps, delay lines, tumble
    counter) stays on the device.  One host-to-device copy brings the
    block's per-tick inputs (the cadence gate and the setpoints, computed in
    float64 on the host as the host loop computes them, then rounded to
    float32; ``_block_inputs``, from pinned memory on CUDA, so the copy is
    asynchronous), the ticks run as device work with nothing read back
    (``_launch_block``), and one device-to-host read takes the packed output
    vector (``_read_block``).  The JAX package's two ``lax.cond`` become
    ``torch.where``: a done freezes every later tick of the block, and the
    Mellinger tick runs under ``run_ctrl & ~error``, the gated-off branch
    keeping the old PWMs and the old Mellinger state, integrals included.

The command API, the gating and the planner stay on the host in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from safe_control_gym_torch.controllers.mellinger import (KD_OMEGA_RP, MellingerState,
                                                          mellinger_control, power_distribution)
from safe_control_gym_torch.envs.benchmark import where_state
from safe_control_gym_torch.envs.gates import gate_frame_margin, obstacle_margin
from safe_control_gym_torch.envs.quadrotor import (KF, MAX_PWM, MIN_PWM, PWM2RPM_CONST,
                                                   PWM2RPM_SCALE)
from safe_control_gym_torch.ops.ctr_prng import key_env_seed
from safe_control_gym_torch.ops.quad_substeps import div

REMAP = [3, 2, 1, 0]  # firmware motor numbering -> env motor numbering


class Lpf2p:
    """2-pole Butterworth low-pass (firmware filter.c lpf2p)."""

    def __init__(self, sample_freq: float, cutoff_freq: float):
        fr = sample_freq / cutoff_freq
        ohm = math.tan(math.pi / fr)
        c = 1.0 + 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm
        self.b0 = ohm * ohm / c
        self.b1 = 2.0 * self.b0
        self.b2 = self.b0
        self.a1 = 2.0 * (ohm * ohm - 1.0) / c
        self.a2 = (1.0 - 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm) / c
        self.d1 = 0.0
        self.d2 = 0.0

    def apply(self, sample: float) -> float:
        d0 = sample - self.d1 * self.a1 - self.d2 * self.a2
        out = d0 * self.b0 + self.d1 * self.b1 + self.d2 * self.b2
        self.d2, self.d1 = self.d1, d0
        return out


def _poly7_nojerk(T, x0, dx0, ddx0, xf, dxf, ddxf):
    """7th-order polynomial coefficients (ascending), matching the firmware
    planner's ``poly7_nojerk`` (crazyflie-firmware pptraj.c): p(0)=x0,
    p'(0)=dx0, p''(0)=ddx0, p'''(0)=0 and the same at T with (xf, dxf, ddxf,
    0), solved as the 8x8 linear system."""
    T = max(float(T), 1e-6)
    A = np.zeros((8, 8))
    A[0, 0] = 1.0
    A[1, 1] = 1.0
    A[2, 2] = 2.0
    A[3, 3] = 6.0
    powers = T ** np.arange(8, dtype=float)
    k = np.arange(8, dtype=float)
    A[4] = powers  # p(T)
    A[5, 1:] = k[1:] * powers[:-1]  # p'(T)
    A[6, 2:] = k[2:] * (k[2:] - 1) * powers[:-2]  # p''(T)
    A[7, 3:] = k[3:] * (k[3:] - 1) * (k[3:] - 2) * powers[:-3]  # p'''(T)
    b = np.array([x0, dx0, ddx0, 0.0, xf, dxf, ddxf, 0.0])
    return np.linalg.solve(A, b)


def _poly_eval(c, t):
    """(pos, vel, acc) of an ascending-coefficient polynomial at t."""
    k = np.arange(len(c), dtype=float)
    tp = t ** k
    pos = float(np.dot(c, tp))
    vel = float(np.dot(c[1:] * k[1:], tp[:-1]))
    acc = float(np.dot(c[2:] * k[2:] * (k[2:] - 1), tp[:-2]))
    return pos, vel, acc


def _select(mask, a, b):
    """``where(mask, a, b)`` over a carry: tensors, dicts, env states and
    Mellinger states (a (1,) bool mask)."""
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
    if isinstance(a, MellingerState):
        return MellingerState(*(_select(mask, x, y) for x, y in zip(
            (a.i_error_pos, a.i_error_m, a.prev_omega_rp, a.prev_setpoint_omega_rp),
            (b.i_error_pos, b.i_error_m, b.prev_omega_rp, b.prev_setpoint_omega_rp))))
    if not torch.is_tensor(a):
        return where_state(mask, a, b)
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


class FirmwareWrapper:
    """Reference-compatible SITL wrapper (reset/step + send*Cmd API) around
    one env of the port's 3D quadrotor."""

    # Configurable hardware-response delays (reference firmware_wrapper.py:14-16,
    # 129-131): firmware loops between commanding an action and the motors
    # responding (ACTION_DELAY), and between a motion and the sensors
    # registering it (SENSOR_DELAY).  STATE_DELAY is unsupported upstream too.
    ACTION_DELAY = 0
    SENSOR_DELAY = 0
    STATE_DELAY = 0
    GYRO_LPF_CUTOFF_FREQ = 80.0
    ACCEL_LPF_CUTOFF_FREQ = 30.0

    def __init__(self, env_func, firmware_freq: int = 500, ctrl_freq: int = 25,
                 verbose=False, action_delay: int = None, sensor_delay: int = None,
                 fused: bool = False, kd_omega_rp: float = None, **kwargs):
        if action_delay is not None:
            self.ACTION_DELAY = int(action_delay)
        if sensor_delay is not None:
            self.SENSOR_DELAY = int(sensor_delay)
        if self.STATE_DELAY:
            raise NotImplementedError("State delay is not implemented. Leave at 0.")
        self.env = env_func() if callable(env_func) else env_func
        if self.env.ctrl_freq != firmware_freq:
            raise ValueError(
                "the wrapped env must run at the firmware frequency (the reference rewrites "
                "ctrl_freq to 500 Hz, getting_started.py:69-83)")
        self.device = self.env.device
        self.firmware_freq = firmware_freq
        self.ctrl_freq = ctrl_freq
        self.firmware_dt = 1.0 / firmware_freq
        self.ctrl_dt = 1.0 / ctrl_freq
        self.verbose = verbose
        # The fused block runs the ticks of a control step with the carry on
        # the device: one copy in, one read out (module docstring).
        self.fused = bool(fused)
        # Stock attitude-rate-derivative gain unless overridden: the SITL's
        # finite-difference gyro makes the stock value destabilizing (see
        # mellinger.py); the competition loop passes 0.
        self.kd_omega_rp = KD_OMEGA_RP if kd_omega_rp is None else float(kd_omega_rp)
        self._a_low = np.asarray(self.env.spaces.action_low, np.float32)
        self._a_high = np.asarray(self.env.spaces.action_high, np.float32)
        self._n_gates = len(getattr(self.env.config, "gates", None) or [])
        self._n_obst = len(getattr(self.env.config, "obstacles", None) or [])
        self._info_spec = None  # (key, shape, dtype) of each info entry, from a block's first tick

    # -- lifecycle -------------------------------------------------------------
    def reset(self, seed: int = 0):
        """A fresh episode of the course of ``seed``: the env seed the JAX
        package draws from ``jax.random.key(seed)`` (``ctr_prng.key_env_seed``)."""
        self.ms = MellingerState.create((1,), device=self.device)
        self.tick = 0
        self.pwms = np.zeros(4)
        self.action = np.zeros(4)
        self.command_queue: list = []
        self.tumble_counter = 0
        self._error = False
        # Delay ring buffers (firmware_wrapper.py:129-131).
        self.action_history = [np.zeros(4) for _ in range(self.ACTION_DELAY)]
        self.sensor_history = [[np.zeros(3), np.zeros(3)] for _ in range(self.SENSOR_DELAY)]
        self.full_state_cmd_override = True  # until a HL command is sent
        self.setpoint = {"pos": np.zeros(3), "vel": np.zeros(3), "acc": np.zeros(3),
                         "yaw": 0.0, "omega": np.zeros(3)}
        self._plan = None  # (kind, t0, duration, coeffs, yaw_coeffs)
        # The reference initializes acclpf with GYRO_LPF_CUTOFF_FREQ and
        # gyrolpf with ACCEL_LPF_CUTOFF_FREQ — the cutoffs are swapped
        # relative to their names (firmware_wrapper.py:137-138).  The swap is
        # load-bearing: the 30 Hz gyro LPF is what keeps the stock
        # KD_OMEGA_RP=200 derivative term stable.  Reproduced exactly.
        self.acclpf = [Lpf2p(self.firmware_freq, self.GYRO_LPF_CUTOFF_FREQ) for _ in range(3)]
        self.gyrolpf = [Lpf2p(self.firmware_freq, self.ACCEL_LPF_CUTOFF_FREQ) for _ in range(3)]
        self.last_pos_pid_call = 0.0
        self.last_att_pid_call = 0.0
        seeds = torch.full((1,), key_env_seed(seed), dtype=torch.int32, device=self.device)
        self.env_state, obs_t, info_t = self.env.reset(seeds)
        obs = obs_t[0].cpu().numpy()
        info = {k: v[0].cpu().numpy() for k, v in info_t.items()}
        self.prev_vel = np.array([obs[1], obs[3], obs[5]])
        self.prev_rpy = np.array([obs[6], obs[7], obs[8]])
        self.setpoint["pos"] = np.array([obs[0], obs[2], obs[4]])
        if self.fused:
            f32, dev = torch.float32, self.device
            z = lambda *s: torch.zeros(1, *s, dtype=f32, device=dev)  # noqa: E731
            self._carry = dict(
                env_state=self.env_state, obs=obs_t.to(f32), ms=self.ms,
                gd1=z(3), gd2=z(3), ad1=z(3), ad2=z(3),
                prev_vel=torch.from_numpy(self.prev_vel.astype(np.float32))[None].to(dev),
                prev_rpy=torch.from_numpy(self.prev_rpy.astype(np.float32))[None].to(dev),
                tumble=torch.zeros(1, dtype=torch.int32, device=dev),
                ahist=z(self.ACTION_DELAY, 4), shist=z(self.SENSOR_DELAY, 2, 3))
            self._lpf_coef = {
                name: tuple(float(np.float32(c)) for c in (f.b0, f.b1, f.b2, f.a1, f.a2))
                for name, f in (("gyro", self.gyrolpf[0]), ("acc", self.acclpf[0]))}
            self._bounds = (torch.from_numpy(self._a_low).to(dev),
                            torch.from_numpy(self._a_high).to(dev))
            self.block_clearance = None
        return obs, info

    # -- fused tick block ----------------------------------------------------------
    def _pack_info(self, info):
        """The env step's info dict as one float32 vector (1, n), keys in
        sorted order; records their shapes and dtypes for the host's unpack."""
        keys = sorted(info)
        if self._info_spec is None:
            self._info_spec = [(k, tuple(info[k].shape[1:]), info[k].dtype) for k in keys]
        if not keys:
            return torch.zeros(1, 0, dtype=torch.float32, device=self.device)
        return torch.cat([info[k].reshape(1, -1).to(torch.float32) for k in keys], -1)

    def _tick(self, c, run_ctrl, sp):
        """One live firmware tick of the fused block on the carry ``c``
        (tensors with a leading batch of one); ``run_ctrl`` (1,) bool, ``sp``
        the tick's setpoint rows (pos, vel, acc, yaw, omega)."""
        fdt = self.firmware_dt
        es, obs, r, d, info = self.env.step(c["env_state"], c["action"])
        obs = obs.to(torch.float32)
        cur_pos, cur_vel, cur_rpy = obs[:, 0:5:2], obs[:, 1:6:2], obs[:, 6:9]
        # Finite-difference sensors (firmware_wrapper.py:248-268).
        rates = div(cur_rpy - c["prev_rpy"], fdt)
        acc = div(div(cur_vel - c["prev_vel"], fdt), 9.8)
        acc = torch.cat([acc[:, :2], acc[:, 2:] + 1.0], -1)
        if self.SENSOR_DELAY:
            acc_meas, rates_meas = c["shist"][:, 0, 0], c["shist"][:, 0, 1]
            shist = torch.cat([c["shist"][:, 1:], torch.stack([acc, rates], 1)[:, None]], 1)
        else:
            acc_meas, rates_meas, shist = acc, rates, c["shist"]
        # 2-pole LPFs; per the reference, the gyro bank carries the ACCEL
        # cutoff and vice versa (firmware_wrapper.py:137-138).
        gb0, gb1, gb2, ga1, ga2 = self._lpf_coef["gyro"]
        ab0, ab1, ab2, aa1, aa2 = self._lpf_coef["acc"]
        gd0 = rates_meas - c["gd1"] * ga1 - c["gd2"] * ga2
        gyro = gd0 * gb0 + c["gd1"] * gb1 + c["gd2"] * gb2
        ad0 = acc_meas - c["ad1"] * aa1 - c["ad2"] * aa2
        # Tumble kill on the raw world acc (firmware_wrapper.py:421-431).
        tumble = torch.where(acc[:, 2] < -0.5, c["tumble"] + 1, torch.zeros_like(c["tumble"]))
        killed = tumble >= 30
        error = c["error"] | killed
        pwms = torch.where(killed[:, None], torch.zeros_like(c["pwms"]), c["pwms"])
        # The Mellinger tick under run_ctrl & ~error: the gated-off branch
        # keeps the old PWMs and the old Mellinger state, integrals included.
        control, ms_new = mellinger_control(
            c["ms"], fdt, cur_pos, cur_vel, cur_rpy, gyro, sp[0], sp[1], sp[2], sp[3], sp[4],
            kd_omega_rp=self.kd_omega_rp)
        gate = run_ctrl & ~error
        pwms = torch.where(gate[:, None], power_distribution(control), pwms)
        ms = _select(gate, ms_new, c["ms"])
        rpm = PWM2RPM_SCALE * torch.clamp(pwms, MIN_PWM, MAX_PWM) + PWM2RPM_CONST
        new_action = (KF * rpm**2).flip(-1)  # REMAP, without a list index's copy
        new_action = torch.minimum(torch.maximum(new_action, self._bounds[0]), self._bounds[1])
        if self.ACTION_DELAY:
            ahist = torch.cat([c["ahist"][:, 1:], new_action[:, None]], 1)
            new_action = c["ahist"][:, 0]
        else:
            ahist = c["ahist"]
        new_action = torch.where(error[:, None], torch.zeros_like(new_action), new_action)
        true_pos = es.x[:, 0:5:2]
        gate_m, obst_m = c["gate_m"], c["obst_m"]
        if self._n_gates:
            ge = es.gates_eff
            gate_m = torch.minimum(gate_m, gate_frame_margin(true_pos, ge[..., :2], ge[..., 2],
                                                             ge[..., 3]))
        if self._n_obst:
            obst_m = torch.minimum(obst_m, obstacle_margin(true_pos, es.obstacles_eff))
        return dict(
            env_state=es, obs=obs, gate_m=gate_m, obst_m=obst_m, action=new_action, ms=ms,
            gd1=gd0, gd2=c["gd1"], ad1=ad0, ad2=c["ad1"], prev_vel=cur_vel, prev_rpy=cur_rpy,
            tumble=tumble, pwms=pwms, ahist=ahist, shist=shist, error=error, done=d | error,
            reward=r.to(torch.float32), executed=c["executed"] + 1,
            info_vec=self._pack_info(info))

    def _block_inputs(self, run_ctrl, sp_seq, action):
        """The block's host inputs as one float32 tensor on the device: the
        per-tick cadence gate and setpoints (n, 14), then the action, the
        PWMs and the error flag; one host-to-device copy, from pinned memory
        on CUDA so that it does not synchronize."""
        n = len(run_ctrl)
        rows = np.concatenate([run_ctrl[:, None].astype(np.float64), sp_seq["pos"],
                               sp_seq["vel"], sp_seq["acc"], sp_seq["yaw"][:, None],
                               sp_seq["omega"]], 1).reshape(-1)
        flat = np.concatenate([rows, np.asarray(action, np.float64).reshape(4),
                               np.asarray(self.pwms, np.float64).reshape(4),
                               [float(self._error)]]).astype(np.float32)
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._pinned = host  # alive until the block's read
        dev = host.to(self.device, non_blocking=True)
        return dev[:n * 14].reshape(n, 14), dev[n * 14:]

    def _launch_block(self, xs, tail):
        """Enqueue the ticks of one control step on the device from its
        inputs (``_block_inputs``): the packed output vector (1, len),
        nothing read back."""
        f32 = torch.float32
        c = dict(self._carry, action=tail[None, 0:4], pwms=tail[None, 4:8],
                 error=tail[8:9] > 0.5,
                 done=torch.zeros(1, dtype=torch.bool, device=self.device),
                 executed=torch.zeros(1, dtype=torch.int32, device=self.device),
                 gate_m=torch.full((1, self._n_gates), math.inf, dtype=f32, device=self.device),
                 obst_m=torch.full((1, self._n_obst), math.inf, dtype=f32, device=self.device))
        for j in range(xs.shape[0]):
            x = xs[j:j + 1]
            sp = (x[:, 1:4], x[:, 4:7], x[:, 7:10], x[:, 10], x[:, 11:14])
            live = self._tick(c, x[:, 0] > 0.5, sp)
            # A done freezes every later tick (the first tick always runs:
            # done starts False).
            c = live if j == 0 else _select(c["done"], {k: c[k] for k in live}, live)
        self._carry = {k: c[k] for k in ("env_state", "obs", "ms", "gd1", "gd2", "ad1", "ad2",
                                         "prev_vel", "prev_rpy", "tumble", "ahist", "shist")}
        return torch.cat([c["obs"], c["action"], c["pwms"],
                          torch.stack([c["reward"], c["done"].to(f32), c["error"].to(f32),
                                       c["executed"].to(f32)], -1),
                          c["info_vec"], c["gate_m"], c["obst_m"]], -1)

    def _unpack_info(self, vec):
        """The info vector -> a host dict with the env's shapes and dtypes."""
        out, i = {}, 0
        for k, shape, dtype in self._info_spec:
            n = int(np.prod(shape))
            chunk = vec[i:i + n].reshape(shape)
            if dtype == torch.bool:
                chunk = chunk > 0.5
            elif not dtype.is_floating_point:
                chunk = np.round(chunk).astype(np.int32)
            out[k] = chunk[()] if shape == () else chunk
            i += n
        return out

    def _setpoints_for(self, ticks):
        """Per-tick setpoint arrays, float64 host math identical to
        _update_setpoint (the plan is fixed for the duration of one control
        step: the command queue pops at most one command per step call)."""
        n = len(ticks)
        if self.full_state_cmd_override or self._plan is None:
            sp = self.setpoint
            return dict(
                pos=np.tile(np.asarray(sp["pos"], float), (n, 1)),
                vel=np.tile(np.asarray(sp["vel"], float), (n, 1)),
                acc=np.tile(np.asarray(sp["acc"], float), (n, 1)),
                yaw=np.full(n, float(sp["yaw"])),
                omega=np.tile(np.asarray(sp["omega"], float), (n, 1)),
            ), False
        kind, t0, duration, coeffs, yaw_c = self._plan
        pos = np.zeros((n, 3))
        vel = np.zeros((n, 3))
        acc = np.zeros((n, 3))
        yaw = np.zeros(n)
        om = np.zeros((n, 3))
        for j, k in enumerate(ticks):
            t = k / self.firmware_freq
            tau = float(np.clip(t - t0, 0.0, duration))
            pva = np.array([_poly_eval(coeffs[i], tau) for i in range(3)])
            yw, yr, _ = _poly_eval(yaw_c, tau)
            if t - t0 >= duration:
                pva[:, 1:] = 0.0
                yr = 0.0
            pos[j], vel[j], acc[j] = pva[:, 0], pva[:, 1], pva[:, 2]
            yaw[j] = yw
            om[j] = [0.0, 0.0, yr]
        return dict(pos=pos, vel=vel, acc=acc, yaw=yaw, omega=om), True

    def _plan_block(self, sim_time: float):
        """The host side of a fused control step before its launch: the
        command popped, the ticks (the host while-condition in float64), their
        cadence gate and setpoints.  Returns (ticks, run_ctrl, gate states
        after each tick, setpoints, plan active)."""
        self._process_command_queue(sim_time)
        ticks = []
        k = self.tick
        while k / self.firmware_freq < sim_time + self.ctrl_dt:
            ticks.append(k)
            k += 1
        # Controller cadence gating, exact float64 host semantics
        # (firmware_wrapper.py:433-446).
        run_ctrl = np.zeros(len(ticks), bool)
        la, lp = self.last_att_pid_call, self.last_pos_pid_call
        gate_after = []
        for j, kk in enumerate(ticks):
            ct = kk / self.firmware_freq
            if ct - la > 0.002:
                run_ctrl[j] = True
                la = ct
                if ct - lp > 0.01:
                    lp = ct
            gate_after.append((la, lp))
        sp_seq, plan_active = self._setpoints_for(ticks)
        return ticks, run_ctrl, gate_after, sp_seq, plan_active

    def _read_block(self, out_vec, gate_after, sp_seq, plan_active):
        """The one device-to-host read of a fused control step, and the host
        state it updates."""
        out = out_vec[0].cpu().numpy()
        ol = 12
        obs = out[:ol]
        action_out = out[ol:ol + 4].astype(np.float64)
        self.pwms = out[ol + 4:ol + 8].astype(np.float64)
        reward = float(out[ol + 8])
        done = bool(out[ol + 9] > 0.5)
        self._error = bool(out[ol + 10] > 0.5)
        executed = int(round(out[ol + 11]))
        tail = out[ol + 12:]
        n_info = sum(int(np.prod(s)) for _, s, _ in self._info_spec)
        info = self._unpack_info(tail[:n_info])
        # Tick-rate clearance minima over this control block (diagnostics).
        self.block_clearance = {"gates": tail[n_info:n_info + self._n_gates].copy(),
                                "obstacles": tail[n_info + self._n_gates:].copy()}
        self.tick += executed
        self.last_att_pid_call, self.last_pos_pid_call = gate_after[executed - 1]
        if plan_active:
            j = executed - 1
            self.setpoint = {"pos": sp_seq["pos"][j], "vel": sp_seq["vel"][j],
                             "acc": sp_seq["acc"][j], "yaw": float(sp_seq["yaw"][j]),
                             "omega": sp_seq["omega"][j]}
        self.action = action_out
        self.env_state = self._carry["env_state"]
        self.ms = self._carry["ms"]
        self._pinned = None
        return obs, reward, done, info, action_out

    def _step_fused(self, sim_time: float, action):
        ticks, run_ctrl, gate_after, sp_seq, plan_active = self._plan_block(sim_time)
        if not ticks:
            return None, 0.0, False, {}, np.asarray(action, np.float32)
        out_vec = self._launch_block(*self._block_inputs(run_ctrl, sp_seq, action))
        return self._read_block(out_vec, gate_after, sp_seq, plan_active)

    def close(self):
        pass

    # -- main loop (firmware_wrapper.py:208-295) --------------------------------
    def step(self, sim_time: float, action):
        """One control-period block of 500 Hz firmware loops: the fused block,
        or with ``fused=False`` the host loop, its oracle."""
        if self.fused:
            return self._step_fused(sim_time, action)
        return self._step_host(sim_time, action)

    @torch.no_grad()
    def _step_host(self, sim_time: float, action):
        self._process_command_queue(sim_time)
        obs = reward = done = info = None
        action = np.asarray(action, dtype=np.float32)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        while self.tick / self.firmware_freq < sim_time + self.ctrl_dt:
            self.env_state, obs_t, rew_t, done_t, info_t = self.env.step(
                self.env_state, f32(action).reshape(1, 4))
            out = torch.cat([obs_t[0], rew_t, done_t.to(obs_t.dtype)]).cpu().numpy()
            obs, reward, done = out[:12], float(out[12]), bool(out[13] > 0.5)
            cur_pos = np.array([obs[0], obs[2], obs[4]])
            cur_vel = np.array([obs[1], obs[3], obs[5]])
            cur_rpy = np.array([obs[6], obs[7], obs[8]])
            # Finite-difference sensors (firmware_wrapper.py:248-268).
            rates = (cur_rpy - self.prev_rpy) / self.firmware_dt
            self.prev_rpy = cur_rpy
            acc = (cur_vel - self.prev_vel) / self.firmware_dt / 9.8 + np.array([0, 0, 1.0])
            self.prev_vel = cur_vel
            # Sensor delay (firmware_wrapper.py:264-268): the controller sees
            # the measurement from SENSOR_DELAY loops ago; LPFs apply at
            # sensorData-update time, i.e. on the delayed sample.
            if self.SENSOR_DELAY:
                acc_meas, rates_meas = self.sensor_history[0]
                self.sensor_history = self.sensor_history[1:] + [[acc, rates]]
            else:
                acc_meas, rates_meas = acc, rates
            gyro = np.array([self.gyrolpf[i].apply(rates_meas[i]) for i in range(3)])
            _ = [self.acclpf[i].apply(acc_meas[i]) for i in range(3)]

            # Tumble detection (firmware_wrapper.py:421-431) — the reference
            # checks state.acc.z, the UNFILTERED undelayed world acc.
            if acc[2] < -0.5:
                self.tumble_counter += 1
            else:
                self.tumble_counter = 0
            if self.tumble_counter >= 30:
                self.pwms = np.zeros(4)
                self._error = True

            # Setpoint update from the active HL plan.
            self._update_setpoint(self.tick / self.firmware_freq)

            # Controller tick gating (firmware_wrapper.py:433-446): attitude
            # PID when >2 ms since the last call, position PID when >10 ms;
            # controllerMellinger executes on the attitude cadence, PWMs
            # zero-order-hold between executions.  With cur_time = tick/500
            # the float comparison fires every OTHER loop — the reference's
            # effective 250 Hz.
            cur_time = self.tick / self.firmware_freq
            if cur_time - self.last_att_pid_call > 0.002:
                run_ctrl = True
                self.last_att_pid_call = cur_time
                if cur_time - self.last_pos_pid_call > 0.01:
                    self.last_pos_pid_call = cur_time
            else:
                run_ctrl = False
            if not self._error and run_ctrl:
                sp = self.setpoint
                rows = f32(np.stack([cur_pos, cur_vel, cur_rpy, gyro, sp["pos"], sp["vel"],
                                     sp["acc"], sp["omega"]]))
                control, self.ms = mellinger_control(
                    self.ms, self.firmware_dt, *rows[None, :4].unbind(1),
                    rows[None, 4], rows[None, 5], rows[None, 6],
                    float(np.float32(sp["yaw"])), rows[None, 7], kd_omega_rp=self.kd_omega_rp)
                self.pwms = power_distribution(control)[0].cpu().numpy()

            # PWM -> per-motor forces, firmware motor order [3, 2, 1, 0]
            # (firmware_wrapper.py:277-278).
            rpm = PWM2RPM_SCALE * np.clip(self.pwms, MIN_PWM, MAX_PWM) + PWM2RPM_CONST
            new_action = (KF * rpm**2)[REMAP]
            # Keep the emitted thrusts inside the env's physical input bounds:
            # at the PWM ceiling the float64 thrust equals the bound exactly
            # and the env's float32 cast can tip it ~1e-7 over, tripping the
            # default input constraint.  Same guard as the sim-only PID path
            # (competition/controller.py _clip_forces).
            new_action = np.clip(new_action, self._a_low, self._a_high)
            # Action delay (firmware_wrapper.py:283-287): motors respond to
            # the command issued ACTION_DELAY loops ago.
            if self.ACTION_DELAY:
                delayed = self.action_history[0]
                self.action_history = self.action_history[1:] + [new_action]
                new_action = delayed
            if self._error:
                new_action = np.zeros(4)
                done = True
            action = new_action
            self.action = action
            self.tick += 1
            if bool(done):
                break
        if obs is not None:
            info = {k: v[0].cpu().numpy() for k, v in info_t.items()}
        return obs, float(reward), bool(done), info, action

    # -- high-level command API (firmware_wrapper.py:483-663) -------------------
    def sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        self.command_queue.append(("_fullState", (np.asarray(pos, float), np.asarray(vel, float),
                                                  np.asarray(acc, float), float(yaw),
                                                  np.asarray(rpy_rate, float))))

    def sendTakeoffCmd(self, height, duration):
        self.command_queue.append(("_takeoff", (float(height), float(duration))))

    def sendTakeoffYawCmd(self, height, duration, yaw):
        self.command_queue.append(("_takeoff", (float(height), float(duration), float(yaw))))

    def sendLandCmd(self, height, duration):
        self.command_queue.append(("_land", (float(height), float(duration))))

    def sendLandYawCmd(self, height, duration, yaw):
        self.command_queue.append(("_land", (float(height), float(duration), float(yaw))))

    def sendGotoCmd(self, pos, yaw, duration_s, relative):
        self.command_queue.append(("_goto", (np.asarray(pos, float), float(yaw),
                                             float(duration_s), bool(relative))))

    def sendStopCmd(self):
        self.command_queue.append(("_stop", ()))

    def sendNotifySetpointStop(self, *args):
        self.command_queue.append(("_notify_stop", ()))

    def _process_command_queue(self, sim_time):
        if self.command_queue:
            cmd, args = self.command_queue.pop(0)
            self._cmd_time = sim_time
            getattr(self, cmd)(sim_time, *args)

    # -- command implementations -------------------------------------------------
    def _fullState(self, t, pos, vel, acc, yaw, rpy_rate):
        self.full_state_cmd_override = True
        self._plan = None
        self.setpoint = {"pos": pos, "vel": vel, "acc": acc, "yaw": yaw, "omega": rpy_rate}

    def _plan_poly7(self, t, duration, p1, yaw1):
        """Plan a 7th-order no-jerk move from the CURRENT setpoint state to
        (p1, yaw1) at rest — the firmware planner's plan_takeoff/plan_land/
        plan_go_to shape (crtpCommanderHighLevel* -> pptraj poly7_nojerk)."""
        p0 = np.asarray(self.setpoint["pos"], float)
        v0 = np.asarray(self.setpoint["vel"], float)
        a0 = np.asarray(self.setpoint["acc"], float)
        coeffs = np.stack([_poly7_nojerk(duration, p0[i], v0[i], a0[i], float(p1[i]), 0.0, 0.0)
                           for i in range(3)])
        yaw_c = _poly7_nojerk(duration, float(self.setpoint["yaw"]), 0.0, 0.0, float(yaw1), 0.0,
                              0.0)
        self._plan = ("poly7", t, max(float(duration), 1e-6), coeffs, yaw_c)

    def _takeoff(self, t, height, duration, yaw=0.0):
        self.full_state_cmd_override = False
        p0 = np.asarray(self.setpoint["pos"], float)
        self._plan_poly7(t, duration, [p0[0], p0[1], height], yaw)

    def _land(self, t, height, duration, yaw=0.0):
        self.full_state_cmd_override = False
        p0 = np.asarray(self.setpoint["pos"], float)
        self._plan_poly7(t, duration, [p0[0], p0[1], height], yaw)

    def _goto(self, t, pos, yaw, duration, relative):
        self.full_state_cmd_override = False
        p0 = np.asarray(self.setpoint["pos"], float)
        p1 = p0 + np.asarray(pos, float) if relative else np.asarray(pos, float)
        self._plan_poly7(t, duration, p1, yaw)

    def _stop(self, t):
        self.full_state_cmd_override = False
        self._plan = None
        self.pwms = np.zeros(4)
        self._error = True  # motors off

    def _notify_stop(self, t):
        self.full_state_cmd_override = False

    def _update_setpoint(self, t):
        if self.full_state_cmd_override or self._plan is None:
            return
        kind, t0, duration, coeffs, yaw_c = self._plan
        tau = float(np.clip(t - t0, 0.0, duration))
        pva = np.array([_poly_eval(coeffs[i], tau) for i in range(3)])
        yaw, yaw_rate, _ = _poly_eval(yaw_c, tau)
        if t - t0 >= duration:
            # Plan finished: hold the endpoint at rest (planner's hover hold).
            pva[:, 1:] = 0.0
            yaw_rate = 0.0
        self.setpoint = {"pos": pva[:, 0], "vel": pva[:, 1], "acc": pva[:, 2],
                         "yaw": yaw, "omega": np.array([0.0, 0.0, yaw_rate])}
