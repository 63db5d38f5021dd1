"""Whole-rollout engine: many env steps of the 3D quadrotor per launch.

Port of ``safe_control_gym_tpu/parallel/fast_env.py`` for the
constant-action envelope without the maze.  The whole rollout (actuation,
impulse force, RK4 substeps, closed-form goal, reward, done, violation
counting, counter-PRNG auto-reset and episode statistics) runs in K2,
:func:`quad3d_rollout`: the CUDA kernel ``csrc/quad3d_rollout.cu`` for CUDA
tensors, the plain PyTorch version :func:`quad3d_rollout_plain` for CPU
tensors.

State is packed as float32 rows ``(27, B)`` at the JAX package's row
indices; the env seed row holds the int32 seed's bit pattern and is never
used in arithmetic.  Reset draws come from the counter stream both engines
share (``ops/ctr_prng.py``), so this engine and the general engine
(``envs/quadrotor.py`` + ``parallel/vector.py``) agree through auto-resets.

Outside the envelope (``supports``): action white noise, the uniform
dynamics force, the goal-horizon observation and the maze are not supported
yet.  The normalized RL action space is the policy engine's
(``parallel/fast_policy.py``, ``allow_normalized=True``): a constant-action
call has no policy output to map.  Observation white noise (one scalar std)
is the constant-action engine's: it never reads the observation, so the
rows do not change; the policy engine, which would have to draw it, refuses
it.

:func:`step_rows` is the plain version of the control step both kernels
share (``scg::env_step`` in ``csrc/quad3d.cuh``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from safe_control_gym_torch.envs import quadrotor as Q
from safe_control_gym_torch.envs.constraints import box_bounds_view
from safe_control_gym_torch.ops import ctr_prng
from safe_control_gym_torch.ops.quad_substeps import actuate, div, fc_rows, substeps_rows
from safe_control_gym_torch.ops.rotations import projection_matrix
from safe_control_gym_torch.utils.device import resolve_device

# State-row layout.
_NX = 12
_R_MASS = 12
_R_J = 13  # 13, 14, 15
_R_STEP = 16
_R_OFFSET = 17
_R_STATS = 18  # ep_ret, ep_len, ep_viol, done_cnt, sum_ret, sum_len, sum_viol
_R_SEED = 25  # 32-bit env seed (ops/ctr_prng.py), carried as an f32 bit pattern
_R_EP = 26  # episode index (f32 counter)
_NROWS = 27

_STATS_KEYS = ("ep_return", "ep_length", "ep_violations", "done_count",
               "sum_return", "sum_length", "sum_violations")
# Counter slot of each reset draw in fast-row order (x0..x11, mass, J, offset).
_SLOT_MAP = list(range(4, 16)) + [0, 1, 2, 3, 16]

# K2's launch (csrc/quad3d_rollout.cu): GROUP lanes of a warp per env
# (csrc/lane_group.cuh), BLOCK threads a block.
GROUP = 4
BLOCK = 128


def launch_plan(B: int, group: int | None = None):
    """K2's launch for B envs: (lanes per env, threads per block, blocks).
    Each env is one group of ``group`` lanes (``GROUP`` where None) inside a
    warp, BLOCK // group envs a block; the lanes of the last block's groups
    past env B - 1 run env B - 1 and store nothing.  The kernel refuses a
    group size it was not built with."""
    g = GROUP if group is None else group
    if g not in (4, 8, 16, 32):
        raise ValueError(f"a lane group holds 4, 8, 16 or 32 lanes, not {g}")
    return g, BLOCK, -(-B // (BLOCK // g))


def _spec_scalar(v):
    return np.asarray(v, dtype=float).size == 1


def _single_scalar_white_noise(ch):
    """True when the channel is exactly one unmasked scalar-std white noise."""
    return (
        ch is not None
        and len(ch) == 1
        and ch[0].get("disturbance_func") == "white_noise"
        and _spec_scalar(ch[0].get("std", 1.0))
        and "mask" not in ch[0]
    )


def dist_envelope_flags(cfg):
    """Disturbance-envelope predicates of the whole-rollout engines.

    Returns ``(has, flags)``: ``has[channel]``, the channel is configured;
    ``flags['impulse'|'uniform'|'act_noise'|'obs_noise']``, the channel is
    the single supported form the kernels implement."""
    dist = cfg.disturbances or {}
    dyn = dist.get("dynamics")
    has = {ch: bool(dist.get(ch)) for ch in ("dynamics", "action", "observation")}
    impulse = dyn is not None and (
        len(dyn) == 1 and dyn[0].get("disturbance_func") == "impulse"
        and "mask" not in dyn[0] and "step_offset" not in dyn[0]
        and all(_spec_scalar(dyn[0].get(k, 1.0))
                for k in ("magnitude", "duration", "decay_rate"))
        and float(np.asarray(dyn[0].get("decay_rate", 1.0), float)) > 0.0
    )
    uniform = dyn is not None and (
        len(dyn) == 1 and dyn[0].get("disturbance_func") == "uniform"
        and "mask" not in dyn[0]
    )
    return has, {
        "impulse": impulse,
        "uniform": uniform,
        "act_noise": _single_scalar_white_noise(dist.get("action")),
        "obs_noise": _single_scalar_white_noise(dist.get("observation")),
    }


def supports(cfg, allow_normalized: bool = False, allow_maze: bool = False) -> bool:
    """True if the config is in the whole-rollout engines' envelope.

    ``allow_normalized`` asks for the policy engine's (``fast_policy.py``)
    envelope: it maps the normalized RL action space to thrust in-kernel,
    and it refuses observation white noise, which it does not draw yet.  The
    constant-action engine (the default) admits a single scalar observation
    white noise, as the JAX package's does: it never reads the observation,
    so its rows do not change.  The maze envelope (``allow_maze``) is not
    ported yet and raises."""
    if allow_maze:
        raise NotImplementedError("the maze envelope is not ported yet")
    ti = {**Q._DEFAULT_TASK_INFO, **(cfg.task_info or {})}
    has_d, fl = dist_envelope_flags(cfg)
    act_w = np.asarray(
        1e-4 if cfg.rew_act_weight is None else cfg.rew_act_weight, dtype=float).ravel()
    return (
        # The kernel applies one action weight to all four motors.
        (act_w.size == 1 or bool(np.all(act_w == act_w[0])))
        and int(cfg.quad_type) == Q.QuadType.THREE_D
        and cfg.physics in ("pyb", "dyn")
        and cfg.cost in ("rl_reward", "quadratic")
        and (allow_normalized or not cfg.normalized_rl_action_space)
        and (cfg.task == "stabilization"
             or (cfg.task == "traj_tracking"
                 and ti.get("trajectory_type") in ("figure8", "circle", "square")))
        and int(cfg.obs_goal_horizon) == 0
        and (not has_d["observation"] or (not allow_normalized and fl["obs_noise"]))
        # Action noise needs the in-kernel Philox stream of the maze branch.
        and not has_d["action"]
        and (not has_d["dynamics"] or fl["impulse"])
        and cfg.adversary_disturbance is None
        and not (cfg.gates or cfg.obstacles)
        and not cfg.done_on_violation
        and not cfg.done_on_collision
        and not cfg.done_on_completion
        and not cfg.use_constraint_penalty
        # Violation counting is per-dim bound tests: pure box programs only.
        and (cfg.constraints is None
             or box_bounds_view(cfg.constraints, _NX, 4) is not None)
    )


def impulse_spec(cfg):
    """(magnitude, duration, decay_rate) of the config's impulse on the
    dynamics channel (the single form the envelopes admit), or None."""
    dist = (cfg.disturbances or {}).get("dynamics")
    if not dist:
        return None
    return tuple(float(np.asarray(dist[0].get(k, dflt), dtype=float).ravel()[0])
                 for k, dflt in (("magnitude", 1.0), ("duration", 1), ("decay_rate", 1.0)))


def act_noise_std(cfg) -> float:
    """Std of the config's action white noise (0 without one)."""
    act_d = (cfg.disturbances or {}).get("action")
    return float(np.asarray(act_d[0].get("std", 1.0), float).ravel()[0]) if act_d else 0.0


def constraint_box(env, nx: int, nu: int):
    """Per-dim violation bounds of the env's pure box constraint program
    (``box_bounds_view``) or, without constraints, the state space: (state
    low, state high, input low, input high, whether any input bound is
    finite)."""
    if env.config.constraints is not None:
        s_lo, s_hi, u_lo, u_hi = box_bounds_view(env.config.constraints, nx, nu, env.spaces)
        return s_lo, s_hi, u_lo, u_hi, bool((u_lo > -1e29).any() or (u_hi < 1e29).any())
    return (np.asarray(env.spaces.state_low, float), np.asarray(env.spaces.state_high, float),
            np.full(nu, -1e30), np.full(nu, 1e30), False)


def build_engine_params(env, steps_per_call: int, allow_normalized: bool = False) -> dict:
    """Static engine-parameter dict from an env (the JAX package's keys for
    this envelope; Python floats, rounded to float32 where used).  The
    flags are :func:`supports`'."""
    cfg = env.config
    if not supports(cfg, allow_normalized=allow_normalized):
        raise ValueError("config outside the whole-rollout engine's envelope (supports())")
    ti = {**Q._DEFAULT_TASK_INFO, **(cfg.task_info or {})}
    n_sub = cfg.pyb_freq // cfg.ctrl_freq
    # Randomization bounds in fast-row order: mass, jx, jy, jz, x0..x11.
    inertial = Q._DEFAULT_INERTIAL_RAND if cfg.randomized_inertial_prop else {}
    if cfg.randomized_inertial_prop and cfg.inertial_prop_randomization_info:
        inertial = cfg.inertial_prop_randomization_info
    init_rand = Q._DEFAULT_INIT_RAND if cfg.randomized_init else {}
    if cfg.randomized_init and cfg.init_state_randomization_info:
        init_rand = cfg.init_state_randomization_info
    labels = Q.INIT_LABELS
    if isinstance(cfg.init_state, dict):
        init_state = cfg.init_state
    elif cfg.init_state is not None:
        init_state = dict(zip(labels, np.asarray(cfg.init_state, float).ravel()))
    else:
        init_state = {}
    names = ["M", "Ixx", "Iyy", "Izz"] + list(labels)
    infos = [inertial] * 4 + [init_rand] * 12
    nominal = [Q.MASS, *Q.J_DIAG] + [float(init_state.get(n, 0.0)) for n in labels]
    if isinstance(cfg.inertial_prop, dict):
        nominal[0] = float(cfg.inertial_prop.get("M", nominal[0]))
        for i, k in enumerate(("Ixx", "Iyy", "Izz")):
            nominal[1 + i] = float(cfg.inertial_prop.get(k, nominal[1 + i]))
    elif cfg.inertial_prop is not None:
        ip = np.asarray(cfg.inertial_prop, dtype=float).reshape(-1)
        nominal[0] = float(ip[0])
        if ip.size >= 4:
            nominal[1:4] = [float(v) for v in ip[1:4]]
    lo = [float(i[n]["low"]) if n in i else 0.0 for n, i in zip(names, infos)]
    hi = [float(i[n]["high"]) if n in i else 0.0 for n, i in zip(names, infos)]

    axes = {"x": 0, "y": 1, "z": 2}
    if cfg.task == "stabilization":
        task = "stab"
        x_goal = tuple(float(v) for v in np.asarray(env.x_goal, np.float32).reshape(-1))
        plane_idx, plane_off = (0, 1), (0.0, 0.0)
        traj_type, traj_w, traj_scale, period = "none", 0.0, 0.0, 1.0
        proj = tuple(tuple(1.0 if r == c else 0.0 for c in range(4)) for r in range(3))
    else:
        task = "traj"
        x_goal = tuple([0.0] * 12)
        plane = ti.get("trajectory_plane", "xy")
        plane_idx = (axes[plane[0]], axes[plane[1]])
        off = ti.get("trajectory_position_offset", (0.0, 0.0))
        plane_off = (float(off[0]), float(off[1]))
        traj_type = ti.get("trajectory_type")
        period = cfg.episode_len_sec / float(ti.get("num_cycles", 1))
        traj_w = 2.0 * math.pi / period
        traj_scale = float(ti.get("trajectory_scale", 1.0))
        M4 = np.asarray(projection_matrix(
            ti.get("proj_point", [0, 0, 0]), ti.get("proj_normal", [0, 0, 1])), dtype=float)
        proj = tuple(tuple(float(v) for v in M4[k, :4]) for k in range(3))

    c_s_lo, c_s_hi, c_u_lo, c_u_hi, u_check = constraint_box(env, _NX, 4)
    return dict(
        steps=steps_per_call,
        n_sub=n_sub,
        euler=(cfg.physics == "dyn"),
        dt=1.0 / cfg.pyb_freq,
        ctrl_dt=1.0 / cfg.ctrl_freq,
        g=Q.GRAVITY_ACC, arm_l=Q.ARM_L, km_over_kf=Q.KM / Q.KF,
        a_low=float(env.spaces.action_low[0]),
        a_high=float(env.spaces.action_high[0]),
        u_goal=float(env.u_goal[0]),
        rew_act_w=1e-4 if cfg.rew_act_weight is None else float(np.ravel(cfg.rew_act_weight)[0]),
        rew_state_w=tuple(np.broadcast_to(np.asarray(cfg.rew_state_weight, float), (12,)).tolist()),
        rew_exp=bool(cfg.rew_exponential),
        s_low=tuple(float(v) for v in env.spaces.state_low),
        s_high=tuple(float(v) for v in env.spaces.state_high),
        oob_mask=tuple(bool(v) for v in Q.OOB_MASK),
        done_oob=bool(cfg.done_on_out_of_bound),
        count_viol=cfg.constraints is not None,
        c_low=tuple(float(v) for v in c_s_lo),
        c_high=tuple(float(v) for v in c_s_hi),
        u_check=u_check,
        u_low=tuple(float(v) for v in c_u_lo),
        u_high=tuple(float(v) for v in c_u_hi),
        max_steps=float(int(cfg.episode_len_sec * cfg.ctrl_freq)),
        impulse=impulse_spec(cfg),
        task=task, x_goal=x_goal,
        traj_type=traj_type, traj_w=traj_w, traj_scale=traj_scale,
        traj_period=float(period),
        plane_idx=plane_idx, plane_off=plane_off, proj=proj,
        q_weight=tuple(np.broadcast_to(
            np.asarray(1.0 if cfg.q_weight is None else cfg.q_weight, float).ravel(),
            (12,)).tolist()),
        r_weight=tuple(np.broadcast_to(
            np.asarray(1.0 if cfg.r_weight is None else cfg.r_weight, float).ravel(),
            (4,)).tolist()),
        stab_tol=float(ti.get("stabilization_goal_tolerance", 0.0)),
        rand_nominal=tuple(nominal), rand_lo=tuple(lo), rand_hi=tuple(hi),
        # Normalized RL action space (quadrotor.py:758-763), mapped to
        # thrust by the policy engine.
        normalized=bool(cfg.normalized_rl_action_space),
        norm_act_scale=float(cfg.norm_act_scale),
        hover_thrust=float(Q.GRAVITY_ACC * nominal[0] / 4.0),
        cost={"quadratic": "quad"}.get(cfg.cost, "rl"),
    )


def total_rows(p) -> int:
    return _NROWS


# --------------------------------------------------------------------------
# Plain PyTorch version of K2 (the JAX package's step_env_core, non-maze).
# --------------------------------------------------------------------------

def eval_curve(p, t):
    """Closed-form planar reference curve at time rows ``t``: the two curve
    components and their velocities (fast_env.py:232-267)."""
    w, sc = p["traj_w"], p["traj_scale"]
    if p["traj_type"] == "figure8":
        sw, cw = torch.sin(w * t), torch.cos(w * t)
        return sc * sw, sc * sw * cw, sc * w * cw, sc * w * (cw * cw - sw * sw)
    if p["traj_type"] == "circle":
        sw, cw = torch.sin(w * t), torch.cos(w * t)
        return sc * cw, sc * sw, -sc * w * sw, sc * w * cw
    period = p["traj_period"]
    seg_period = period / 4.0
    speed = sc / seg_period
    cyc = t - period * torch.floor(div(t, period))
    seg = torch.floor(div(cyc, seg_period))
    seg_pos = speed * (cyc - seg * seg_period)
    is0, is1, is2 = seg < 0.5, (seg - 1.0).abs() < 0.5, (seg - 2.0).abs() < 0.5
    zt = torch.zeros_like(t)
    wh = torch.where
    a_p = wh(is0, zt, wh(is1, -seg_pos, wh(is2, -sc + zt, -sc + seg_pos)))
    b_p = wh(is0, seg_pos, wh(is1, sc + zt, wh(is2, sc - seg_pos, zt)))
    a_v = wh(is0, zt, wh(is1, -speed + zt, wh(is2, zt, speed + zt)))
    b_v = wh(is0, speed + zt, wh(is1, zt, wh(is2, -speed + zt, zt)))
    return a_p, b_p, a_v, b_v


def eval_goal(p, step_f):
    """Closed-form goal rows at control-step rows ``step_f``
    (fast_env.py:270-294)."""
    if p["task"] == "stab":
        return [torch.full_like(step_f, v) for v in p["x_goal"]]
    t = step_f * p["ctrl_dt"]
    a_p, b_p, a_v, b_v = eval_curve(p, t)
    zero = torch.zeros_like(t)
    goal = [zero] * _NX
    p3, v3 = [zero] * 3, [zero] * 3
    ia, ib = p["plane_idx"]
    p3[ia] = a_p + p["plane_off"][0]
    p3[ib] = b_p + p["plane_off"][1]
    v3[ia], v3[ib] = a_v, b_v
    M = p["proj"]
    for k in range(3):
        goal[2 * k] = M[k][0] * p3[0] + M[k][1] * p3[1] + M[k][2] * p3[2] + M[k][3]
        goal[2 * k + 1] = M[k][0] * v3[0] + M[k][1] * v3[1] + M[k][2] * v3[2] + M[k][3]
    return goal


def step_rows(p, carry, thrust_rows, act_rows):
    """One control step on the 27 state rows (fast_env.py:297-590, without
    the maze and the step-noise channels).

    Returns ``(new_rows, rew, done, trunc, violf, s_post)``: ``done``
    includes the time limit, ``trunc`` is the time limit without another
    done, and ``s_post`` the post-step state before the auto-reset (the
    terminal observation)."""
    s = carry[:_NX]
    mass, jd = carry[_R_MASS], carry[_R_J:_R_J + 3]
    step_f, offset = carry[_R_STEP], carry[_R_OFFSET]
    stats = carry[_R_STATS:_R_STATS + 7]
    ug = p["u_goal"]

    act_cost = sum((t - ug) * (t - ug) for t in thrust_rows) * p["rew_act_w"]
    quad_act = sum(0.5 * p["r_weight"][i] * ((t - ug) * (t - ug))
                   for i, t in enumerate(thrust_rows))
    forces = tuple(actuate(t) for t in thrust_rows)

    if p["impulse"] is not None:
        mag, dur, decay = p["impulse"]
        peak = offset + float(int(dur / 2))
        po = (step_f - peak).abs()
        dec = torch.where(
            po < dur / 2.0,
            torch.exp(po * math.log(decay)) if decay != 1.0 else torch.ones_like(po),
            torch.zeros_like(po))
        n = torch.where(step_f >= offset, mag * dec, torch.zeros_like(dec))
        ext = (n, n, n)
    else:
        z = torch.zeros_like(step_f)
        ext = (z, z, z)

    minv = 1.0 / mass
    l_sq2 = p["arm_l"] / (2.0**0.5)
    s = substeps_rows(
        tuple(s), lambda sv: fc_rows(sv, forces, ext, minv, jd, p["g"], l_sq2, p["km_over_kf"]),
        p["n_sub"], p["euler"], p["dt"])

    goal = eval_goal(p, step_f)
    zero_t = torch.zeros_like(step_f)
    viol = None
    oob_done = zero_t > 1.0
    for k in range(_NX):
        c_out = (s[k] < p["c_low"][k]) | (s[k] > p["c_high"][k])
        viol = c_out if viol is None else (viol | c_out)
        if p["done_oob"] and p["oob_mask"][k]:
            oob_done = oob_done | (s[k] < p["s_low"][k]) | (s[k] > p["s_high"][k])
    if p["u_check"]:
        for i in range(4):
            viol = viol | (act_rows[i] < p["u_low"][i]) | (act_rows[i] > p["u_high"][i])
    violf = viol.to(torch.float32) if p["count_viol"] else zero_t

    if p["cost"] == "quad":
        dist = quad_act
        for k in range(_NX):
            e = s[k] - goal[k]
            dist = dist + 0.5 * p["q_weight"][k] * e * e
        rew = -dist
    else:
        dist = act_cost
        for k in range(_NX):
            e = s[k] - goal[k]
            dist = dist + p["rew_state_w"][k] * e * e
        rew = torch.exp(-dist) if p["rew_exp"] else -dist

    new_step = step_f + 1.0
    timeout = new_step >= p["max_steps"]
    done = oob_done
    if p["cost"] == "quad" and p["task"] == "stab":
        d2 = zero_t
        for k in range(_NX):
            e = s[k] - goal[k]
            d2 = d2 + e * e
        done = done | (d2 < p["stab_tol"] ** 2)
    trunc = timeout & ~done  # before the time limit joins done (fast_env.py:509)
    done = done | timeout

    donef = done.to(torch.float32)
    ep_ret, ep_len, ep_vio = stats[0] + rew, stats[1] + 1.0, stats[2] + violf
    new_stats = (
        ep_ret * (1.0 - donef), ep_len * (1.0 - donef), ep_vio * (1.0 - donef),
        stats[3] + donef, stats[4] + donef * ep_ret, stats[5] + donef * ep_len,
        stats[6] + donef * ep_vio,
    )

    # Masked auto-reset from the counter stream (slot remap: fast-row order).
    es = ctr_prng.seed_from_row(carry[_R_SEED])
    base = ctr_prng.episode_base(es, carry[_R_EP].to(torch.int32) + 1)
    u = [ctr_prng.slot_uniform(base, _SLOT_MAP[k]) for k in range(17)]
    nm, lo_v, hi_v = p["rand_nominal"], p["rand_lo"], p["rand_hi"]
    new_x = [torch.where(done, nm[4 + k] + lo_v[4 + k] + u[k] * (hi_v[4 + k] - lo_v[4 + k]), s[k])
             for k in range(_NX)]
    new_mass = torch.where(done, nm[0] + lo_v[0] + u[12] * (hi_v[0] - lo_v[0]), mass)
    new_j = [torch.where(done, nm[1 + i] + lo_v[1 + i] + u[13 + i] * (hi_v[1 + i] - lo_v[1 + i]),
                         jd[i]) for i in range(3)]
    new_off = torch.where(done, torch.floor(u[16] * p["max_steps"]), offset)
    new_step = torch.where(done, zero_t, new_step)
    new_ep = torch.where(done, carry[_R_EP] + 1.0, carry[_R_EP])
    new_rows = (new_x + [new_mass] + new_j + [new_step, new_off] + list(new_stats)
                + [carry[_R_SEED], new_ep])
    return new_rows, rew, done, trunc, violf, list(s)


def quad3d_rollout_plain(p, rows, action):
    """Plain PyTorch version of K2: ``p['steps']`` control steps of the
    constant ``action`` (4, B) on ``rows`` (27, B)."""
    carry = list(rows.unbind(0))
    act = list(action.unbind(0))
    thr = [torch.clamp(a, p["a_low"], p["a_high"]) for a in act]
    for _ in range(p["steps"]):
        carry = step_rows(p, carry, thr, act)[0]
    return torch.stack(carry, 0)


# --------------------------------------------------------------------------
# K2 on the card.
# --------------------------------------------------------------------------

_F32_12 = ctypes.c_float * 12


class RolloutParams(ctypes.Structure):
    """Host mirror of ``RolloutParams`` in ``csrc/quad3d_rollout.cu``."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "steps", "n_sub", "euler", "cost", "task", "traj_type", "impulse",
            "decay_one", "u_check", "done_oob", "count_viol", "rew_exp",
            "plane_a", "plane_b")]
        + [("oob_mask", ctypes.c_int * 12)]
        + [(n, ctypes.c_float) for n in (
            "dt", "dt_half", "dt_sixth", "ctrl_dt", "g", "l_sq2", "km_over_kf",
            "a_low", "a_high", "u_goal", "rew_act_w", "max_steps", "stab_tol2",
            "imp_mag", "imp_peak_shift", "imp_half_dur", "imp_log_decay",
            "traj_w", "traj_scale", "traj_neg_scale", "traj_sc_w", "traj_neg_sc_w",
            "traj_period", "traj_seg_period", "traj_speed", "traj_neg_speed")]
        + [("plane_off", ctypes.c_float * 2), ("proj", _F32_12),
           ("x_goal", _F32_12), ("rew_state_w", _F32_12), ("q_half", _F32_12),
           ("r_half", ctypes.c_float * 4),
           ("s_low", _F32_12), ("s_high", _F32_12), ("c_low", _F32_12), ("c_high", _F32_12),
           ("u_low", ctypes.c_float * 4), ("u_high", ctypes.c_float * 4),
           ("rand_a", ctypes.c_float * 16), ("rand_b", ctypes.c_float * 16)]
    )


def kernel_params(p) -> RolloutParams:
    """The kernel's parameter struct: each float is the float32 rounding of
    the Python expression :func:`step_rows` evaluates (as a weakly typed
    scalar is rounded when it meets a float32 tensor)."""
    c = RolloutParams()
    c.steps = int(p["steps"])
    c.n_sub, c.euler = int(p["n_sub"]), int(bool(p["euler"]))
    c.cost = 1 if p["cost"] == "quad" else 0
    c.task = 0 if p["task"] == "stab" else 1
    c.traj_type = {"figure8": 0, "circle": 1}.get(p["traj_type"], 2)
    c.u_check, c.done_oob = int(bool(p["u_check"])), int(bool(p["done_oob"]))
    c.count_viol, c.rew_exp = int(bool(p["count_viol"])), int(bool(p["rew_exp"]))
    c.plane_a, c.plane_b = p["plane_idx"]
    c.oob_mask[:] = [int(v) for v in p["oob_mask"]]
    dt = p["dt"]
    c.dt, c.dt_half, c.dt_sixth = dt, dt / 2, dt / 6
    c.ctrl_dt, c.g = p["ctrl_dt"], p["g"]
    c.l_sq2, c.km_over_kf = p["arm_l"] / (2.0**0.5), p["km_over_kf"]
    c.a_low, c.a_high, c.u_goal = p["a_low"], p["a_high"], p["u_goal"]
    c.rew_act_w, c.max_steps = p["rew_act_w"], p["max_steps"]
    c.stab_tol2 = p["stab_tol"] ** 2
    if p["impulse"] is not None:
        mag, dur, decay = p["impulse"]
        c.impulse, c.decay_one = 1, int(decay == 1.0)
        c.imp_mag, c.imp_peak_shift, c.imp_half_dur = mag, float(int(dur / 2)), dur / 2.0
        c.imp_log_decay = math.log(decay)
    w, sc, period = p["traj_w"], p["traj_scale"], p["traj_period"]
    c.traj_w, c.traj_scale, c.traj_neg_scale = w, sc, -sc
    c.traj_sc_w, c.traj_neg_sc_w = sc * w, -sc * w
    c.traj_period, c.traj_seg_period = period, period / 4.0
    c.traj_speed, c.traj_neg_speed = sc / (period / 4.0), -(sc / (period / 4.0))
    c.plane_off[:] = p["plane_off"]
    c.proj[:] = [v for row in p["proj"] for v in row]
    c.x_goal[:] = p["x_goal"]
    c.rew_state_w[:] = p["rew_state_w"]
    c.q_half[:] = [0.5 * q for q in p["q_weight"]]
    c.r_half[:] = [0.5 * r for r in p["r_weight"]]
    for name in ("s_low", "s_high", "c_low", "c_high", "u_low", "u_high"):
        getattr(c, name)[:] = p[name]
    nm, lo, hi = p["rand_nominal"], p["rand_lo"], p["rand_hi"]
    c.rand_a[:] = [a + b for a, b in zip(nm, lo)]
    c.rand_b[:] = [h - b for h, b in zip(hi, lo)]
    return c


def quad3d_rollout(p, rows, action):
    """K2: ``p['steps']`` control steps of a constant action for every env.
    rows (27, B) float32, action (4, B) float32.

    CPU tensors take :func:`quad3d_rollout_plain`; CUDA float32 tensors
    launch ``csrc/quad3d_rollout.cu``; anything else raises."""
    if rows.device.type == "cpu" and action.device.type == "cpu":
        return quad3d_rollout_plain(p, rows, action)
    B = rows.shape[-1]
    for a, shp in ((rows, (_NROWS, B)), (action, (4, B))):
        if a.device != rows.device or a.device.type != "cuda" or a.dtype != torch.float32 \
                or tuple(a.shape) != shp:
            raise ValueError(
                "quad3d_rollout takes float32 rows (27, B) and action (4, B) on one "
                f"CUDA device; got {tuple(rows.shape)} {rows.dtype} {rows.device}, "
                f"{tuple(action.shape)} {action.dtype} {action.device}")
    from safe_control_gym_torch import kernels

    rows, action = rows.contiguous(), action.contiguous()
    out = torch.empty_like(rows)
    if B == 0:
        return out
    params = kernel_params(p)
    lib = kernels.lib()
    if lib.quad3d_rollout_params_size() != ctypes.sizeof(params):
        raise RuntimeError("RolloutParams differs between fast_env.py and quad3d_rollout.cu")
    code = lib.quad3d_rollout(
        ctypes.addressof(params), rows.data_ptr(), action.data_ptr(), out.data_ptr(),
        B, *launch_plan(B), kernels.stream_ptr(rows.device))
    kernels.check(code, "quad3d_rollout")
    quad3d_rollout.launches += 1
    return out


quad3d_rollout.launches = 0


def reset_rows(p, env_seeds):
    """Fresh packed rows (27, B) for int32 ``env_seeds`` on their device:
    episode-0 draws from the counter stream, float32 arithmetic as in the
    general engine's reset, so both engines start from the same states."""
    es = env_seeds.to(torch.int32)
    dev = es.device
    B = es.shape[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    nm, lo, hi = (np.asarray(p[k], np.float32) for k in ("rand_nominal", "rand_lo", "rand_hi"))
    u_all = ctr_prng.uniform_slots(ctr_prng.episode_base(es, torch.zeros_like(es)), 17).T
    drawn = f32(nm + lo) + u_all[:, :16] * f32(hi - lo)  # (B, 16): mass, j3, x12
    rows = torch.zeros((_NROWS, B), dtype=torch.float32, device=dev)
    rows[:_NX] = drawn[:, 4:].T
    rows[_R_MASS] = drawn[:, 0]
    rows[_R_J:_R_J + 3] = drawn[:, 1:4].T
    rows[_R_OFFSET] = torch.floor(u_all[:, 16] * p["max_steps"])
    rows[_R_SEED] = ctr_prng.seed_to_row(es)
    return rows


class FastQuadRollout:
    """Host wrapper: packed state + one-launch rollout calls."""

    def __init__(self, env, num_envs: int, steps_per_call: int = 256, device=None):
        self.env = env
        self.B = num_envs
        self.steps = steps_per_call
        self.device = resolve_device(device)
        self.params = build_engine_params(env, steps_per_call)
        self.n_rows = total_rows(self.params)

    def reset(self, seed: int = 0, env_seeds=None):
        """Fresh packed rows: episode 0 of ``env_seeds`` (int32, (B,)) or
        of the port's per-env seeds for ``seed``."""
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, self.B, self.device)
        return reset_rows(self.params, torch.as_tensor(env_seeds, device=self.device))

    def pack(self, env_states):
        """Pack a batched general-engine ``QuadState`` into rows."""
        dev = self.device
        rows = torch.zeros((self.n_rows, self.B), dtype=torch.float32, device=dev)
        rows[:_NX] = env_states.x.to(dev, torch.float32).T
        rows[_R_MASS] = env_states.mass.to(dev, torch.float32)
        rows[_R_J:_R_J + 3] = env_states.j_diag.to(dev, torch.float32).T
        rows[_R_STEP] = env_states.ctrl_step.to(dev, torch.float32)
        offsets = env_states.dist_offsets.get("dynamics")
        if offsets is not None and offsets.shape[-1]:
            rows[_R_OFFSET] = offsets[:, 0].to(dev, torch.float32)
        rows[_R_SEED] = ctr_prng.seed_to_row(env_states.env_seed.to(dev))
        rows[_R_EP] = env_states.episode_idx.to(dev, torch.float32)
        return rows

    def states(self, rows):
        """(B, 12) state matrix from packed rows."""
        return rows[:_NX].T

    def stats(self, rows):
        d = dict(zip(_STATS_KEYS, rows[_R_STATS:_R_STATS + 7].double().sum(-1).tolist()))
        n = max(d["done_count"], 1.0)
        return {
            "episodes": d["done_count"],
            "mean_return": d["sum_return"] / n,
            "mean_length": d["sum_length"] / n,
            "mean_violations": d["sum_violations"] / n,
        }

    def prepare_action(self, action):
        """A (4,) or (B, 4) thrust command as the (4, B) device tensor that
        ``run`` takes; reuse it across calls."""
        a = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        if a.dim() == 1:
            a = a.reshape(4, 1).expand(4, self.B)
        else:
            a = a.T
        return a.contiguous()

    def run(self, rows, action, seed=None):
        """One launch = ``steps_per_call`` env steps for all B envs.

        ``action``: (4,)/(B, 4) thrust command, or the tensor from
        :meth:`prepare_action`.  ``seed`` is accepted for the JAX package's
        API; this envelope draws no step noise, so it is unused."""
        del seed
        if not (torch.is_tensor(action) and tuple(action.shape) == (4, self.B)):
            action = self.prepare_action(action)
        return quad3d_rollout(self.params, rows, action)
