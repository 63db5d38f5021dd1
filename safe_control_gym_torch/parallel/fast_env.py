"""Whole-rollout engine: many env steps of the 3D quadrotor per launch.

Port of ``safe_control_gym_tpu/parallel/fast_env.py``, the constant-action
engine with its maze envelope (BASELINE config 5).  The whole rollout
(actuation, action white noise, impulse or uniform dynamics force, RK4
substeps, closed-form goal, the maze's gate, obstacle and ground geometry
with gate progress and completion, rl_reward / quadratic / competition
reward, done, violation counting, counter-PRNG auto-reset with the gate and
obstacle pose redraws, and episode statistics) runs in K2,
:func:`quad3d_rollout`: the CUDA kernel ``csrc/quad3d_rollout.cu`` for CUDA
tensors, the plain PyTorch version :func:`quad3d_rollout_plain` for CPU
tensors.

State is packed as float32 rows ``(27, B)`` at the JAX package's row
indices, and with the maze ``4 NG + 2 NO + 4`` rows more (:func:`maze_rows`:
each gate's x, y, yaw and height, each obstacle's x and y, then the current
gate, the steps at the goal, the completion flag and the previous step's
violation flag); the env seed row holds the int32 seed's bit pattern and is
never used in arithmetic.  Reset draws come from the counter stream both
engines share (``ops/ctr_prng.py``), so this engine and the general engine
(``envs/quadrotor.py`` + ``parallel/vector.py``) agree through auto-resets.
The step noise (action white noise, the uniform force) comes from Philox
keyed on the call's seed (``ops/philox.py``, call sites 1 and 3): it agrees
with the JAX package's in distribution only.

Outside the envelope (``supports``): more than ``MAX_GATES`` gates or
``MAX_OBSTACLES`` obstacles, and an observation wider than ``MAX_OBS``.  The
normalized RL action space and the goal-horizon observation rows are the
policy engine's (``parallel/fast_policy.py``, ``allow_normalized=True``,
``allow_goal_horizon=True``): a constant-action call has no policy output to
map and reads no observation.  Observation white noise (one scalar std) is
in both envelopes: the constant-action engine never reads the observation,
so its rows do not change; the policy engine draws it (Philox call site 2,
:func:`obs_noise_rows`).  The policy engine takes the maze envelope too
(``allow_maze``), as the JAX package's does; the PPO trainer does not.

:func:`step_rows` is the plain version of the control step both kernels
share (``scg::env_step_group`` in ``csrc/lane_group.cuh``);
:func:`obs_noise_rows` and :func:`goal_ext_rows` are the plain versions of
the policy kernels' observation row (``csrc/obs_ext.cuh``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from safe_control_gym_torch.envs import gates as GG
from safe_control_gym_torch.envs import quadrotor as Q
from safe_control_gym_torch.envs.constraints import box_bounds_view
from safe_control_gym_torch.ops import ctr_prng, philox
from safe_control_gym_torch.ops.quad_substeps import actuate, div, fc_rows, substeps_rows
from safe_control_gym_torch.ops.rotations import projection_matrix
from safe_control_gym_torch.parallel.fast_update import MAX_OBS
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
# Counter slot of each reset draw in fast-row order (x0..x11, mass, J,
# offset); the maze's pose draws follow at slots 17 and up.
_SLOT_MAP = list(range(4, 16)) + [0, 1, 2, 3, 16]
# The most gates and obstacles K2's maze instance holds (csrc/maze.cuh);
# the competition levels have four of each.
MAX_GATES, MAX_OBSTACLES = 8, 8
# MAX_OBS (fast_update): the widest observation (state plus goal-horizon
# rows) the policy kernels take, K4's and kernel_scope's limit; the JAX
# kernels have none.

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


def obs_mul(cfg) -> int:
    """Blocks of the observation: 1 + the goal-horizon blocks the env
    appends (benchmark_env.py:406-420; JAX fast_env.py:794-797): tracking
    appends the next ``obs_goal_horizon`` reference states, stabilization
    the goal once, and only the rl_reward cost appends any."""
    h = int(cfg.obs_goal_horizon)
    if cfg.cost != "rl_reward" or h <= 0:
        return 1
    return 1 + h if cfg.task == "traj_tracking" else 2


def goal_horizon_ok(cfg, nx: int, allow_goal_horizon: bool) -> bool:
    """The goal-horizon part of the envelopes: none, or (``allow_goal_horizon``,
    the policy engines') rl_reward rows whose observation of ``nx *
    obs_mul`` stays within ``MAX_OBS``."""
    return int(cfg.obs_goal_horizon) == 0 or (
        allow_goal_horizon and cfg.cost == "rl_reward" and nx * obs_mul(cfg) <= MAX_OBS)


def supports(cfg, allow_normalized: bool = False, allow_maze: bool = False,
             allow_goal_horizon: bool = False) -> bool:
    """True if the config is in the whole-rollout engines' envelope: the JAX
    package's ``supports`` (fast_env.py:63-129) with two refusals of the
    port's.

    ``allow_normalized`` asks for the policy engine's (``fast_policy.py``)
    envelope: it maps the normalized RL action space to thrust in-kernel.
    Both engines admit a single scalar observation white noise, as the JAX
    package's do: the constant-action engine never reads the observation,
    so its rows do not change, and the policy engine draws it in-kernel.
    ``allow_goal_horizon`` asks for the policy engine's goal-horizon
    observation rows (rl_reward only, as the JAX package's), up to an
    observation of ``MAX_OBS`` (the JAX kernel has no such cap).
    ``allow_maze`` asks for K2's maze envelope (BASELINE config 5): gates
    and obstacles, the competition cost, collision and completion done, one
    scalar action white noise and a uniform dynamics force, up to
    ``MAX_GATES`` gates and ``MAX_OBSTACLES`` obstacles (the JAX kernel has
    no such cap)."""
    ti = {**Q._DEFAULT_TASK_INFO, **(cfg.task_info or {})}
    has_d, fl = dist_envelope_flags(cfg)
    act_w = np.asarray(
        1e-4 if cfg.rew_act_weight is None else cfg.rew_act_weight, dtype=float).ravel()
    gates_nom, obstacles_nom = Q.maze_nominal(cfg)
    return (
        # The kernel applies one action weight to all four motors.
        (act_w.size == 1 or bool(np.all(act_w == act_w[0])))
        and int(cfg.quad_type) == Q.QuadType.THREE_D
        and cfg.physics in ("pyb", "dyn")
        and (cfg.cost in ("rl_reward", "quadratic") or (allow_maze and cfg.cost == "competition"))
        and (allow_normalized or not cfg.normalized_rl_action_space)
        and (cfg.task == "stabilization"
             or (cfg.task == "traj_tracking"
                 and ti.get("trajectory_type") in ("figure8", "circle", "square")))
        and goal_horizon_ok(cfg, _NX, allow_goal_horizon)
        and (not has_d["observation"] or fl["obs_noise"])
        # Action white noise and the uniform force: the maze envelope's.
        and (not has_d["action"] or (allow_maze and fl["act_noise"]))
        and (not has_d["dynamics"] or fl["impulse"] or (allow_maze and fl["uniform"]))
        and cfg.adversary_disturbance is None
        and (allow_maze or not (cfg.gates or cfg.obstacles))
        and len(gates_nom) <= MAX_GATES and len(obstacles_nom) <= MAX_OBSTACLES
        and not cfg.done_on_violation
        and (allow_maze or not cfg.done_on_collision)
        and (allow_maze or not cfg.done_on_completion)
        and not cfg.use_constraint_penalty
        # Violation counting is per-dim bound tests: pure box programs only.
        and (cfg.constraints is None
             or box_bounds_view(cfg.constraints, _NX, 4) is not None)
    )


def impulse_spec(cfg):
    """(magnitude, duration, decay_rate) of the config's impulse on the
    dynamics channel (the single form the envelopes admit), or None."""
    dist = (cfg.disturbances or {}).get("dynamics")
    if not dist or dist[0].get("disturbance_func") == "uniform":
        return None
    return tuple(float(np.asarray(dist[0].get(k, dflt), dtype=float).ravel()[0])
                 for k, dflt in (("magnitude", 1.0), ("duration", 1), ("decay_rate", 1.0)))


def _white_noise_std(cfg, channel) -> float:
    d = (cfg.disturbances or {}).get(channel)
    return float(np.asarray(d[0].get("std", 1.0), float).ravel()[0]) if d else 0.0


def act_noise_std(cfg) -> float:
    """Std of the config's action white noise (0 without one)."""
    return _white_noise_std(cfg, "action")


def obs_noise_std(cfg) -> float:
    """Std of the config's observation white noise (0 without one)."""
    return _white_noise_std(cfg, "observation")


def obs_ext_params(env, nx: int) -> dict:
    """The observation keys of the quadrotor engines' parameter dicts (JAX
    fast_env.py:654, :794-797): the observation white noise's std, the goal
    horizon and the observation's blocks (``obs_mul``), and with goal rows
    the length of the env's goal table (``goal_len``, the port's), whose
    last row the goal rows clip at: the env's ``x_goal.shape[0] - 1``
    (quadrotor.py:539), not the kernels' ``max_steps - 1`` (JAX
    fast_policy.py:118)."""
    cfg = env.config
    keys = dict(obs_noise_std=obs_noise_std(cfg), obs_goal_horizon=int(cfg.obs_goal_horizon),
                obs_mul=obs_mul(cfg))
    if keys["obs_mul"] > 1:
        keys["goal_len"] = int(np.asarray(env.x_goal).reshape(-1, nx).shape[0])
    return keys


def dyn_uniform_spec(cfg):
    """((low x, y, z), (high x, y, z)) of the config's uniform dynamics force,
    or None (fast_env.py:639-642: defaults -1 and 1)."""
    dist = (cfg.disturbances or {}).get("dynamics")
    if not dist or dist[0].get("disturbance_func") != "uniform":
        return None
    lo3 = np.broadcast_to(np.asarray(dist[0].get("low", -1.0), float).ravel(), (3,))
    hi3 = np.broadcast_to(np.asarray(dist[0].get("high", 1.0), float).ravel(), (3,))
    return tuple(map(float, lo3)), tuple(map(float, hi3))


def goal_blocks(p) -> int:
    """Goal blocks of nx rows after the state rows of the observation: the
    horizon when tracking, 1 (the static goal) when stabilizing, else 0."""
    return p.get("obs_mul", 1) - 1


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


def build_engine_params(env, steps_per_call: int, allow_normalized: bool = False,
                        allow_maze: bool = False, allow_goal_horizon: bool = False) -> dict:
    """Static engine-parameter dict from an env (the JAX package's keys for
    this envelope; Python floats, rounded to float32 where used).  The
    flags are :func:`supports`'."""
    cfg = env.config
    if not supports(cfg, allow_normalized=allow_normalized, allow_maze=allow_maze,
                    allow_goal_horizon=allow_goal_horizon):
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
    params = dict(
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
        # Per-step disturbances: white-noise thrust and the uniform dynamics
        # force (the maze envelope's).
        act_noise_std=act_noise_std(cfg),
        dyn_uniform=dyn_uniform_spec(cfg),
        cost={"competition": "competition", "quadratic": "quad"}.get(cfg.cost, "rl"),
        pyb_freq_f=float(cfg.pyb_freq),
        **obs_ext_params(env, _NX),
    )

    # Competition maze (BASELINE config 5; fast_env.py:800-836).
    gates_nom, obstacles_nom = Q.maze_nominal(cfg)
    NG, NO = len(gates_nom), len(obstacles_nom)
    params["maze"] = bool(NG or NO or cfg.cost == "competition")
    params["n_gates"], params["n_obstacles"] = NG, NO
    if params["maze"]:
        heights = [GG.GATE_HEIGHTS[t] for t in gates_nom[:, 6].astype(int)]
        params["gates_nom"] = tuple((float(g[0]), float(g[1]), float(g[5]), float(h))
                                    for g, h in zip(gates_nom, heights))
        params["obstacles_nom"] = tuple((float(o[0]), float(o[1])) for o in obstacles_nom)
        go_rand = cfg.gates_and_obstacles_randomization_info or {}
        if cfg.randomized_gates_and_obstacles:
            gi = go_rand.get("gates", {"low": -0.15, "high": 0.15})
            oi = go_rand.get("obstacles", {"low": -0.15, "high": 0.15})
            params["gate_rand"] = (float(gi["low"]), float(gi["high"]))
            params["obst_rand"] = (float(oi["low"]), float(oi["high"]))
        else:
            params["gate_rand"] = params["obst_rand"] = (0.0, 0.0)
        xg = np.asarray(env.x_goal, float).reshape(-1, _NX)
        params["goal_xyz"] = (float(xg[0, 0]), float(xg[0, 2]), float(xg[0, 4]))
        params["goal_tol"] = float(ti.get("stabilization_goal_tolerance", 0.15))
        params["completion_steps"] = float(cfg.ctrl_freq * 2)
        params["done_collision"] = bool(cfg.done_on_collision)
        params["done_completion"] = bool(cfg.done_on_completion)
    return params


def maze_rows(p) -> int:
    """Rows of the maze after the 27 (fast_env.py:839-846): 4 a gate (x, y,
    yaw, height), 2 an obstacle (x, y), then the current gate, the steps at
    the goal, the completion flag and the previous step's violation flag."""
    return 4 * p["n_gates"] + 2 * p["n_obstacles"] + 4 if p.get("maze") else 0


def total_rows(p) -> int:
    return _NROWS + maze_rows(p)


def pose_affine(p):
    """The reset affine of the maze's pose draws, slot 17 + q for q in
    0..3 NG + 2 NO - 1 (3 a gate: x, y, yaw; 2 an obstacle: x, y): the
    pose is ``a[q] + u * b[q]``, with ``a`` the nominal plus the low bound
    and ``b`` the bounds' span, Python floats (fast_env.py:567-581)."""
    (glo, ghi), (olo, ohi) = p["gate_rand"], p["obst_rand"]
    a = [v + glo for nx0, ny0, nyaw, _ in p["gates_nom"] for v in (nx0, ny0, nyaw)]
    a += [v + olo for o in p["obstacles_nom"] for v in o]
    b = [ghi - glo] * (3 * p["n_gates"]) + [ohi - olo] * (2 * p["n_obstacles"])
    return a, b


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


def obs_noise_rows(p, rows, seed, it, env, block0=0):
    """Observation white noise on state rows (JAX fast_env.py:180-194):
    row k plus ``std * sqrt(-2 log(1 - u_r)) * cos(2 pi u_a)``, one
    Box-Muller pair a row from Philox call site 2 (``SITE_OBS``), row k's
    pair words 2 (k % 2) and 2 (k % 2) + 1 of draw block ``block0 + k //
    2`` (the policy's observation from block 0, the terminal observation's
    fresh draws from ``philox.OBS_TERM_BLOCK``).  The rows unchanged where
    the config has no observation noise."""
    std = p["obs_noise_std"]
    if std <= 0.0:
        return list(rows)
    u = philox.uniforms(seed, it, env, 2 * len(rows), philox.SITE_OBS, block0)
    return [r + std * torch.sqrt(-2.0 * torch.log(1.0 - u[2 * k]))
            * torch.cos(philox.TWO_PI * u[2 * k + 1]) for k, r in enumerate(rows)]


def goal_ext_rows(p, step_f, offset: int, goal_fn):
    """The goal-horizon rows of an observation made at control-step rows
    ``step_f`` (JAX fast_policy.py:108-122, benchmark_env.py:406-420): the
    static goal once (stabilization), or the goal rows ``goal_fn(p, idx)``
    at ``idx = min(step_f + offset + i, goal_last)`` for the ``goal_blocks``
    next steps i (tracking; the policy's observation at offset 1, the
    terminal observation at 2).  The index clips at the env's goal table's
    last row, as the env does (quadrotor.py:539), not at the kernels'
    ``max_steps - 1``."""
    rows = []
    for i in range(goal_blocks(p)):
        rows += goal_fn(p, torch.clamp(step_f + float(offset + i), max=float(p["goal_len"] - 1)))
    return rows


def maze_geometry(p, s, step_f, g_rows, o_rows, cur_gate, steps_goal, completed):
    """The maze's closed-form geometry on the post-substep state rows ``s``
    (fast_env.py:393-447): ground, gate-frame, gate-leg and obstacle
    collision, the current gate's 7-ray aperture fan, gate progress after
    the settling window, at-goal and completion.  Returns (collided,
    stepped, at_goal, cur_gate, steps_goal, completed)."""
    NG, NO = p["n_gates"], p["n_obstacles"]
    px, py, pz = s[0], s[2], s[4]
    zero_t = torch.zeros_like(step_f)
    collided = pz < GG.GROUND_COLLISION_Z
    r = GG.DRONE_RADIUS
    hit_cur = zero_t
    for g in range(NG):
        gx, gy, gyaw, gh = (g_rows[4 * g + j] for j in range(4))
        c, sn = torch.cos(gyaw), torch.sin(gyaw)
        relx, rely = px - gx, py - gy
        u = relx * c + rely * sn
        nrm = -relx * sn + rely * c
        wz = pz - gh
        in_slab = nrm.abs() < (GG.GATE_SLAB_HALF + r)
        in_outer = (u.abs() < GG.GATE_OUTER_HALF + r) & (wz.abs() < GG.GATE_OUTER_HALF + r)
        in_inner = (u.abs() < GG.GATE_INNER_HALF - r) & (wz.abs() < GG.GATE_INNER_HALF - r)
        leg = (torch.sqrt(relx * relx + rely * rely) < GG.OBSTACLE_RADIUS + r) & (
            pz < gh - GG.GATE_OUTER_HALF)
        collided = collided | (in_slab & in_outer & ~in_inner) | leg
        # The 7-ray aperture fan (quadrotor.py:1068-1092).
        hit_g = zero_t > 1.0
        dz = torch.clamp(pz, gh - GG.RAY_HALF_LENGTH, gh + GG.RAY_HALF_LENGTH) - pz
        for i in range(-GG.N_RAY_OFFSETS, GG.N_RAY_OFFSETS + 1):
            sx = gx + i * GG.RAY_SPACING * c
            sy = gy + i * GG.RAY_SPACING * sn
            d2 = (px - sx) * (px - sx) + (py - sy) * (py - sy) + dz * dz
            hit_g = hit_g | (d2 < r * r)
        hit_cur = torch.where((cur_gate - float(g)).abs() < 0.5, hit_g.to(torch.float32), hit_cur)
    for o in range(NO):
        relx, rely = px - o_rows[2 * o], py - o_rows[2 * o + 1]
        collided = collided | ((torch.sqrt(relx * relx + rely * rely)
                                < GG.OBSTACLE_RADIUS + r) & (pz < GG.OBSTACLE_HEIGHT + r))
    # Gate progress after the settling window (quadrotor.py:1060).
    active = ((step_f * p["n_sub"]) > (0.5 * p["pyb_freq_f"])) & (cur_gate < float(NG))
    stepped = active & (hit_cur > 0.5)
    cur_gate = cur_gate + stepped.to(torch.float32)
    gx0, gy0, gz0 = p["goal_xyz"]
    near = torch.sqrt((px - gx0) * (px - gx0) + (py - gy0) * (py - gy0)
                      + (pz - gz0) * (pz - gz0)) < p["goal_tol"]
    at_goal = (cur_gate >= float(NG)) & near
    steps_goal = torch.where(at_goal, steps_goal + 1.0, zero_t)
    completed = torch.maximum(completed, (steps_goal > p["completion_steps"]).to(torch.float32))
    return collided, stepped, at_goal, cur_gate, steps_goal, completed


def step_rows(p, carry, thrust_rows, act_rows, noise=None):
    """One control step on the state rows (fast_env.py:297-590).

    ``thrust_rows``: the preprocessed thrust (pre noise: the reward's action
    terms); ``act_rows``: the commanded action (the input-constraint test);
    ``noise``: ``(u_act, u_dyn)``, the 8 action-noise and 3 uniform-force
    uniforms of the step (either None where the config has no such
    channel).  Returns ``(new_rows, rew, done, trunc, violf, s_post)``:
    ``done`` includes the time limit, ``trunc`` is the time limit without
    another done, and ``s_post`` the post-step state before the auto-reset
    (the terminal observation)."""
    s = carry[:_NX]
    mass, jd = carry[_R_MASS], carry[_R_J:_R_J + 3]
    step_f, offset = carry[_R_STEP], carry[_R_OFFSET]
    stats = carry[_R_STATS:_R_STATS + 7]
    u_act, u_dyn = noise if noise is not None else (None, None)
    NG, NO, maze = p["n_gates"], p["n_obstacles"], p["maze"]
    if maze:
        g_rows = carry[_NROWS:_NROWS + 4 * NG]
        o_rows = carry[_NROWS + 4 * NG:_NROWS + 4 * NG + 2 * NO]
        cur_gate, steps_goal, completed, prev_viol = carry[_NROWS + 4 * NG + 2 * NO:]
    ug = p["u_goal"]

    act_cost = sum((t - ug) * (t - ug) for t in thrust_rows) * p["rew_act_w"]
    quad_act = sum(0.5 * p["r_weight"][i] * ((t - ug) * (t - ug))
                   for i, t in enumerate(thrust_rows))
    if p["act_noise_std"] > 0.0:
        # Action white noise (fast_env.py:341-348), Box-Muller on 8 draws.
        std = p["act_noise_std"]
        thrust_rows = [t + std * torch.sqrt(-2.0 * torch.log(1.0 - u_act[i]))
                       * torch.cos(philox.TWO_PI * u_act[4 + i])
                       for i, t in enumerate(thrust_rows)]
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
    elif p["dyn_uniform"] is not None:
        # The uniform dynamics force (fast_env.py:367-370).
        lo3, hi3 = p["dyn_uniform"]
        ext = tuple(lo3[k] + u_dyn[k] * (hi3[k] - lo3[k]) for k in range(3))
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
    if maze:
        collided, stepped, at_goal, cur_gate, steps_goal, completed = maze_geometry(
            p, s, step_f, g_rows, o_rows, cur_gate, steps_goal, completed)
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

    if p["cost"] == "competition":
        # The sparse competition reward; its violation term is the previous
        # step's flag (fast_env.py:470-476).
        rew = (100.0 * stepped.to(torch.float32) + 100.0 * at_goal.to(torch.float32)
               - 1000.0 * collided.to(torch.float32) - 100.0 * prev_viol)
    elif p["cost"] == "quad":
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
    if maze:
        if p["done_collision"]:
            done = done | collided
        if p["done_completion"]:
            done = done | (completed > 0.5)
    trunc = timeout & ~done  # before the time limit joins done (fast_env.py:509)
    done = done | timeout

    donef = done.to(torch.float32)
    ep_ret, ep_len, ep_vio = stats[0] + rew, stats[1] + 1.0, stats[2] + violf
    new_stats = (
        ep_ret * (1.0 - donef), ep_len * (1.0 - donef), ep_vio * (1.0 - donef),
        stats[3] + donef, stats[4] + donef * ep_ret, stats[5] + donef * ep_len,
        stats[6] + donef * ep_vio,
    )

    # Masked auto-reset from the counter stream (slot remap: fast-row order;
    # the maze's poses from slots 17 and up).
    n_pose = 3 * NG + 2 * NO if maze else 0
    es = ctr_prng.seed_from_row(carry[_R_SEED])
    base = ctr_prng.episode_base(es, carry[_R_EP].to(torch.int32) + 1)
    u = [ctr_prng.slot_uniform(base, k) for k in _SLOT_MAP + list(range(17, 17 + n_pose))]
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
    if maze:
        # Per-episode gate and obstacle pose redraws (fast_env.py:560-588):
        # gates (x, y, yaw, nominal height), then obstacles (x, y).
        a, b = pose_affine(p)
        new_maze = []
        for g in range(NG):
            for j in range(3):
                q = 3 * g + j
                new_maze.append(torch.where(done, a[q] + u[17 + q] * b[q], g_rows[4 * g + j]))
            new_maze.append(torch.where(done, torch.full_like(step_f, p["gates_nom"][g][3]),
                                        g_rows[4 * g + 3]))
        for o in range(NO):
            for j in range(2):
                q = 3 * NG + 2 * o + j
                new_maze.append(torch.where(done, a[q] + u[17 + q] * b[q], o_rows[2 * o + j]))
        new_rows += new_maze + [torch.where(done, zero_t, cur_gate),
                                torch.where(done, zero_t, steps_goal),
                                torch.where(done, zero_t, completed),
                                violf]  # the next step's "previous violation" flag
    return new_rows, rew, done, trunc, violf, list(s)


def step_noise(p, seed, it, env):
    """The step's Philox uniforms ``(u_act, u_dyn)`` for :func:`step_rows`:
    8 of the action white noise (call site 1) and 3 of the uniform force
    (call site 3), each None where the config has no such channel."""
    u_act = (philox.uniforms(seed, it, env, 8, philox.SITE_ACTION)
             if p["act_noise_std"] > 0.0 else None)
    u_dyn = (philox.uniforms(seed, it, env, 3, philox.SITE_DYNAMICS)
             if p["dyn_uniform"] is not None else None)
    return u_act, u_dyn


def quad3d_rollout_plain(p, rows, action, seed=0):
    """Plain PyTorch version of K2: ``p['steps']`` control steps of the
    constant ``action`` (4, B) on ``rows`` (total_rows(p), B); ``seed`` (an
    int or an int32 tensor of one element) keys the step noise."""
    carry = list(rows.unbind(0))
    act = list(action.unbind(0))
    thr = [torch.clamp(a, p["a_low"], p["a_high"]) for a in act]
    env = torch.arange(rows.shape[1], device=rows.device)
    for it in range(p["steps"]):
        carry = step_rows(p, carry, thr, act, step_noise(p, seed, it, env))[0]
    return torch.stack(carry, 0)


# --------------------------------------------------------------------------
# K2 on the card.
# --------------------------------------------------------------------------

_F32_12 = ctypes.c_float * 12
_MAX_POSE = 3 * MAX_GATES + 2 * MAX_OBSTACLES


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
        + [(n, ctypes.c_int) for n in (
            "maze", "n_gates", "n_obst", "act_noise", "dyn_uniform", "done_collision",
            "done_completion")]
        + [(n, ctypes.c_float) for n in (
            "act_noise_std", "n_sub_f", "settle", "goal_tol", "completion_steps")]
        + [("dyn_lo", ctypes.c_float * 3), ("dyn_span", ctypes.c_float * 3),
           ("goal_xyz", ctypes.c_float * 3), ("gate_h", ctypes.c_float * MAX_GATES),
           ("pose_a", ctypes.c_float * _MAX_POSE), ("pose_b", ctypes.c_float * _MAX_POSE)]
    )


def kernel_params(p) -> RolloutParams:
    """The kernel's parameter struct: each float is the float32 rounding of
    the Python expression :func:`step_rows` evaluates (as a weakly typed
    scalar is rounded when it meets a float32 tensor)."""
    c = RolloutParams()
    c.steps = int(p["steps"])
    c.n_sub, c.euler = int(p["n_sub"]), int(bool(p["euler"]))
    c.cost = {"quad": 1, "competition": 2}.get(p["cost"], 0)
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
    c.act_noise_std = p["act_noise_std"]
    c.act_noise = int(p["act_noise_std"] > 0.0)
    if p["dyn_uniform"] is not None:
        c.dyn_uniform = 1
        lo3, hi3 = p["dyn_uniform"]
        c.dyn_lo[:] = lo3
        c.dyn_span[:] = [h - b for h, b in zip(hi3, lo3)]
    c.n_sub_f, c.settle = float(p["n_sub"]), 0.5 * p["pyb_freq_f"]
    if p["maze"]:
        c.maze, c.n_gates, c.n_obst = 1, p["n_gates"], p["n_obstacles"]
        c.done_collision, c.done_completion = int(p["done_collision"]), int(p["done_completion"])
        c.goal_xyz[:] = p["goal_xyz"]
        c.goal_tol, c.completion_steps = p["goal_tol"], p["completion_steps"]
        c.gate_h[:p["n_gates"]] = [g[3] for g in p["gates_nom"]]
        # Gates' entries at 3 g + j, obstacles' at 3 MAX_GATES + 2 o + j
        # (csrc/maze.cuh reads them at constant indices).
        a, b = pose_affine(p)
        ng3 = 3 * p["n_gates"]
        for dst, src in ((c.pose_a, a), (c.pose_b, b)):
            dst[:ng3] = src[:ng3]
            dst[3 * MAX_GATES:3 * MAX_GATES + len(src) - ng3] = src[ng3:]
    return c


def quad3d_rollout(p, rows, action, seed=0):
    """K2: ``p['steps']`` control steps of a constant action for every env.
    rows (total_rows(p), B) float32, action (4, B) float32, seed an int or
    an int32 tensor of one element on the rows' device (it keys the step
    noise).

    CPU tensors take :func:`quad3d_rollout_plain`; CUDA float32 tensors
    launch ``csrc/quad3d_rollout.cu`` (its maze instance where the config
    has the maze or step noise); anything else raises."""
    if rows.device.type == "cpu" and action.device.type == "cpu":
        return quad3d_rollout_plain(p, rows, action, seed)
    B = rows.shape[-1]
    n_rows = total_rows(p)
    for a, shp in ((rows, (n_rows, B)), (action, (4, B))):
        if a.device != rows.device or a.device.type != "cuda" or a.dtype != torch.float32 \
                or tuple(a.shape) != shp:
            raise ValueError(
                f"quad3d_rollout takes float32 rows ({n_rows}, B) and action (4, B) on one "
                f"CUDA device; got {tuple(rows.shape)} {rows.dtype} {rows.device}, "
                f"{tuple(action.shape)} {action.dtype} {action.device}")
    seed = philox.seed_tensor(seed, rows.device)
    if not philox.seed_ok(seed, rows.device):
        raise ValueError(f"quad3d_rollout takes an int32 seed of one element on {rows.device}")
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
        ctypes.addressof(params), seed.data_ptr(), rows.data_ptr(), action.data_ptr(),
        out.data_ptr(), B, *launch_plan(B), kernels.stream_ptr(rows.device))
    kernels.check(code, "quad3d_rollout")
    quad3d_rollout.launches += 1
    return out


quad3d_rollout.launches = 0


def reset_rows(p, env_seeds):
    """Fresh packed rows (total_rows(p), B) for int32 ``env_seeds`` on their
    device: episode-0 draws from the counter stream, float32 arithmetic as
    in the JAX package's reset_rows (fast_env.py:849-908), so both engines
    start from the same states."""
    es = env_seeds.to(torch.int32)
    dev = es.device
    B = es.shape[0]
    NG, NO = p["n_gates"], p["n_obstacles"]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    nm, lo, hi = (np.asarray(p[k], np.float32) for k in ("rand_nominal", "rand_lo", "rand_hi"))
    n_slots = 17 + (3 * NG + 2 * NO if p["maze"] else 0)
    u_all = ctr_prng.uniform_slots(ctr_prng.episode_base(es, torch.zeros_like(es)), n_slots).T
    drawn = f32(nm + lo) + u_all[:, :16] * f32(hi - lo)  # (B, 16): mass, j3, x12
    rows = torch.zeros((total_rows(p), B), dtype=torch.float32, device=dev)
    rows[:_NX] = drawn[:, 4:].T
    rows[_R_MASS] = drawn[:, 0]
    rows[_R_J:_R_J + 3] = drawn[:, 1:4].T
    rows[_R_OFFSET] = torch.floor(u_all[:, 16] * p["max_steps"])
    rows[_R_SEED] = ctr_prng.seed_to_row(es)
    if p["maze"]:
        glo, ghi = (np.float32(v) for v in p["gate_rand"])
        olo, ohi = (np.float32(v) for v in p["obst_rand"])
        for g, (nx0, ny0, nyaw, nh) in enumerate(p["gates_nom"]):
            for j, nv in enumerate((nx0, ny0, nyaw)):
                rows[_NROWS + 4 * g + j] = (f32(np.float32(nv) + glo)
                                            + u_all[:, 17 + 3 * g + j] * f32(ghi - glo))
            rows[_NROWS + 4 * g + 3] = nh
        for o, nominal in enumerate(p["obstacles_nom"]):
            for j, nv in enumerate(nominal):
                rows[_NROWS + 4 * NG + 2 * o + j] = (
                    f32(np.float32(nv) + olo) + u_all[:, 17 + 3 * NG + 2 * o + j] * f32(ohi - olo))
    return rows


def pack_states(p, env_states, dev):
    """A batched general-engine ``QuadState`` as packed rows (total_rows(p),
    B) on device ``dev``, the maze rows included (both 3D engines' ``pack``)."""
    B = env_states.x.shape[0]
    rows = torch.zeros((total_rows(p), B), dtype=torch.float32, device=dev)
    rows[:_NX] = env_states.x.to(dev, torch.float32).T
    rows[_R_MASS] = env_states.mass.to(dev, torch.float32)
    rows[_R_J:_R_J + 3] = env_states.j_diag.to(dev, torch.float32).T
    rows[_R_STEP] = env_states.ctrl_step.to(dev, torch.float32)
    offsets = env_states.dist_offsets.get("dynamics")
    if offsets is not None and offsets.shape[-1]:
        rows[_R_OFFSET] = offsets[:, 0].to(dev, torch.float32)
    rows[_R_SEED] = ctr_prng.seed_to_row(env_states.env_seed.to(dev))
    rows[_R_EP] = env_states.episode_idx.to(dev, torch.float32)
    if p["maze"]:
        NG, NO = p["n_gates"], p["n_obstacles"]
        rows[_NROWS:_NROWS + 4 * NG] = env_states.gates_eff.to(dev, torch.float32).reshape(
            B, 4 * NG).T
        rows[_NROWS + 4 * NG:_NROWS + 4 * NG + 2 * NO] = env_states.obstacles_eff.to(
            dev, torch.float32).reshape(B, 2 * NO).T
        mz = _NROWS + 4 * NG + 2 * NO
        for k, field in enumerate(("current_gate", "steps_at_goal", "task_completed",
                                   "cnstr_violation")):
            rows[mz + k] = getattr(env_states, field).to(dev, torch.float32)
    return rows


class FastQuadRollout:
    """Host wrapper: packed state + one-launch rollout calls."""

    def __init__(self, env, num_envs: int, steps_per_call: int = 256, device=None,
                 allow_maze: bool = True):
        self.env = env
        self.B = num_envs
        self.steps = steps_per_call
        self.device = resolve_device(device)
        self._auto_seed = 1
        self.params = build_engine_params(env, steps_per_call, allow_maze=allow_maze)
        self.n_rows = total_rows(self.params)

    def reset(self, seed: int = 0, env_seeds=None):
        """Fresh packed rows: episode 0 of ``env_seeds`` (int32, (B,)) or
        of the port's per-env seeds for ``seed``."""
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, self.B, self.device)
        return reset_rows(self.params, torch.as_tensor(env_seeds, device=self.device))

    def pack(self, env_states):
        """Pack a batched general-engine ``QuadState`` into rows."""
        return pack_states(self.params, env_states, self.device)

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
        :meth:`prepare_action`.  ``seed`` keys the call's step noise
        (auto-incremented where None)."""
        if not (torch.is_tensor(action) and tuple(action.shape) == (4, self.B)):
            action = self.prepare_action(action)
        if seed is None:
            seed, self._auto_seed = self._auto_seed, self._auto_seed + 1
        return quad3d_rollout(self.params, rows, action, philox.seed_tensor(seed, self.device))
