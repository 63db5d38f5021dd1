"""Whole-rollout engines for the planar quadrotors (1D and 2D).

Port of ``safe_control_gym_tpu/parallel/fast_quad_planar.py`` (BASELINE
config 3).  Two kernels share one control step (``scg::grp::pq_step`` in
``csrc/lane_group_planar.cuh``, templated on the quad type; plain version
:func:`step_rows`): action white noise, the motor-grouped actuation
(``envs/quadrotor.py::motor_force``), the impulse force, RK4 or Euler substeps of the 1D or 2D
body, the closed-form goal (:func:`goal_rows`), the reward, the out-of-bound
done and the non-finite freeze, box violations, the counter-PRNG auto-reset
(slots 0..3 inertia, 4..4+nx-1 initial state, 4+nx impulse offset) and 7
episode-statistics rows.

* K7, :func:`planar_rollout` (``csrc/quad_planar_rollout.cu``; plain
  :func:`planar_rollout_plain`): ``steps`` control steps of a constant
  action.  Host wrapper :class:`FastPlanarQuadRollout`.
* K8, :func:`planar_policy_rollout`
  (``csrc/quad_planar_policy_rollout.cu``; plain
  :func:`planar_policy_rollout_plain`): the dual MLP over ``nu`` outputs, a
  Gaussian sample, the normalized action map and one record per step.  Host
  wrapper :class:`FastPlanarQuadPolicyRollout`.

CUDA tensors launch the kernels, CPU tensors take the plain versions,
anything else raises.  State rows ``(nx + 13, B)`` at the JAX row indices
(:func:`rows_layout`): 15 for 1D, 19 for 2D.  The record has
``2 nx + nu + 5`` rows: 10 in 1D, 19 in 2D.

K8's observation instance (``csrc/obs_ext.cuh``) adds the observation
white noise (Philox call site 2) and the goal-horizon rows of the TPU policy
kernel (``goal_ext_rows``, the static goal or the next ``obs_goal_horizon``
goals, clipped at the env's goal table's last row); K7 never reads the
observation, so its rows do not change under observation noise.  Outside
the envelope (``supports``): observations wider than ``fast_env.MAX_OBS``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from safe_control_gym_torch.envs import quadrotor as Q
from safe_control_gym_torch.envs.constraints import box_bounds_view
from safe_control_gym_torch.ops import ctr_prng, philox
from safe_control_gym_torch.ops.quad_substeps import div
from safe_control_gym_torch.parallel import fast_cartpole as FC
from safe_control_gym_torch.parallel import fast_env as FE
from safe_control_gym_torch.parallel import fast_policy as FP
from safe_control_gym_torch.utils.device import resolve_device

# K7's launch (csrc/quad_planar_rollout.cu): one env over a group of lanes of
# a warp (csrc/lane_group_planar.cuh), 32 envs a block.  GROUPS: the group sizes the source builds for either quad type;
# the plan takes the widest whose B x G lanes stay within PLAN_LANES
# (fast_cartpole.plan_group; on an H100 the fastest group within 4% at
# B = 4096 to 65536 for both quad types: PERF.md).
GROUPS = (1, 2, 4)
PLAN_LANES = 16384
# K8's launch (csrc/quad_planar_policy_rollout.cu) is K6's plan
# (fast_cartpole.policy_launch_plan) for both quad types: on an H100 8 lanes
# an env were fastest or within 6% of the fastest at B = 4096-16384 for K6
# and K8 alike, one lane from 32768 (PERF.md).
POLICY_GROUPS = FC.POLICY_GROUPS
POLICY_PLAN_LANES = FC.POLICY_PLAN_LANES


def launch_plan(B: int, nx: int, group: int | None = None):
    """K7's launch for B envs of the quad type with ``nx`` states: (lanes
    per env, threads per block, blocks).  Each env is one group of ``group``
    lanes (chosen by B where None) inside a warp, 32 envs a block; the
    lanes of the last block's groups past env B - 1 run env B - 1 and store
    nothing.  The kernel refuses a group size it was not built with."""
    if nx not in (2, 6):
        raise ValueError(f"K7 takes the 1D (nx 2) or 2D (nx 6) quad, not nx {nx}")
    g = FC.plan_group(B, PLAN_LANES, GROUPS) if group is None else group
    if g not in GROUPS:
        raise ValueError(f"K7 is built for groups of {GROUPS} lanes, not {g}")
    return g, 32 * g, -(-B // 32)


def policy_launch_plan(B: int, hidden: int, nx: int, group: int | None = None,
                       obs_dim: int = 0):
    """K8's launch for B envs of the quad type with ``nx`` states at hidden
    width ``hidden``: (lanes per env, threads per block, blocks, dynamic
    shared-memory bytes), K6's plan (``fast_cartpole.policy_launch_plan``;
    ``obs_dim`` > 0: the observation instance's)."""
    if nx not in (2, 6):
        raise ValueError(f"K8 takes the 1D (nx 2) or 2D (nx 6) quad, not nx {nx}")
    return FC.policy_launch_plan(B, hidden, group, obs_dim)


def nx_nu(quad_type):
    return Q.TYPE_NX_NU[int(quad_type)]


def rows_layout(nx: int) -> dict:
    """Row indices: state | mass | iyy | step | offset | stats(7) | seed | ep
    (fast_quad_planar.py:46-51)."""
    return dict(MASS=nx, IYY=nx + 1, STEP=nx + 2, OFFSET=nx + 3, STATS=nx + 4,
                SEED=nx + 11, EP=nx + 12, NROWS=nx + 13)


def exact_rows(nx: int):
    """Rows a kernel and its plain version must leave equal: step, offset,
    done count and episode index."""
    L = rows_layout(nx)
    return [L["STEP"], L["OFFSET"], L["STATS"] + 3, L["EP"]]


def supports(cfg, allow_normalized: bool = False, allow_goal_horizon: bool = False) -> bool:
    """True if the 1D/2D quadrotor config is in the whole-rollout engines'
    envelope: the JAX package's (fast_quad_planar.py:54), with the
    observation capped at ``fast_env.MAX_OBS``.  ``allow_normalized`` asks
    for the policy engine's envelope: it maps the normalized action space
    in-kernel; ``allow_goal_horizon`` its goal-horizon observation rows
    (rl_reward only, as the JAX package's).  Both engines admit a single
    scalar observation white noise, as the JAX package's do: the
    constant-action engine never reads the observation, so its rows do not
    change, and the policy engine draws it in-kernel."""
    if int(cfg.quad_type) not in (1, 2):
        return False
    nx, nu = nx_nu(cfg.quad_type)
    ti = {**Q._DEFAULT_TASK_INFO, **(cfg.task_info or {})}
    has_d, fl = FE.dist_envelope_flags(cfg)
    act_w = np.asarray(1e-4 if cfg.rew_act_weight is None else cfg.rew_act_weight, float).ravel()
    return (
        # The rl_reward path applies one action weight to every input.
        (act_w.size == 1 or bool(np.all(act_w == act_w[0])))
        and cfg.physics in ("pyb", "dyn")
        and cfg.cost in ("rl_reward", "quadratic")
        and (allow_normalized or not cfg.normalized_rl_action_space)
        and (cfg.task == "stabilization"
             or (cfg.task == "traj_tracking"
                 and ti.get("trajectory_type") in ("figure8", "circle", "square")))
        and FE.goal_horizon_ok(cfg, nx, allow_goal_horizon)
        and (not has_d["dynamics"] or fl["impulse"])
        and (not has_d["action"] or fl["act_noise"])
        and (not has_d["observation"] or fl["obs_noise"])
        and cfg.adversary_disturbance is None
        and not (cfg.gates or cfg.obstacles)
        and not cfg.done_on_violation
        and not cfg.done_on_collision
        and not cfg.done_on_completion
        and not cfg.use_constraint_penalty
        and (cfg.constraints is None or box_bounds_view(cfg.constraints, nx, nu) is not None)
    )


def build_engine_params(env, steps_per_call: int, allow_normalized: bool = False,
                        allow_goal_horizon: bool = False) -> dict:
    """Static engine-parameter dict from a 1D/2D quadrotor env (the JAX
    package's keys, fast_quad_planar.py:363-534).  The flags are
    :func:`supports`'."""
    cfg = env.config
    if not supports(cfg, allow_normalized=allow_normalized,
                    allow_goal_horizon=allow_goal_horizon):
        raise ValueError("config outside the fast-planar-quad envelope (supports())")
    nx, nu = nx_nu(cfg.quad_type)
    ti = {**Q._DEFAULT_TASK_INFO, **(cfg.task_info or {})}

    # Nominal inertial properties with override (quadrotor.py:241-256).
    nom_mass, nom_j = Q.MASS, list(Q.J_DIAG)
    ip = cfg.inertial_prop
    if ip is not None:
        if isinstance(ip, dict):
            nom_mass = float(ip.get("M", ip.get("mass", nom_mass)))
            for i, k in enumerate(("Ixx", "Iyy", "Izz")):
                nom_j[i] = float(ip.get(k, ip.get(k.lower(), nom_j[i])))
        else:
            arr = np.asarray(ip, dtype=float)
            if nx == 2:
                nom_mass = float(arr[0])
            else:
                nom_mass, nom_j[1] = float(arr[0]), float(arr[1])

    # Randomization bounds in counter-slot order: 0..3 inertia (M, Ixx, Iyy,
    # Izz), 4..4+nx-1 initial state.  The infos replace the defaults, which
    # are filtered to this quad type's fields.
    labels = Q.TYPE_INIT_LABELS[int(cfg.quad_type)]
    init_state = cfg.init_state or {}
    if isinstance(init_state, (list, tuple, np.ndarray)):
        init_state = dict(zip(labels, np.asarray(init_state, float)))
    nominal = [nom_mass, *nom_j] + [float(init_state.get(n, 0.0)) for n in labels]
    inertial = {}
    if cfg.randomized_inertial_prop:
        inertial = dict(cfg.inertial_prop_randomization_info or {
            k: v for k, v in Q._DEFAULT_INERTIAL_RAND.items()
            if k in Q._TYPE_INERTIAL_KEYS[int(cfg.quad_type)]})
    init_rand = {}
    if cfg.randomized_init:
        init_rand = dict(cfg.init_state_randomization_info or {
            k: v for k, v in Q._DEFAULT_INIT_RAND.items() if k in labels})
    names = ["M", "Ixx", "Iyy", "Izz"] + list(labels)
    infos = [inertial] * 4 + [init_rand] * nx
    lo = [float(i[n]["low"]) if n in i else 0.0 for n, i in zip(names, infos)]
    hi = [float(i[n]["high"]) if n in i else 0.0 for n, i in zip(names, infos)]

    if cfg.task == "stabilization":
        task, x_goal = "stab", tuple(float(v) for v in np.asarray(env.x_goal, float).reshape(-1))
        traj_type, traj_w, traj_scale, period = "none", 0.0, 0.0, 1.0
        x_sel = z_sel = -1
        plane_off = (0.0, 0.0)
    else:
        task, x_goal = "traj", (0.0,) * nx
        plane = ti.get("trajectory_plane", "zx")
        off = ti.get("trajectory_position_offset", (0.0, 0.0))
        plane_off = (float(off[0]), float(off[1]))
        # Which curve component lands on each world axis the state reads.
        x_sel = 0 if plane[0] == "x" else (1 if plane[1] == "x" else -1)
        z_sel = 0 if plane[0] == "z" else (1 if plane[1] == "z" else -1)
        traj_type = ti.get("trajectory_type")
        period = cfg.episode_len_sec / float(ti.get("num_cycles", 1))
        traj_w = 2.0 * math.pi / period
        traj_scale = float(ti.get("trajectory_scale", 1.0))

    c_s_lo, c_s_hi, c_u_lo, c_u_hi, u_check = FE.constraint_box(env, nx, nu)
    return dict(
        nx=nx, nu=nu,
        steps=steps_per_call,
        n_sub=cfg.pyb_freq // cfg.ctrl_freq,
        euler=(cfg.physics == "dyn"),
        dt=1.0 / cfg.pyb_freq,
        ctrl_dt=1.0 / cfg.ctrl_freq,
        g=Q.GRAVITY_ACC, arm_l=Q.ARM_L, n_motor=4 // nu,
        a_low=float(env.spaces.action_low[0]),
        a_high=float(env.spaces.action_high[0]),
        normalized=bool(cfg.normalized_rl_action_space),
        norm_act_scale=float(cfg.norm_act_scale),
        hover_thrust=float(Q.GRAVITY_ACC * nom_mass / nu),
        u_goal=float(env.u_goal[0]),
        rew_act_w=float(np.ravel(cfg.rew_act_weight)[0]),
        rew_state_w=tuple(np.broadcast_to(np.asarray(cfg.rew_state_weight, float), (nx,)).tolist()),
        rew_exp=bool(cfg.rew_exponential),
        q_weight=tuple(np.broadcast_to(
            np.asarray(1.0 if cfg.q_weight is None else cfg.q_weight, float).ravel(), (nx,)).tolist()),
        r_weight=tuple(np.broadcast_to(
            np.asarray(1.0 if cfg.r_weight is None else cfg.r_weight, float).ravel(), (nu,)).tolist()),
        s_low=tuple(float(v) for v in env.spaces.state_low),
        s_high=tuple(float(v) for v in env.spaces.state_high),
        c_low=tuple(float(v) for v in c_s_lo),
        c_high=tuple(float(v) for v in c_s_hi),
        u_check=u_check,
        u_low=tuple(float(v) for v in c_u_lo),
        u_high=tuple(float(v) for v in c_u_hi),
        oob_mask=Q.TYPE_OOB_MASK[int(cfg.quad_type)],
        done_oob=bool(cfg.done_on_out_of_bound),
        count_viol=cfg.constraints is not None,
        max_steps=float(int(cfg.episode_len_sec * cfg.ctrl_freq)),
        stab_tol=float(ti.get("stabilization_goal_tolerance", 0.0)),
        impulse=FE.impulse_spec(cfg),
        act_noise_std=FE.act_noise_std(cfg),
        task=task, x_goal=x_goal,
        traj_type=traj_type, traj_w=traj_w, traj_scale=traj_scale, traj_period=float(period),
        x_sel=x_sel, z_sel=z_sel, plane_off=plane_off,
        cost={"quadratic": "quad"}.get(cfg.cost, "rl"),
        rand_nominal=tuple(nominal), rand_lo=tuple(lo), rand_hi=tuple(hi),
        **FE.obs_ext_params(env, nx),
    )


# --------------------------------------------------------------------------
# The control step both kernels share, plain PyTorch (fast_quad_planar.py:104-336).
# --------------------------------------------------------------------------

def goal_rows(p, step_f):
    """Goal rows at control-step rows ``step_f``: the static goal, or the
    closed-form curve on the axes the state reads (1D: z; 2D: x and z)."""
    if p["task"] == "stab":
        return [torch.full_like(step_f, v) for v in p["x_goal"]]
    zero = torch.zeros_like(step_f)
    gz, gvz = FC.axis_goal(p, step_f, p["z_sel"])
    if p["nx"] == 2:
        return [gz, gvz]
    gx, gvx = FC.axis_goal(p, step_f, p["x_sel"])
    return [gx, gvx, gz, gvz, zero, zero]


def step_rows(p, carry, thrust_rows, act_rows, noise_u=None):
    """One control step on the nx + 13 rows.

    ``thrust_rows``: the preprocessed thrusts (pre noise: the reward's
    action error); ``act_rows``: the commanded action (the input-constraint
    test); ``noise_u``: the 2 nu Philox uniforms of the action white noise.
    Returns ``(new_rows, rew, done, trunc, violf, s_post)``."""
    nx, nu = p["nx"], p["nu"]
    L = rows_layout(nx)
    s = tuple(carry[:nx])
    mass, iyy = carry[L["MASS"]], carry[L["IYY"]]
    step_f, offset = carry[L["STEP"]], carry[L["OFFSET"]]
    zero_t = torch.zeros_like(step_f)

    act_err = [t - p["u_goal"] for t in thrust_rows]
    if p["act_noise_std"] > 0.0:
        thrust_rows = [t + p["act_noise_std"] * torch.sqrt(-2.0 * torch.log(1.0 - noise_u[i]))
                       * torch.cos(philox.TWO_PI * noise_u[nu + i])
                       for i, t in enumerate(thrust_rows)]
    # One motor's force per command (_actuate, fast_quad_planar.py:104-112).
    fm = [Q.motor_force(t, p["n_motor"]) for t in thrust_rows]
    ext = FC.impulse_force(p, step_f, offset) if p["impulse"] is not None else zero_t

    minv = 1.0 / mass
    if nx == 2:
        T = (fm[0] + fm[0]) + fm[0] + fm[0]  # 4 motors, one command

        def fc(sv):
            return (sv[1], T * minv - p["g"] + ext * minv)
    else:
        Tsum = (fm[0] + fm[0]) + (fm[1] + fm[1])  # motors (T1, T2, T2, T1)
        theta_dd = div(p["arm_l"] * ((fm[1] + fm[1]) - (fm[0] + fm[0])) / iyy, math.sqrt(2.0))

        def fc(sv):
            x_dd = torch.sin(sv[4]) * Tsum * minv + ext * minv
            z_dd = torch.cos(sv[4]) * Tsum * minv - p["g"] + ext * minv
            return (sv[1], x_dd, sv[3], z_dd, sv[5], theta_dd)

    dt = p["dt"]
    for _ in range(p["n_sub"]):
        k1 = fc(s)
        if p["euler"]:
            s = tuple(si + dt * ki for si, ki in zip(s, k1))
            continue
        k2 = fc(tuple(si + dt / 2 * ki for si, ki in zip(s, k1)))
        k3 = fc(tuple(si + dt / 2 * ki for si, ki in zip(s, k2)))
        k4 = fc(tuple(si + dt * ki for si, ki in zip(s, k3)))
        s = tuple(si + dt / 6 * (a + 2 * b + 2 * c + d) for si, a, b, c, d in zip(s, k1, k2, k3, k4))

    goal = goal_rows(p, step_f)
    viol = None
    for k in range(nx):
        out_k = (s[k] < p["c_low"][k]) | (s[k] > p["c_high"][k])
        viol = out_k if viol is None else viol | out_k
    if p["u_check"]:
        for i in range(nu):
            viol = viol | (act_rows[i] < p["u_low"][i]) | (act_rows[i] > p["u_high"][i])
    violf = viol.to(torch.float32) if p["count_viol"] else zero_t

    dist = zero_t
    if p["cost"] == "quad":
        for i, ae in enumerate(act_err):
            dist = dist + 0.5 * p["r_weight"][i] * ae * ae
        for k in range(nx):
            e = s[k] - goal[k]
            dist = dist + 0.5 * p["q_weight"][k] * e * e
        rew = -dist
    else:
        for ae in act_err:
            dist = dist + p["rew_act_w"] * ae * ae
        for k in range(nx):
            e = s[k] - goal[k]
            dist = dist + p["rew_state_w"][k] * e * e
        rew = torch.exp(-dist) if p["rew_exp"] else -dist

    done = zero_t > 1.0
    if p["cost"] == "quad" and p["task"] == "stab":
        d2 = zero_t
        for k in range(nx):
            e = s[k] - goal[k]
            d2 = d2 + e * e
        done = done | (torch.sqrt(d2) < p["stab_tol"])
    if p["done_oob"]:
        for k in range(nx):
            if p["oob_mask"][k]:
                done = done | (s[k] < p["s_low"][k]) | (s[k] > p["s_high"][k])
    finite = FC.finite_rows(s)
    s = tuple(torch.where(finite, s[k], carry[k]) for k in range(nx))
    rew = torch.where(finite, rew, zero_t)
    done = done | ~finite

    new_step = step_f + 1.0
    timeout = new_step >= p["max_steps"]
    trunc = timeout & ~done
    done = done | timeout
    stats = FC.episode_stats(carry[L["STATS"]:L["STATS"] + 7], rew, violf, done)

    # Masked auto-reset from the counter stream (quadrotor._reset_core slots).
    es = ctr_prng.seed_from_row(carry[L["SEED"]])
    base = ctr_prng.episode_base(es, carry[L["EP"]].to(torch.int32) + 1)
    u = [ctr_prng.slot_uniform(base, k) for k in range(4 + nx + 1)]
    nm, lo, hi = p["rand_nominal"], p["rand_lo"], p["rand_hi"]
    new_x = [torch.where(done, nm[4 + k] + lo[4 + k] + u[4 + k] * (hi[4 + k] - lo[4 + k]), s[k])
             for k in range(nx)]
    new_mass = torch.where(done, nm[0] + lo[0] + u[0] * (hi[0] - lo[0]), mass)
    new_iyy = torch.where(done, nm[2] + lo[2] + u[2] * (hi[2] - lo[2]), iyy)
    new_off = torch.where(done, torch.floor(u[4 + nx] * p["max_steps"]), offset)
    new_step = torch.where(done, zero_t, new_step)
    new_ep = torch.where(done, carry[L["EP"]] + 1.0, carry[L["EP"]])
    rows = new_x + [new_mass, new_iyy, new_step, new_off] + stats + [carry[L["SEED"]], new_ep]
    return rows, rew, done, trunc, violf, list(s)


def preprocess(p, act):
    """A commanded action row -> the thrust the step takes (pre noise)."""
    if p["normalized"]:
        return (1.0 + p["norm_act_scale"] * torch.clamp(act, -1.0, 1.0)) * p["hover_thrust"]
    return torch.clamp(act, p["a_low"], p["a_high"])


def _noise_u(p, seed, it, env):
    if p["act_noise_std"] > 0.0:
        return philox.uniforms(seed, it, env, 2 * p["nu"], philox.SITE_ACTION)
    return None


def planar_rollout_plain(p, rows, action, seed):
    """Plain PyTorch version of K7: ``p['steps']`` control steps of the
    constant ``action`` (nu, B) on ``rows`` (nx + 13, B)."""
    carry = list(rows.unbind(0))
    act = list(action.unbind(0))
    thr = [preprocess(p, a) for a in act]
    env = torch.arange(rows.shape[1], device=rows.device)
    for it in range(p["steps"]):
        carry = step_rows(p, carry, thr, act, _noise_u(p, seed, it, env))[0]
    return torch.stack(carry, 0)


def planar_policy_rollout_plain(p, rows, weights, seed):
    """Plain PyTorch version of K8: ``p['steps']`` policy-driven control
    steps; returns (rows, traj (T, 2 nx + nu + 5, B))."""
    env = torch.arange(rows.shape[1], device=rows.device)

    def step(carry, thr, act, it):
        return step_rows(p, carry, thr, act, _noise_u(p, seed, it, env))

    return FP.policy_rollout_loop(p, rows, weights, seed, p["nx"], p["nu"],
                                  lambda a: preprocess(p, a), step, rows_layout(p["nx"])["STEP"],
                                  goal_rows)


# --------------------------------------------------------------------------
# K7 and K8 on the card.
# --------------------------------------------------------------------------

_F6 = ctypes.c_float * 6
_F2 = ctypes.c_float * 2


class PlanarParams(ctypes.Structure):
    """Host mirror of ``PlanarParams`` in ``csrc/quad_planar.cuh`` (arrays
    sized for the 2D quad; the 1D quad uses their first entries)."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "steps", "n_sub", "euler", "cost", "task", "impulse", "decay_one", "act_noise",
            "u_check", "done_oob", "count_viol", "rew_exp", "normalized", "x_sel", "z_sel")]
        + [("oob_mask", ctypes.c_int * 6)]
        + [(n, ctypes.c_float) for n in (
            "dt", "dt_half", "dt_sixth", "ctrl_dt", "g", "arm_l", "n_motor", "sqrt2",
            "a_low", "a_high", "norm_act_scale", "hover_thrust", "u_goal", "rew_act_w",
            "max_steps", "stab_tol", "act_noise_std",
            "imp_mag", "imp_peak_shift", "imp_half_dur", "imp_log_decay")]
        + [("plane_off", _F2), ("x_goal", _F6), ("rew_state_w", _F6), ("q_half", _F6),
           ("r_half", _F2), ("s_low", _F6), ("s_high", _F6), ("c_low", _F6), ("c_high", _F6),
           ("u_low", _F2), ("u_high", _F2), ("rand_a", ctypes.c_float * 11),
           ("rand_b", ctypes.c_float * 11), ("curve", FC.CurveParams)]
    )


def kernel_params(p) -> PlanarParams:
    """The kernels' parameter struct: each float is the float32 rounding of
    the Python expression :func:`step_rows` evaluates."""
    c = PlanarParams()
    c.steps, c.n_sub, c.euler = int(p["steps"]), int(p["n_sub"]), int(bool(p["euler"]))
    c.cost = 1 if p["cost"] == "quad" else 0
    c.task = 0 if p["task"] == "stab" else 1
    c.act_noise = int(p["act_noise_std"] > 0.0)
    c.u_check, c.done_oob = int(bool(p["u_check"])), int(bool(p["done_oob"]))
    c.count_viol, c.rew_exp = int(bool(p["count_viol"])), int(bool(p["rew_exp"]))
    c.normalized, c.x_sel, c.z_sel = int(bool(p["normalized"])), int(p["x_sel"]), int(p["z_sel"])
    nx, nu = p["nx"], p["nu"]
    c.oob_mask[:nx] = [int(v) for v in p["oob_mask"]]
    dt = p["dt"]
    c.dt, c.dt_half, c.dt_sixth, c.ctrl_dt = dt, dt / 2, dt / 6, p["ctrl_dt"]
    c.g, c.arm_l, c.n_motor, c.sqrt2 = p["g"], p["arm_l"], float(p["n_motor"]), math.sqrt(2.0)
    c.a_low, c.a_high = p["a_low"], p["a_high"]
    c.norm_act_scale, c.hover_thrust = p["norm_act_scale"], p["hover_thrust"]
    c.u_goal, c.rew_act_w = p["u_goal"], p["rew_act_w"]
    c.max_steps, c.stab_tol, c.act_noise_std = p["max_steps"], p["stab_tol"], p["act_noise_std"]
    if p["impulse"] is not None:
        mag, dur, decay = p["impulse"]
        c.impulse, c.decay_one = 1, int(decay == 1.0)
        c.imp_mag, c.imp_peak_shift, c.imp_half_dur = mag, float(int(dur / 2)), dur / 2.0
        c.imp_log_decay = math.log(decay)
    c.plane_off[:] = p["plane_off"]
    c.x_goal[:nx], c.rew_state_w[:nx] = p["x_goal"], p["rew_state_w"]
    c.q_half[:nx] = [0.5 * q for q in p["q_weight"]]
    c.r_half[:nu] = [0.5 * r for r in p["r_weight"]]
    for name in ("s_low", "s_high", "c_low", "c_high"):
        getattr(c, name)[:nx] = p[name]
    c.u_low[:nu], c.u_high[:nu] = p["u_low"], p["u_high"]
    nm, lo, hi = p["rand_nominal"], p["rand_lo"], p["rand_hi"]
    c.rand_a[:4 + nx] = [a + b for a, b in zip(nm, lo)]
    c.rand_b[:4 + nx] = [h - b for h, b in zip(hi, lo)]
    c.curve = FC.curve_params(p)
    return c


def planar_rollout(p, rows, action, seed):
    """K7: ``p['steps']`` control steps of a constant action for every env.
    rows (nx + 13, B) float32, action (nu, B) float32, seed int32 (1,).

    CPU tensors take :func:`planar_rollout_plain`; CUDA tensors launch
    ``csrc/quad_planar_rollout.cu``; anything else raises."""
    if all(t.device.type == "cpu" for t in (rows, action, seed)):
        return planar_rollout_plain(p, rows, action, seed)
    nx, nu = p["nx"], p["nu"]
    n_rows, B, dev = nx + 13, rows.shape[-1], rows.device
    if not (dev.type == "cuda" and tuple(rows.shape) == (n_rows, B)
            and tuple(action.shape) == (nu, B) and philox.seed_ok(seed, dev)
            and all(t.device == dev and t.dtype == torch.float32 for t in (rows, action))):
        raise ValueError(
            f"planar_rollout takes float32 rows ({n_rows}, B), action ({nu}, B) and an int32 "
            f"seed on one CUDA device; got {tuple(rows.shape)} {rows.dtype} {rows.device}, "
            f"{tuple(action.shape)} {action.dtype} {action.device}, seed {seed.dtype} {seed.device}")
    from safe_control_gym_torch import kernels

    rows, action = rows.contiguous(), action.contiguous()
    out = torch.empty_like(rows)
    if B == 0:
        return out
    params = kernel_params(p)
    lib = kernels.lib()
    FC.check_params_size(lib, "quad_planar", params)
    code = lib.quad_planar_rollout(ctypes.addressof(params), nx, seed.data_ptr(), rows.data_ptr(),
                                   action.data_ptr(), out.data_ptr(), B, *launch_plan(B, nx),
                                   kernels.stream_ptr(dev))
    kernels.check(code, "quad_planar_rollout")
    planar_rollout.launches += 1
    return out


planar_rollout.launches = 0


def planar_policy_rollout(p, rows, weights, seed, group=None):
    """K8: the rollout of :func:`planar_policy_rollout_plain`.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/quad_planar_policy_rollout.cu`` with ``group`` lanes per env
    (:func:`policy_launch_plan`'s pick where None); anything else raises."""
    if all(t.device.type == "cpu" for t in (rows, seed, *weights)):
        return planar_policy_rollout_plain(p, rows, weights, seed)
    nx, nu = p["nx"], p["nu"]
    D = FP.obs_dim(p, nx)
    FC.check_policy_inputs("planar_policy_rollout", rows, nx + 13, weights, seed, D, nu,
                           p["mlp_act"])
    from safe_control_gym_torch import kernels

    B = rows.shape[-1]
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    traj = torch.empty((p["steps"], 2 * D + nu + 5, B), dtype=torch.float32, device=rows.device)
    if B == 0:
        return out, traj
    params = kernel_params(p)
    lib = kernels.lib()
    FC.check_params_size(lib, "quad_planar", params)
    code, obs = FC.launch_policy(lib, "quad_planar_policy_rollout", params,
                                 (nx, int(p["mlp_act"] == "relu")), nx, p, rows, weights, seed,
                                 out, traj, group)
    kernels.check(code, "quad_planar_policy_rollout")
    planar_policy_rollout.launches += 1
    planar_policy_rollout.obs_launches += obs
    return out, traj


# Launches of K8, and of its observation instance among them.
planar_policy_rollout.launches = planar_policy_rollout.obs_launches = 0


def reset_rows(p, env_seeds):
    """Fresh packed rows (nx + 13, B) for int32 ``env_seeds``: episode-0
    draws from the counter stream in float32, as the general engine's
    reset."""
    nx = p["nx"]
    L = rows_layout(nx)
    es = env_seeds.to(torch.int32)
    dev = es.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    nm, lo, hi = (np.asarray(p[k], np.float32) for k in ("rand_nominal", "rand_lo", "rand_hi"))
    u_all = ctr_prng.uniform_slots(ctr_prng.episode_base(es, torch.zeros_like(es)), 5 + nx).T
    drawn = f32(nm + lo) + u_all[:, :4 + nx] * f32(hi - lo)
    rows = torch.zeros((L["NROWS"], es.shape[0]), dtype=torch.float32, device=dev)
    rows[:nx] = drawn[:, 4:].T
    rows[L["MASS"]] = drawn[:, 0]
    rows[L["IYY"]] = drawn[:, 2]
    rows[L["OFFSET"]] = torch.floor(u_all[:, 4 + nx] * p["max_steps"])
    rows[L["SEED"]] = ctr_prng.seed_to_row(es)
    return rows


class _PlanarBase:
    def _setup(self, env, num_envs, device, params):
        self.env = env
        self.B = num_envs
        self.device = resolve_device(device)
        self.params = params
        self.nx, self.nu = params["nx"], params["nu"]
        self.layout = rows_layout(self.nx)
        self.n_rows = self.layout["NROWS"]
        self._auto_seed = 1

    def reset(self, seed: int = 0, env_seeds=None):
        """Episode 0 of ``env_seeds`` (int32, (B,)) or of the port's per-env
        seeds for ``seed``."""
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, self.B, self.device)
        return reset_rows(self.params, torch.as_tensor(env_seeds, device=self.device))

    def states(self, rows):
        """(B, nx) state matrix from packed rows."""
        return rows[:self.nx].T

    def _seed(self, seed):
        if seed is None:
            seed, self._auto_seed = self._auto_seed, self._auto_seed + 1
        return philox.seed_tensor(seed, self.device)


class FastPlanarQuadRollout(_PlanarBase):
    """Host wrapper of K7: packed state + one-launch rollout calls."""

    def __init__(self, env, num_envs: int, steps_per_call: int = 256, device=None):
        self._setup(env, num_envs, device, build_engine_params(env, steps_per_call))
        self.steps = steps_per_call

    def pack(self, env_states):
        """Pack a batched general-engine ``QuadState`` into rows."""
        dev, L = self.device, self.layout
        rows = torch.zeros((self.n_rows, self.B), dtype=torch.float32, device=dev)
        rows[:self.nx] = env_states.x.to(dev, torch.float32).T
        rows[L["MASS"]] = env_states.mass.to(dev, torch.float32)
        rows[L["IYY"]] = env_states.j_diag[:, 1].to(dev, torch.float32)
        rows[L["STEP"]] = env_states.ctrl_step.to(dev, torch.float32)
        offsets = env_states.dist_offsets.get("dynamics")
        if offsets is not None and offsets.shape[-1]:
            rows[L["OFFSET"]] = offsets[:, 0].to(dev, torch.float32)
        rows[L["SEED"]] = ctr_prng.seed_to_row(env_states.env_seed.to(dev))
        rows[L["EP"]] = env_states.episode_idx.to(dev, torch.float32)
        return rows

    def stats(self, rows):
        return FC.stats_of(rows, self.layout["STATS"])

    def prepare_action(self, action):
        """A (nu,) or (B, nu) thrust command as the (nu, B) device tensor
        that ``run`` takes."""
        a = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        a = a.reshape(self.nu, 1).expand(self.nu, self.B) if a.dim() == 1 else a.T
        return a.contiguous()

    def run(self, rows, action, seed=None):
        """One launch = ``steps_per_call`` env steps for all B envs;
        ``seed`` keys the call's action white noise (auto-incremented)."""
        if not (torch.is_tensor(action) and tuple(action.shape) == (self.nu, self.B)):
            action = self.prepare_action(action)
        return planar_rollout(self.params, rows, action, self._seed(seed))


class FastPlanarQuadPolicyRollout(_PlanarBase):
    """Host wrapper of K8: one launch = T policy-driven env steps for B
    envs, returning the whole PPO trajectory record (the API of
    ``fast_policy.FastPolicyRollout``)."""

    def __init__(self, env, num_envs: int, steps_per_call: int, mlp_hidden: int = 64,
                 mlp_act: str = "tanh", device=None):
        FP._act_fn(mlp_act)
        FP.check_hidden(mlp_hidden)
        params = build_engine_params(env, steps_per_call, allow_normalized=True,
                                     allow_goal_horizon=True)
        params["mlp_act"] = mlp_act
        self._setup(env, num_envs, device, params)
        self.T = steps_per_call
        self.H = mlp_hidden
        self.obs_dim = FP.obs_dim(params, self.nx)
        self.traj_rows = 2 * self.obs_dim + self.nu + 5

    pack_weights = staticmethod(FP.pack_weights)

    def unpack_traj(self, traj):
        """(T, 2 D + nu + 5, B) record -> PPO field dict, (T, B, ...)."""
        return FP.unpack_record(traj, self.obs_dim, self.nu)

    def observe(self, rows, generator=None):
        """(B, D) observation (``fast_policy.observe_rows``): the state,
        noised from ``generator`` where the config has observation noise and
        it is given, then the goal rows."""
        return FP.observe_rows(self.params, self.env, self.states(rows),
                               rows[self.layout["STEP"]], generator)

    def run(self, rows, weights, seed=None):
        """One launch = T policy-driven env steps.  Returns (rows, traj)."""
        return planar_policy_rollout(self.params, rows, weights, self._seed(seed))
