"""Whole-rollout engines for CartPole: many env steps per launch.

Port of ``safe_control_gym_tpu/parallel/fast_cartpole.py`` (BASELINE
configs 1 and 2).  Two kernels share one control step (``scg::grp::cp_step``
in ``csrc/lane_group_planar.cuh``; plain version :func:`step_rows`): action
preprocessing, action white noise, the impulse force on the cart, RK4 on the
cart-pole ODE, the closed-form x-axis reference, the reward, the x/theta
out-of-bound done and the non-finite freeze, box violations, the
counter-PRNG auto-reset (slots 0..2 inertia, 3..6 initial state, 7 impulse
offset) and 7 episode-statistics rows.

* K5, :func:`cartpole_rollout` (``csrc/cartpole_rollout.cu``; plain
  :func:`cartpole_rollout_plain`): ``steps`` control steps of a constant
  action.  Host wrapper :class:`FastCartPoleRollout`.
* K6, :func:`cartpole_policy_rollout` (``csrc/cartpole_policy_rollout.cu``;
  plain :func:`cartpole_policy_rollout_plain`): the dual actor+critic MLP,
  a Gaussian sample, the normalized action map and one record per step, the
  PPO data collection.  Host wrapper :class:`FastCartPolePolicyRollout`.

CUDA tensors launch the kernels, CPU tensors take the plain versions,
anything else raises.  State is packed as float32 rows ``(18, B)`` at the
JAX row indices; the seed row holds the int32 env seed's bit pattern.

Step noise: the TPU kernels draw from the TPU core PRNG; here the action
white noise comes from Philox (``ops/philox.py``) keyed on the call's seed
and counted by (env, step, block, call site 1), so it matches the JAX
package and the general engine in distribution only.  Observation white
noise: K6 draws it on Philox call site 2 (``fast_env.obs_noise_rows``, its
observation instance); K5 never reads the observation, so its rows do not
change.  Outside the envelope (``supports``): the goal-horizon observation,
as in the JAX package's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from safe_control_gym_torch.envs import cartpole as C
from safe_control_gym_torch.envs.constraints import box_bounds_view
from safe_control_gym_torch.ops import ctr_prng, philox
from safe_control_gym_torch.parallel import fast_env as FE
from safe_control_gym_torch.parallel import fast_policy as FP
from safe_control_gym_torch.utils.device import resolve_device

# State-row layout (fast_cartpole.py:46-53).
_NX = 4
_R_PL, _R_PM, _R_CM = 4, 5, 6  # pole_length, pole_mass, cart_mass
_R_STEP = 7
_R_OFFSET = 8  # impulse step offset
_R_STATS = 9  # ep_ret, ep_len, ep_viol, done_cnt, sum_ret, sum_len, sum_viol
_R_SEED = 16
_R_EP = 17
_NROWS = 18
_EXACT_ROWS = [_R_STEP, _R_OFFSET, _R_STATS + 3, _R_EP]  # step, offset, done count, episode

# Trajectory record rows (fast_cartpole.py:636-641): obs 4 | act 1 |
# rew/done/trunc/v/logp | terminal obs 4 (fast_policy.unpack_record).
TRAJ_ROWS = 14

# K5's launch (csrc/cartpole_rollout.cu): one env over a group of lanes of a
# warp (csrc/lane_group_planar.cuh), 32 envs a block.  GROUPS: the group sizes the source builds.  A group pays where
# one thread per env leaves the card's issue slots idle and loses where its
# lanes' repeated work fills them, so the plan takes the widest group whose
# B x G lanes stay within PLAN_LANES (on an H100 the fastest group at
# B = 4096, 8192, 16384, 32768 and 65536: PERF.md).
GROUPS = (1, 2, 4)
PLAN_LANES = 32768


def plan_group(B: int, lanes: int = PLAN_LANES, groups=GROUPS) -> int:
    """The widest of ``groups`` whose B x G lanes stay within ``lanes``
    (the narrowest where none does)."""
    fit = [g for g in groups if B * g <= lanes]
    return max(fit) if fit else min(groups)


def launch_plan(B: int, group: int | None = None):
    """K5's launch for B envs: (lanes per env, threads per block, blocks).
    Each env is one group of ``group`` lanes (:func:`plan_group` where
    None) inside a warp, 32 envs a block; the lanes of the last block's
    groups past env B - 1 run env B - 1 and store nothing.  The kernel
    refuses a group size it was not built with."""
    g = plan_group(B) if group is None else group
    if g not in GROUPS:
        raise ValueError(f"K5 is built for groups of {GROUPS} lanes, not {g}")
    return g, 32 * g, -(-B // 32)


# K6's launch (csrc/cartpole_policy_rollout.cu): one env over a group of
# lanes of a warp, 32 envs a block.  A group of 8 splits the dual MLP's sums
# (csrc/lane_group.cuh::dual_mlp_group, a row of shared memory an env); one
# lane an env runs the one-thread MLP in registers.  The group pays while
# the card has idle issue slots and loses once its lanes' repeated step and
# its rows of shared memory fill the card: on an H100 8 lanes an env were
# fastest or within 6% of the fastest at B = 4096-16384, one lane from
# 32768 (H = 64 and 128, PERF.md).  So the plan takes 8 lanes while B x 8
# lanes stay within POLICY_PLAN_LANES, one above.
POLICY_GROUPS = (1, 8)
POLICY_PLAN_LANES = 131072
# The observation instances (observation noise, goal rows: csrc/obs_ext.cuh)
# are built for 8 lanes an env only, at every B.
OBS_GROUP = 8


def policy_launch_plan(B: int, hidden: int, group: int | None = None, obs_dim: int = 0):
    """A policy kernel's launch (K6; K8 through ``fast_quad_planar``) for B
    envs at hidden width ``hidden``: (lanes per env, threads per block,
    blocks, dynamic shared-memory bytes).  Each env is one group of
    ``group`` lanes (:func:`plan_group` over POLICY_GROUPS within
    POLICY_PLAN_LANES where None; ``OBS_GROUP`` for the observation
    instance, ``obs_dim`` > 0) inside a warp, 32 envs a block, each group of
    8 lanes with its row of shared memory (``fast_policy.group_row``, at
    most 66,048 bytes a block, 82,432 with the observation row); the lanes
    of the last block's groups past env B - 1 run env B - 1 and store
    nothing.  The kernel refuses a group size it was not built with."""
    FP.check_obs(obs_dim)
    if obs_dim:
        g = OBS_GROUP if group is None else group
        if g != OBS_GROUP:
            raise ValueError(f"the observation instances are built for {OBS_GROUP} lanes, not {g}")
    else:
        g = plan_group(B, POLICY_PLAN_LANES, POLICY_GROUPS) if group is None else group
        if g not in POLICY_GROUPS:
            raise ValueError(f"the policy kernels are built for groups of {POLICY_GROUPS} lanes, "
                             f"not {g}")
    FP.check_hidden(hidden)
    return g, 32 * g, -(-B // 32), 32 * FP.group_row(hidden, obs_dim) * 4 if g > 1 else 0


def supports(cfg, allow_normalized: bool = False) -> bool:
    """True if the CartPole config is in the whole-rollout engines'
    envelope: the JAX package's (fast_cartpole.py:56).
    ``allow_normalized`` asks for the policy engine's envelope: it maps the
    normalized action space in-kernel.  Both engines admit a single scalar
    observation white noise, as the JAX package's do: the constant-action
    engine never reads the observation, so its rows do not change, and the
    policy engine draws it in-kernel."""
    ti = {**C._DEFAULT_TASK_INFO, **(cfg.task_info or {})}
    has_d, fl = FE.dist_envelope_flags(cfg)
    return (
        cfg.cost in ("rl_reward", "quadratic")
        and (allow_normalized or not cfg.normalized_rl_action_space)
        and (cfg.task == "stabilization"
             or (cfg.task == "traj_tracking"
                 and ti.get("trajectory_type") in ("figure8", "circle", "square")))
        and int(cfg.obs_goal_horizon) == 0
        and (not has_d["dynamics"] or fl["impulse"])
        and (not has_d["action"] or fl["act_noise"])
        and (not has_d["observation"] or fl["obs_noise"])
        and cfg.adversary_disturbance is None
        and not cfg.done_on_violation
        and not cfg.use_constraint_penalty
        and (cfg.constraints is None or box_bounds_view(cfg.constraints, _NX, 1) is not None)
    )


def build_engine_params(env, steps_per_call: int, allow_normalized: bool = False) -> dict:
    """Static engine-parameter dict from a CartPole env (the JAX package's
    keys, fast_cartpole.py:380-506).  The flags are :func:`supports`'."""
    cfg = env.config
    if not supports(cfg, allow_normalized=allow_normalized):
        raise ValueError("config outside the fast-cartpole envelope (supports())")
    ti = {**C._DEFAULT_TASK_INFO, **(cfg.task_info or {})}

    # Randomization bounds in counter-slot order: 0..2 inertia, 3..6 state.
    iprop = cfg.inertial_prop or {}
    nominal = [float(iprop.get("pole_length", 1.0)), float(iprop.get("pole_mass", 0.1)),
               float(iprop.get("cart_mass", 1.0))]
    init_state = cfg.init_state or {}
    if isinstance(init_state, (list, tuple, np.ndarray)):
        init_state = dict(zip([f"init_{s}" for s in C.STATE_LABELS], np.asarray(init_state, float)))
    nominal += [float(init_state.get(f"init_{s}", 0.0)) for s in C.STATE_LABELS]
    inertial = {**C._DEFAULT_INERTIAL_RAND, **(cfg.inertial_prop_randomization_info or {})} \
        if cfg.randomized_inertial_prop else {}
    init_rand = {**C._DEFAULT_INIT_RAND, **(cfg.init_state_randomization_info or {})} \
        if cfg.randomized_init else {}
    names = ["pole_length", "pole_mass", "cart_mass"] + [f"init_{s}" for s in C.STATE_LABELS]
    infos = [inertial] * 3 + [init_rand] * 4
    lo = [float(i[n]["low"]) if n in i else 0.0 for n, i in zip(names, infos)]
    hi = [float(i[n]["high"]) if n in i else 0.0 for n, i in zip(names, infos)]

    if cfg.task == "stabilization":
        task, x_goal = "stab", tuple(float(v) for v in np.asarray(env.x_goal, float).reshape(-1))
        traj_type, traj_w, traj_scale, period = "none", 0.0, 0.0, 1.0
        x_axis_sel, plane_off = -1, (0.0, 0.0)
    else:
        task, x_goal = "traj", (0.0,) * 4
        plane = ti.get("trajectory_plane", "zx")
        off = ti.get("trajectory_position_offset", (0.0, 0.0))
        plane_off = (float(off[0]), float(off[1]))
        # Which curve component lands on the x axis (X_GOAL reads pos[:, 0]).
        x_axis_sel = 0 if plane[0] == "x" else (1 if plane[1] == "x" else -1)
        traj_type = ti.get("trajectory_type")
        period = cfg.episode_len_sec / float(ti.get("num_cycles", 1))
        traj_w = 2.0 * math.pi / period
        traj_scale = float(ti.get("trajectory_scale", 1.0))

    c_s_lo, c_s_hi, c_u_lo, c_u_hi, u_check = FE.constraint_box(env, _NX, 1)
    return dict(
        steps=steps_per_call,
        n_sub=cfg.pyb_freq // cfg.ctrl_freq,
        dt=1.0 / cfg.pyb_freq,
        ctrl_dt=1.0 / cfg.ctrl_freq,
        g=C.GRAVITY,
        a_low=float(env.spaces.action_low[0]),
        a_high=float(env.spaces.action_high[0]),
        normalized=bool(cfg.normalized_rl_action_space),
        act_scale=float(C.ACTION_THRESHOLD),
        u_goal=float(env.u_goal[0]),
        rew_act_w=float(np.ravel(cfg.rew_act_weight)[0]),
        rew_state_w=tuple(np.broadcast_to(np.asarray(cfg.rew_state_weight, float), (4,)).tolist()),
        rew_exp=bool(cfg.rew_exponential),
        q_weight=tuple(np.broadcast_to(
            np.asarray(1.0 if cfg.q_weight is None else cfg.q_weight, float).ravel(), (4,)).tolist()),
        r_weight=float(np.ravel(1.0 if cfg.r_weight is None else cfg.r_weight)[0]),
        s_low=tuple(float(v) for v in c_s_lo),
        s_high=tuple(float(v) for v in c_s_hi),
        u_check=u_check,
        u_low=float(c_u_lo[0]),
        u_high=float(c_u_hi[0]),
        x_threshold=float(C.X_THRESHOLD),
        theta_threshold=float(C.THETA_THRESHOLD),
        done_oob=bool(cfg.done_on_out_of_bound),
        count_viol=cfg.constraints is not None,
        max_steps=float(int(cfg.episode_len_sec * cfg.ctrl_freq)),
        stab_tol=float(ti.get("stabilization_goal_tolerance", 0.0)),
        impulse=FE.impulse_spec(cfg),
        act_noise_std=FE.act_noise_std(cfg),
        task=task, x_goal=x_goal,
        traj_type=traj_type, traj_w=traj_w, traj_scale=traj_scale, traj_period=float(period),
        x_axis_sel=x_axis_sel, plane_off=plane_off,
        cost={"quadratic": "quad"}.get(cfg.cost, "rl"),
        rand_nominal=tuple(nominal), rand_lo=tuple(lo), rand_hi=tuple(hi),
        obs_noise_std=FE.obs_noise_std(cfg),
    )


# --------------------------------------------------------------------------
# The control step both kernels share, plain PyTorch (fast_cartpole.py:100-261).
# --------------------------------------------------------------------------

def impulse_force(p, step_f, offset):
    """The impulse schedule at control-step rows ``step_f``
    (fast_env.py:356-366): ``exp(k log decay)`` inside the pulse."""
    mag, dur, decay = p["impulse"]
    peak = offset + float(int(dur / 2))
    po = (step_f - peak).abs()
    dec = torch.where(po < dur / 2.0,
                      torch.exp(po * math.log(decay)) if decay != 1.0 else torch.ones_like(po),
                      torch.zeros_like(po))
    return torch.where(step_f >= offset, mag * dec, torch.zeros_like(dec))


def axis_goal(p, step_f, sel):
    """Position and velocity of the closed-form curve on the world axis
    whose curve component is ``sel`` (0 or 1; else zeros)."""
    zero = torch.zeros_like(step_f)
    if sel not in (0, 1):
        return zero, zero
    a_p, b_p, a_v, b_v = FE.eval_curve(p, step_f * p["ctrl_dt"])
    return (a_p + p["plane_off"][0], a_v) if sel == 0 else (b_p + p["plane_off"][1], b_v)


def finite_rows(s):
    """The kernels' finite test, ``(s == s) & (|s| < 3.0e38)``
    (fast_cartpole.py:212-218): values above 3e38 count as non-finite."""
    ok = None
    for v in s:
        k = (v == v) & (v.abs() < 3.0e38)
        ok = k if ok is None else ok & k
    return ok


def episode_stats(stats, rew, violf, done):
    """The 7 statistics rows after a step."""
    donef = done.to(torch.float32)
    ep_ret, ep_len, ep_vio = stats[0] + rew, stats[1] + 1.0, stats[2] + violf
    return [ep_ret * (1.0 - donef), ep_len * (1.0 - donef), ep_vio * (1.0 - donef),
            stats[3] + donef, stats[4] + donef * ep_ret, stats[5] + donef * ep_len,
            stats[6] + donef * ep_vio]


def _fc_cart(s, force, half_l, Mm, ml, pm, g):
    """Cart-pole derivative on rows (fast_cartpole.py:85-97)."""
    sin_t, cos_t = torch.sin(s[2]), torch.cos(s[2])
    temp = (force + ml * (s[3] * s[3]) * sin_t) / Mm
    theta_dd = (g * sin_t - cos_t * temp) / (half_l * (4.0 / 3.0 - pm * (cos_t * cos_t) / Mm))
    x_dd = temp - ml * theta_dd * cos_t / Mm
    return (s[1], x_dd, s[3], theta_dd)


def step_rows(p, carry, force_pre, act_raw, noise_u=None):
    """One control step on the 18 rows.

    ``force_pre``: the preprocessed force (pre noise: the reward's action
    error); ``act_raw``: the commanded action (the input-constraint test);
    ``noise_u``: the two Philox uniforms of the action white noise.
    Returns ``(new_rows, rew, done, trunc, violf, s_post)``, ``s_post`` the
    post-step state after the freeze and before the auto-reset."""
    s = tuple(carry[:_NX])
    pl_len, pm, cm = carry[_R_PL], carry[_R_PM], carry[_R_CM]
    step_f, offset = carry[_R_STEP], carry[_R_OFFSET]
    zero_t = torch.zeros_like(step_f)

    act_err = force_pre - p["u_goal"]
    force = force_pre
    if p["act_noise_std"] > 0.0:
        force = force + p["act_noise_std"] * torch.sqrt(-2.0 * torch.log(1.0 - noise_u[0])) \
            * torch.cos(philox.TWO_PI * noise_u[1])
    if p["impulse"] is not None:
        force = force + impulse_force(p, step_f, offset)

    half_l = pl_len / 2.0
    Mm = cm + pm
    ml = pm * half_l
    fc = lambda sv: _fc_cart(sv, force, half_l, Mm, ml, pm, p["g"])  # noqa: E731
    dt = p["dt"]
    for _ in range(p["n_sub"]):
        k1 = fc(s)
        k2 = fc(tuple(si + dt / 2 * ki for si, ki in zip(s, k1)))
        k3 = fc(tuple(si + dt / 2 * ki for si, ki in zip(s, k2)))
        k4 = fc(tuple(si + dt * ki for si, ki in zip(s, k3)))
        s = tuple(si + dt / 6 * (a + 2 * b + 2 * c + d) for si, a, b, c, d in zip(s, k1, k2, k3, k4))

    if p["task"] == "stab":
        goal = [torch.full_like(step_f, v) for v in p["x_goal"]]
    else:
        goal = [*axis_goal(p, step_f, p["x_axis_sel"]), zero_t, zero_t]

    viol = None
    for k in range(_NX):
        out_k = (s[k] < p["s_low"][k]) | (s[k] > p["s_high"][k])
        viol = out_k if viol is None else viol | out_k
    if p["u_check"]:
        viol = viol | (act_raw < p["u_low"]) | (act_raw > p["u_high"])
    violf = viol.to(torch.float32) if p["count_viol"] else zero_t

    if p["cost"] == "quad":
        dist = 0.5 * p["r_weight"] * act_err * act_err
        for k in range(_NX):
            e = s[k] - goal[k]
            dist = dist + 0.5 * p["q_weight"][k] * e * e
        rew = -dist
    else:
        dist = p["rew_act_w"] * act_err * act_err
        for k in range(_NX):
            e = s[k] - goal[k]
            dist = dist + p["rew_state_w"][k] * e * e
        rew = torch.exp(-dist) if p["rew_exp"] else -dist

    done = zero_t > 1.0
    if p["cost"] == "quad" and p["task"] == "stab":
        d2 = zero_t
        for k in range(_NX):
            e = s[k] - goal[k]
            d2 = d2 + e * e
        done = done | (torch.sqrt(d2) < p["stab_tol"])
    if p["done_oob"]:
        done = done | (s[0].abs() > p["x_threshold"]) | (s[2].abs() > p["theta_threshold"])
    # Non-finite safety net: freeze the last finite state, zero the reward.
    finite = finite_rows(s)
    s = tuple(torch.where(finite, s[k], carry[k]) for k in range(_NX))
    rew = torch.where(finite, rew, zero_t)
    done = done | ~finite

    new_step = step_f + 1.0
    timeout = new_step >= p["max_steps"]
    trunc = timeout & ~done
    done = done | timeout
    stats = episode_stats(carry[_R_STATS:_R_STATS + 7], rew, violf, done)

    # Masked auto-reset from the counter stream (cartpole._reset_core slots).
    es = ctr_prng.seed_from_row(carry[_R_SEED])
    base = ctr_prng.episode_base(es, carry[_R_EP].to(torch.int32) + 1)
    u = [ctr_prng.slot_uniform(base, k) for k in range(8)]
    nm, lo, hi = p["rand_nominal"], p["rand_lo"], p["rand_hi"]
    new_x = [torch.where(done, nm[3 + k] + lo[3 + k] + u[3 + k] * (hi[3 + k] - lo[3 + k]), s[k])
             for k in range(_NX)]
    new_inert = [torch.where(done, nm[i] + lo[i] + u[i] * (hi[i] - lo[i]), c)
                 for i, c in enumerate((pl_len, pm, cm))]
    new_off = torch.where(done, torch.floor(u[7] * p["max_steps"]), offset)
    new_step = torch.where(done, zero_t, new_step)
    new_ep = torch.where(done, carry[_R_EP] + 1.0, carry[_R_EP])
    rows = new_x + new_inert + [new_step, new_off] + stats + [carry[_R_SEED], new_ep]
    return rows, rew, done, trunc, violf, list(s)


def preprocess(p, act):
    """The commanded action -> the force the step takes (pre noise)."""
    if p["normalized"]:
        return p["act_scale"] * torch.clamp(act, -1.0, 1.0)
    return torch.clamp(act, p["a_low"], p["a_high"])


def _noise_u(p, seed, it, env):
    if p["act_noise_std"] > 0.0:
        return philox.uniforms(seed, it, env, 2, philox.SITE_ACTION)
    return None


def cartpole_rollout_plain(p, rows, action, seed):
    """Plain PyTorch version of K5: ``p['steps']`` control steps of the
    constant ``action`` (1, B) on ``rows`` (18, B); ``seed`` (int32, one
    element) keys the action white noise."""
    carry = list(rows.unbind(0))
    act = action[0]
    force = preprocess(p, act)
    env = torch.arange(rows.shape[1], device=rows.device)
    for it in range(p["steps"]):
        carry = step_rows(p, carry, force, act, _noise_u(p, seed, it, env))[0]
    return torch.stack(carry, 0)


def cartpole_policy_rollout_plain(p, rows, weights, seed):
    """Plain PyTorch version of K6: ``p['steps']`` policy-driven control
    steps on ``rows`` (18, B); returns (rows, traj (T, 14, B))."""
    env = torch.arange(rows.shape[1], device=rows.device)

    def step(carry, thr, act, it):
        return step_rows(p, carry, thr[0], act[0], _noise_u(p, seed, it, env))

    return FP.policy_rollout_loop(p, rows, weights, seed, _NX, 1, lambda a: preprocess(p, a), step,
                                  _R_STEP)


# --------------------------------------------------------------------------
# K5 and K6 on the card.
# --------------------------------------------------------------------------

class CurveParams(ctypes.Structure):
    """Host mirror of ``CurveParams`` in ``csrc/curve.cuh``."""

    _fields_ = [("traj_type", ctypes.c_int)] + [(n, ctypes.c_float) for n in (
        "traj_w", "traj_scale", "traj_neg_scale", "traj_sc_w", "traj_neg_sc_w",
        "traj_period", "traj_seg_period", "traj_speed", "traj_neg_speed")]


def curve_params(p) -> CurveParams:
    """The closed-form curve's constants, each the float32 rounding of the
    Python expression :func:`fast_env.eval_curve` evaluates."""
    c = CurveParams()
    c.traj_type = {"figure8": 0, "circle": 1}.get(p["traj_type"], 2)
    w, sc, period = p["traj_w"], p["traj_scale"], p["traj_period"]
    c.traj_w, c.traj_scale, c.traj_neg_scale = w, sc, -sc
    c.traj_sc_w, c.traj_neg_sc_w = sc * w, -sc * w
    c.traj_period, c.traj_seg_period = period, period / 4.0
    c.traj_speed, c.traj_neg_speed = sc / (period / 4.0), -(sc / (period / 4.0))
    return c


_F4 = ctypes.c_float * 4
_F7 = ctypes.c_float * 7


class CartPoleParams(ctypes.Structure):
    """Host mirror of ``CartPoleParams`` in ``csrc/cartpole.cuh``."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "steps", "n_sub", "cost", "task", "impulse", "decay_one", "act_noise", "u_check",
            "done_oob", "count_viol", "rew_exp", "normalized", "x_axis_sel")]
        + [(n, ctypes.c_float) for n in (
            "dt", "dt_half", "dt_sixth", "ctrl_dt", "g", "four_thirds", "a_low", "a_high",
            "act_scale", "u_goal", "rew_act_w", "r_half", "max_steps", "stab_tol",
            "x_threshold", "theta_threshold", "u_low", "u_high", "act_noise_std",
            "imp_mag", "imp_peak_shift", "imp_half_dur", "imp_log_decay")]
        + [("plane_off", ctypes.c_float * 2), ("x_goal", _F4), ("rew_state_w", _F4),
           ("q_half", _F4), ("s_low", _F4), ("s_high", _F4), ("rand_a", _F7), ("rand_b", _F7),
           ("curve", CurveParams)]
    )


def kernel_params(p) -> CartPoleParams:
    """The kernels' parameter struct: each float is the float32 rounding of
    the Python expression :func:`step_rows` evaluates."""
    c = CartPoleParams()
    c.steps, c.n_sub = int(p["steps"]), int(p["n_sub"])
    c.cost = 1 if p["cost"] == "quad" else 0
    c.task = 0 if p["task"] == "stab" else 1
    c.act_noise = int(p["act_noise_std"] > 0.0)
    c.u_check, c.done_oob = int(bool(p["u_check"])), int(bool(p["done_oob"]))
    c.count_viol, c.rew_exp = int(bool(p["count_viol"])), int(bool(p["rew_exp"]))
    c.normalized, c.x_axis_sel = int(bool(p["normalized"])), int(p["x_axis_sel"])
    dt = p["dt"]
    c.dt, c.dt_half, c.dt_sixth, c.ctrl_dt = dt, dt / 2, dt / 6, p["ctrl_dt"]
    c.g, c.four_thirds = p["g"], 4.0 / 3.0
    c.a_low, c.a_high, c.act_scale = p["a_low"], p["a_high"], p["act_scale"]
    c.u_goal, c.rew_act_w, c.r_half = p["u_goal"], p["rew_act_w"], 0.5 * p["r_weight"]
    c.max_steps, c.stab_tol = p["max_steps"], p["stab_tol"]
    c.x_threshold, c.theta_threshold = p["x_threshold"], p["theta_threshold"]
    c.u_low, c.u_high, c.act_noise_std = p["u_low"], p["u_high"], p["act_noise_std"]
    if p["impulse"] is not None:
        mag, dur, decay = p["impulse"]
        c.impulse, c.decay_one = 1, int(decay == 1.0)
        c.imp_mag, c.imp_peak_shift, c.imp_half_dur = mag, float(int(dur / 2)), dur / 2.0
        c.imp_log_decay = math.log(decay)
    c.plane_off[:] = p["plane_off"]
    c.x_goal[:], c.rew_state_w[:] = p["x_goal"], p["rew_state_w"]
    c.q_half[:] = [0.5 * q for q in p["q_weight"]]
    c.s_low[:], c.s_high[:] = p["s_low"], p["s_high"]
    nm, lo, hi = p["rand_nominal"], p["rand_lo"], p["rand_hi"]
    c.rand_a[:] = [a + b for a, b in zip(nm, lo)]
    c.rand_b[:] = [h - b for h, b in zip(hi, lo)]
    c.curve = curve_params(p)
    return c


def check_params_size(lib, name, params):
    """Raise unless the CUDA source's ``{name}_params_size()`` equals the
    ctypes mirror's size (the kernels take the struct by value)."""
    size = getattr(lib, f"{name}_params_size")()
    if size != ctypes.sizeof(params):
        raise RuntimeError(f"{type(params).__name__} differs between the host mirror "
                           f"({ctypes.sizeof(params)} bytes) and the CUDA source ({size})")


def cartpole_rollout(p, rows, action, seed):
    """K5: ``p['steps']`` control steps of a constant action for every env.
    rows (18, B) float32, action (1, B) float32, seed int32 (1,).

    CPU tensors take :func:`cartpole_rollout_plain`; CUDA tensors launch
    ``csrc/cartpole_rollout.cu``; anything else raises."""
    if all(t.device.type == "cpu" for t in (rows, action, seed)):
        return cartpole_rollout_plain(p, rows, action, seed)
    B = rows.shape[-1]
    dev = rows.device
    if not (dev.type == "cuda" and tuple(rows.shape) == (_NROWS, B)
            and tuple(action.shape) == (1, B) and philox.seed_ok(seed, dev)
            and all(t.device == dev and t.dtype == torch.float32 for t in (rows, action))):
        raise ValueError(
            "cartpole_rollout takes float32 rows (18, B), action (1, B) and an int32 seed on "
            f"one CUDA device; got {tuple(rows.shape)} {rows.dtype} {rows.device}, "
            f"{tuple(action.shape)} {action.dtype} {action.device}, seed {seed.dtype} {seed.device}")
    from safe_control_gym_torch import kernels

    rows, action = rows.contiguous(), action.contiguous()
    out = torch.empty_like(rows)
    if B == 0:
        return out
    params = kernel_params(p)
    lib = kernels.lib()
    check_params_size(lib, "cartpole", params)
    code = lib.cartpole_rollout(ctypes.addressof(params), seed.data_ptr(), rows.data_ptr(),
                                action.data_ptr(), out.data_ptr(), B, *launch_plan(B),
                                kernels.stream_ptr(dev))
    kernels.check(code, "cartpole_rollout")
    cartpole_rollout.launches += 1
    return out


cartpole_rollout.launches = 0


def policy_shapes(obs_dim: int, nu: int, H2: int):
    """Shapes of :func:`fast_policy.pack_weights`' tuple."""
    return ((H2, obs_dim), (H2, 1), (H2, H2), (H2, 1), (8, H2), (8, 1), (nu,))


def check_policy_inputs(name, rows, n_rows, weights, seed, obs_dim, nu, act):
    """Raise unless the policy kernels can take these CUDA tensors."""
    B, dev = rows.shape[-1], rows.device
    H2 = weights[0].shape[0]
    ok = (dev.type == "cuda" and tuple(rows.shape) == (n_rows, B) and philox.seed_ok(seed, dev)
          and all(tuple(t.shape) == s for t, s in zip(weights, policy_shapes(obs_dim, nu, H2)))
          and all(t.device == dev and t.dtype == torch.float32 for t in [rows, *weights]))
    if not ok or H2 % 2 or not 1 <= H2 // 2 <= FP.MAX_HIDDEN or act not in ("tanh", "relu"):
        raise ValueError(
            f"{name} takes float32 rows ({n_rows}, B), packed weights of hidden "
            f"1..{FP.MAX_HIDDEN} for obs {obs_dim} and {nu} actions, and an int32 seed on one "
            "CUDA device, tanh or "
            f"relu; got rows {tuple(rows.shape)} {rows.dtype} {rows.device}, weights "
            f"{[tuple(t.shape) for t in weights]}, act {act!r}")


def launch_policy(lib, entry, params, lead, nx, p, rows, weights, seed, out, traj, group):
    """Launch a policy kernel (K6, K8) through ``entry`` with the arguments
    ``lead`` between the params and the hidden width: its observation
    instance (``entry + '_obs'``, :func:`fast_policy.obs_ext`) where the
    config's observation is more than the ``nx`` state rows.  Returns the
    entry's code and whether the observation instance ran."""
    from safe_control_gym_torch import kernels

    wflat = FP.kernel_weights(weights)
    hidden, B = weights[0].shape[0] // 2, rows.shape[-1]
    args = (*lead, hidden, seed.data_ptr(), wflat.data_ptr(), rows.data_ptr(), out.data_ptr(),
            traj.data_ptr(), B)
    stream = kernels.stream_ptr(rows.device)
    ext = FP.obs_ext(p, nx)
    if ext is None:
        return getattr(lib, entry)(ctypes.addressof(params), *args,
                                   *policy_launch_plan(B, hidden, group), stream), False
    FP.check_obs_ext_size(lib)
    return getattr(lib, entry + "_obs")(ctypes.addressof(params), ctypes.addressof(ext), *args,
                                        *policy_launch_plan(B, hidden, group, ext.obs_dim),
                                        stream), True


def cartpole_policy_rollout(p, rows, weights, seed, group=None):
    """K6: the rollout of :func:`cartpole_policy_rollout_plain`.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/cartpole_policy_rollout.cu`` with ``group`` lanes per env
    (:func:`policy_launch_plan`'s pick where None; its observation instance
    with observation noise); anything else raises."""
    if all(t.device.type == "cpu" for t in (rows, seed, *weights)):
        return cartpole_policy_rollout_plain(p, rows, weights, seed)
    check_policy_inputs("cartpole_policy_rollout", rows, _NROWS, weights, seed, _NX, 1,
                        p["mlp_act"])
    from safe_control_gym_torch import kernels

    B = rows.shape[-1]
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    traj = torch.empty((p["steps"], TRAJ_ROWS, B), dtype=torch.float32, device=rows.device)
    if B == 0:
        return out, traj
    params = kernel_params(p)
    lib = kernels.lib()
    check_params_size(lib, "cartpole", params)
    code, obs = launch_policy(lib, "cartpole_policy_rollout", params,
                              (int(p["mlp_act"] == "relu"),), _NX, p, rows, weights, seed, out,
                              traj, group)
    kernels.check(code, "cartpole_policy_rollout")
    cartpole_policy_rollout.launches += 1
    cartpole_policy_rollout.obs_launches += obs
    return out, traj


# Launches of K6, and of its observation instance among them.
cartpole_policy_rollout.launches = cartpole_policy_rollout.obs_launches = 0


def reset_rows(p, env_seeds):
    """Fresh packed rows (18, B) for int32 ``env_seeds`` on their device:
    episode-0 draws from the counter stream in float32, as the general
    engine's reset, so both engines start from the same states."""
    es = env_seeds.to(torch.int32)
    dev = es.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    nm, lo, hi = (np.asarray(p[k], np.float32) for k in ("rand_nominal", "rand_lo", "rand_hi"))
    u_all = ctr_prng.uniform_slots(ctr_prng.episode_base(es, torch.zeros_like(es)), 8).T
    drawn = f32(nm + lo) + u_all[:, :7] * f32(hi - lo)  # (B, 7): pl, pm, cm, x0..3
    rows = torch.zeros((_NROWS, es.shape[0]), dtype=torch.float32, device=dev)
    rows[:_NX] = drawn[:, 3:7].T
    rows[_R_PL:_R_CM + 1] = drawn[:, :3].T
    rows[_R_OFFSET] = torch.floor(u_all[:, 7] * p["max_steps"])
    rows[_R_SEED] = ctr_prng.seed_to_row(es)
    return rows


def stats_of(rows, first):
    """Completed-episode means from the 7 statistics rows at ``first``."""
    d = dict(zip(FE._STATS_KEYS, rows[first:first + 7].double().sum(-1).tolist()))
    n = max(d["done_count"], 1.0)
    return {"episodes": d["done_count"], "mean_return": d["sum_return"] / n,
            "mean_length": d["sum_length"] / n, "mean_violations": d["sum_violations"] / n}


class FastCartPoleRollout:
    """Host wrapper of K5: packed state + one-launch rollout calls."""

    def __init__(self, env, num_envs: int, steps_per_call: int = 256, device=None):
        self.env = env
        self.B = num_envs
        self.steps = steps_per_call
        self.device = resolve_device(device)
        self.params = build_engine_params(env, steps_per_call)
        self.n_rows = _NROWS
        self._auto_seed = 1

    def reset(self, seed: int = 0, env_seeds=None):
        """Episode 0 of ``env_seeds`` (int32, (B,)) or of the port's per-env
        seeds for ``seed``."""
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, self.B, self.device)
        return reset_rows(self.params, torch.as_tensor(env_seeds, device=self.device))

    def pack(self, env_states):
        """Pack a batched general-engine ``CartPoleState`` into rows."""
        dev = self.device
        rows = torch.zeros((_NROWS, self.B), dtype=torch.float32, device=dev)
        rows[:_NX] = env_states.x.to(dev, torch.float32).T
        rows[_R_PL] = env_states.pole_length.to(dev, torch.float32)
        rows[_R_PM] = env_states.pole_mass.to(dev, torch.float32)
        rows[_R_CM] = env_states.cart_mass.to(dev, torch.float32)
        rows[_R_STEP] = env_states.ctrl_step.to(dev, torch.float32)
        offsets = env_states.dist_offsets.get("dynamics")
        if offsets is not None and offsets.shape[-1]:
            rows[_R_OFFSET] = offsets[:, 0].to(dev, torch.float32)
        rows[_R_SEED] = ctr_prng.seed_to_row(env_states.env_seed.to(dev))
        rows[_R_EP] = env_states.episode_idx.to(dev, torch.float32)
        return rows

    def states(self, rows):
        """(B, 4) state matrix from packed rows."""
        return rows[:_NX].T

    def stats(self, rows):
        return stats_of(rows, _R_STATS)

    def prepare_action(self, action):
        """A scalar or (B,) force command as the (1, B) device tensor that
        ``run`` takes."""
        a = torch.as_tensor(action, dtype=torch.float32, device=self.device).reshape(-1)
        return a.expand(self.B).reshape(1, self.B).contiguous() if a.numel() == 1 \
            else a.reshape(1, self.B).contiguous()

    def run(self, rows, action, seed=None):
        """One launch = ``steps_per_call`` env steps for all B envs;
        ``seed`` keys the call's action white noise (auto-incremented)."""
        if not (torch.is_tensor(action) and tuple(action.shape) == (1, self.B)):
            action = self.prepare_action(action)
        if seed is None:
            seed, self._auto_seed = self._auto_seed, self._auto_seed + 1
        return cartpole_rollout(self.params, rows, action, philox.seed_tensor(seed, self.device))


class FastCartPolePolicyRollout:
    """Host wrapper of K6: one launch = T policy-driven env steps for B
    envs, returning the whole PPO trajectory record (the API of
    ``fast_policy.FastPolicyRollout``)."""

    def __init__(self, env, num_envs: int, steps_per_call: int, mlp_hidden: int = 64,
                 mlp_act: str = "tanh", device=None):
        self.env = env
        self.B = num_envs
        self.T = steps_per_call
        self.H = mlp_hidden
        self.device = resolve_device(device)
        FP._act_fn(mlp_act)
        FP.check_hidden(mlp_hidden)
        self.params = build_engine_params(env, steps_per_call, allow_normalized=True)
        self.params["mlp_act"] = mlp_act
        self.obs_dim, self.nu = _NX, 1
        self.traj_rows = TRAJ_ROWS
        self.n_rows = _NROWS
        self._auto_seed = 1

    def reset(self, seed: int = 0, env_seeds=None):
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, self.B, self.device)
        return reset_rows(self.params, torch.as_tensor(env_seeds, device=self.device))

    pack_weights = staticmethod(FP.pack_weights)

    def unpack_traj(self, traj):
        """(T, 14, B) record -> PPO field dict in (T, B, ...) layout."""
        return FP.unpack_record(traj, self.obs_dim, self.nu)

    def states(self, rows):
        """(B, 4) state matrix from packed rows."""
        return rows[:_NX].T

    def observe(self, rows, generator=None):
        """(B, 4) observation: the state, with the observation noise drawn
        from ``generator`` where the config has one and it is given."""
        return FP.observe_rows(self.params, self.env, self.states(rows), rows[_R_STEP], generator)

    def run(self, rows, weights, seed=None):
        """One launch = T policy-driven env steps.  Returns (rows, traj)."""
        if seed is None:
            seed, self._auto_seed = self._auto_seed, self._auto_seed + 1
        return cartpole_policy_rollout(self.params, rows, weights,
                                       philox.seed_tensor(seed, self.device))
