"""CartPole environment on batched PyTorch tensors.

Port of ``safe_control_gym_tpu/envs/cartpole.py`` (the frictionless
cart-pole of upstream safe-control-gym, Florian 2007 / Barto et al.):

    state x = [x, x_dot, theta, theta_dot], input u = horizontal force F
    Mm   = m_cart + m_pole,  ml = m_pole * l   (l = half pole length)
    temp = (F + ml * theta_dot^2 sin(theta)) / Mm
    theta_dd = (g sin(theta) - cos(theta) temp) / (l (4/3 - m_pole cos^2(theta)/Mm))
    x_dd = temp - ml * theta_dd cos(theta) / Mm

integrated with RK4 at the physics rate.  The step clips (or scales the
normalized action to a force), adds the adversary's action offset and the
action disturbances, the dynamics disturbances and the adversary's force
on the cart (``set_adversary_control`` in ``extras``, RARL/RAP's), computes
the rl_reward or quadratic cost, the out-of-bound done on x and theta, the
goal capture, constraint violations (every form, ``envs/constraints.py``),
the non-finite freeze and the time limit.  Every env of a batch draws its
own inertia and initial state from the counter PRNG (``ops/ctr_prng.py``,
slots 0..2 inertia, 3..6 initial state, 7 a single dynamics offset, then
any other randomized offsets), as the JAX package and the whole-rollout
engine (``parallel/fast_cartpole.py``) draw them; the JAX package draws the
other offsets from threefry, so those agree in distribution only.
``env.symbolic`` is the a-priori model on nominal parameters
(``models/dynamics_model.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from safe_control_gym_torch.envs import benchmark as bm
from safe_control_gym_torch.envs.benchmark import Cost, EnvSpaces, FnEnv, Task
from safe_control_gym_torch.envs.constraints import build_constraints
from safe_control_gym_torch.envs.disturbances import (build_disturbances, num_offset_slots,
                                                       scheduled_offsets)
from safe_control_gym_torch.models.dynamics_model import DynamicsModel
from safe_control_gym_torch.ops import ctr_prng
from safe_control_gym_torch.ops.integrators import rk4_step
from safe_control_gym_torch.utils.device import resolve_device

BIG = 1e30


@dataclasses.dataclass(frozen=True)
class CartPoleConfig:
    """The JAX package's config fields and defaults."""

    seed: Optional[int] = None
    ctrl_freq: int = 50
    pyb_freq: int = 50
    episode_len_sec: float = 10.0
    task: str = "stabilization"
    task_info: Optional[dict] = None
    cost: str = "rl_reward"
    normalized_rl_action_space: bool = False
    # Initial state.
    init_state: Optional[Any] = None
    randomized_init: bool = True
    init_state_randomization_info: Optional[dict] = None
    # Inertial properties: {pole_length, pole_mass, cart_mass}.
    inertial_prop: Optional[dict] = None
    prior_prop: Optional[dict] = None
    randomized_inertial_prop: bool = False
    inertial_prop_randomization_info: Optional[dict] = None
    # Constraints / disturbances.
    constraints: Optional[tuple] = None
    done_on_violation: bool = False
    use_constraint_penalty: bool = False
    constraint_penalty: float = -1.0
    disturbances: Optional[dict] = None
    adversary_disturbance: Optional[str] = None
    adversary_disturbance_offset: float = 0.0
    adversary_disturbance_scale: float = 0.01
    # RL reward shaping.
    rew_state_weight: Any = 1.0
    rew_act_weight: Any = 0.0001
    rew_exponential: bool = True
    done_on_out_of_bound: bool = True
    obs_goal_horizon: int = 0
    # Engine.
    dtype: Any = torch.float32
    q_weight: Optional[Any] = None
    r_weight: Optional[Any] = None


# Default randomization infos (verbose_api.yaml:15-52).
_DEFAULT_INIT_RAND = {
    "init_x": {"distrib": "uniform", "low": -0.05, "high": 0.05},
    "init_x_dot": {"distrib": "uniform", "low": -0.05, "high": 0.05},
    "init_theta": {"distrib": "uniform", "low": -0.05, "high": 0.05},
    "init_theta_dot": {"distrib": "uniform", "low": -0.05, "high": 0.05},
}
_DEFAULT_INERTIAL_RAND = {
    "pole_length": {"distrib": "uniform", "low": -0.05, "high": 0.05},
    "cart_mass": {"distrib": "uniform", "low": -0.05, "high": 0.05},
    "pole_mass": {"distrib": "uniform", "low": -0.05, "high": 0.05},
}
_DEFAULT_TASK_INFO = {
    "stabilization_goal": [0.0],
    "stabilization_goal_tolerance": 0.05,
    "trajectory_type": "circle",
    "num_cycles": 1,
    "trajectory_plane": "zx",
    "trajectory_position_offset": [0.0, 0.0],
    "trajectory_scale": 0.2,
}

GRAVITY = 9.8
ACTION_THRESHOLD = 10.0  # |F| <= 10 N (upstream cartpole action bound)
X_THRESHOLD = 2.4
THETA_THRESHOLD = 90.0 * np.pi / 180.0
STATE_LABELS = ("x", "x_dot", "theta", "theta_dot")
NX, NU = 4, 1
_CHANNELS = ("observation", "action", "dynamics")


@dataclasses.dataclass
class CartPoleState:
    """Per-env state of a batch; every tensor has a leading (B,) axis."""

    x: torch.Tensor  # (B, 4)
    ctrl_step: torch.Tensor  # int32
    pyb_step: torch.Tensor  # int32
    env_seed: torch.Tensor  # int32 counter-PRNG identity (ops/ctr_prng.py)
    episode_idx: torch.Tensor  # int32
    pole_length: torch.Tensor  # per-episode randomized physical params
    pole_mass: torch.Tensor
    cart_mass: torch.Tensor
    dist_offsets: dict  # channel -> (B, n_scheduled) int32
    dist_walk: dict  # channel -> (B, walk_dim) brownian walks
    cnstr_violation: torch.Tensor  # bool
    adv_force: torch.Tensor  # (B, 1) the adversary's force on the cart, next step only
    adv_act: torch.Tensor  # (B, 1) the adversary's action offset, next step only

    def replace(self, **kw) -> "CartPoleState":
        return dataclasses.replace(self, **kw)


def cartpole_fc(x, u, pole_length, pole_mass, cart_mass, g=GRAVITY):
    """Continuous-time cart-pole ODE (cartpole.py:132-143) on batched
    tensors: x (B, 4), u (B, 1), per-env params (B,) -> x_dot (B, 4)."""
    x_dot, theta, theta_dot = x[..., 1], x[..., 2], x[..., 3]
    force = u[..., 0]
    half_l = pole_length / 2.0
    Mm = cart_mass + pole_mass
    ml = pole_mass * half_l
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    temp = (force + ml * theta_dot**2 * sin_t) / Mm
    theta_dd = (g * sin_t - cos_t * temp) / (half_l * (4.0 / 3.0 - pole_mass * cos_t**2 / Mm))
    x_dd = temp - ml * theta_dd * cos_t / Mm
    return torch.stack([x_dot, x_dd, theta_dot, theta_dd], -1)


def _weights_vec(w, dim):
    w = np.asarray(w, dtype=float).reshape(-1)
    if w.size == 1:
        w = np.full(dim, w[0])
    if w.size != dim:
        raise ValueError(f"weight size {w.size} != {dim}")
    return w


def make_cartpole(config: CartPoleConfig = CartPoleConfig(), device=None) -> FnEnv:
    """Build the batched CartPole env on ``device`` (CUDA by default)."""
    cfg = config
    if cfg.adversary_disturbance not in (None, "action", "dynamics"):
        raise ValueError(f"unknown adversary_disturbance {cfg.adversary_disturbance!r}")
    device = resolve_device(device)
    dtype = cfg.dtype
    task = Task(cfg.task)
    cost = Cost(cfg.cost)
    if cost == Cost.COMPETITION:
        raise ValueError("CartPole has no competition cost")
    n_sub = bm.check_timing(cfg.pyb_freq, cfg.ctrl_freq)
    ctrl_dt = 1.0 / cfg.ctrl_freq
    pyb_dt = 1.0 / cfg.pyb_freq
    max_steps = int(cfg.episode_len_sec * cfg.ctrl_freq)
    task_info = {**_DEFAULT_TASK_INFO, **(cfg.task_info or {})}

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    iprop = cfg.inertial_prop or {}
    nominal_inertia = [float(iprop.get("pole_length", 1.0)), float(iprop.get("pole_mass", 0.1)),
                       float(iprop.get("cart_mass", 1.0))]

    state_low = np.array([-X_THRESHOLD * 2, -BIG, -THETA_THRESHOLD * 2, -BIG])
    state_high = -state_low
    if cfg.normalized_rl_action_space:
        act_low, act_high = np.array([-1.0]), np.array([1.0])
    else:
        act_low, act_high = np.array([-ACTION_THRESHOLD]), np.array([ACTION_THRESHOLD])

    # Goal references (X_GOAL over [x, x_dot, theta, theta_dot]).
    u_goal = np.zeros(1)
    if task == Task.STABILIZATION:
        x_goal = np.array([float(task_info["stabilization_goal"][0]), 0.0, 0.0, 0.0])
    else:
        pos, vel, _ = bm.generate_trajectory(
            traj_type=task_info["trajectory_type"],
            traj_length=cfg.episode_len_sec,
            num_cycles=task_info["num_cycles"],
            traj_plane=task_info["trajectory_plane"],
            position_offset=task_info["trajectory_position_offset"],
            scaling=task_info["trajectory_scale"],
            sample_time=ctrl_dt,
        )
        zero = np.zeros(pos.shape[0])
        x_goal = np.stack([pos[:, 0], vel[:, 0], zero, zero], -1)

    mul = 1
    if cost == Cost.RL_REWARD and cfg.obs_goal_horizon > 0:
        mul = (1 + cfg.obs_goal_horizon) if task == Task.TRAJ_TRACKING else 2
    spaces = EnvSpaces(
        state_low=state_low, state_high=state_high, action_low=act_low, action_high=act_high,
        obs_low=np.concatenate([state_low] * mul), obs_high=np.concatenate([state_high] * mul),
    )

    constraints = build_constraints(cfg.constraints, spaces, device, dtype)
    dist_specs = cfg.disturbances or {}
    dist_progs = {
        ch: build_disturbances(dist_specs.get(ch), dim, cfg.episode_len_sec, cfg.ctrl_freq,
                               channel=ch, pyb_freq=cfg.pyb_freq)
        for ch, dim in zip(_CHANNELS, (NX, NU, NU))
    }
    walk_dims = {ch: p.walk_dim if p is not None else 0 for ch, p in dist_progs.items()}
    n_slots = 8 + num_offset_slots(dist_progs)

    # Randomization infos merge into the defaults (unlike the quadrotor's).
    init_rand = {**_DEFAULT_INIT_RAND, **(cfg.init_state_randomization_info or {})}
    inertial_rand = {**_DEFAULT_INERTIAL_RAND, **(cfg.inertial_prop_randomization_info or {})}
    init_state = cfg.init_state or {}
    if isinstance(init_state, (list, tuple, np.ndarray)):
        init_state = dict(zip([f"init_{s}" for s in STATE_LABELS], np.asarray(init_state)))

    rew_state_w = dev(_weights_vec(cfg.rew_state_weight, NX))
    rew_act_w = dev(_weights_vec(cfg.rew_act_weight, NU))
    Q = dev(np.diag(_weights_vec(cfg.q_weight, NX)) if cfg.q_weight is not None else np.eye(NX))
    R = dev(np.diag(_weights_vec(cfg.r_weight, NU)) if cfg.r_weight is not None else np.eye(NU))
    x_goal_t = dev(np.asarray(x_goal, np.float32))
    u_goal_t = dev(np.asarray(u_goal, np.float32))
    a_low_t, a_high_t = dev(act_low), dev(act_high)
    goal_tol = float(task_info["stabilization_goal_tolerance"])

    # Counter-slot order: 0..2 inertia (pole_length, pole_mass, cart_mass),
    # 3..6 initial state; host float32 nominal+low and high-low.
    names = ["pole_length", "pole_mass", "cart_mass"] + [f"init_{s}" for s in STATE_LABELS]
    infos = ([inertial_rand if cfg.randomized_inertial_prop else {}] * 3
             + [init_rand if cfg.randomized_init else {}] * NX)
    rand_lo = np.asarray([float(i[n]["low"]) if n in i else 0.0
                          for n, i in zip(names, infos)], np.float32)
    rand_hi = np.asarray([float(i[n]["high"]) if n in i else 0.0
                          for n, i in zip(names, infos)], np.float32)
    nominal = np.asarray(nominal_inertia + [float(init_state.get(f"init_{s}", 0.0))
                                            for s in STATE_LABELS], np.float32)
    rand_a = dev(nominal + rand_lo)
    rand_b = dev(rand_hi - rand_lo)

    def _goal_rows(steps):
        return x_goal_t[torch.clamp(steps.long(), 0, x_goal_t.shape[0] - 1)]

    def _extend_obs(obs, next_step):
        """Goal-horizon obs augmentation (benchmark_env.py:406-420)."""
        if mul == 1:
            return obs
        if task == Task.TRAJ_TRACKING:
            idx = next_step[:, None] + torch.arange(
                cfg.obs_goal_horizon, device=device, dtype=next_step.dtype)
            return torch.cat([obs, _goal_rows(idx).reshape(obs.shape[0], -1)], -1)
        return torch.cat([obs, x_goal_t.reshape(1, -1).expand(obs.shape[0], -1)], -1)

    def _obs(state: CartPoleState):
        obs = state.x
        prog = dist_progs["observation"]
        if prog is not None:
            obs = prog.apply(state.dist_offsets["observation"], state.ctrl_step, obs,
                             (state.env_seed, state.episode_idx), state.pyb_step, state.x,
                             state.dist_walk["observation"])
        return _extend_obs(obs, state.ctrl_step + 1)

    def _reset_core(env_seed, episode_idx):
        """Counter-based reset draws (cartpole.py:279-328): slots 0..2
        inertia, 3..6 initial state, 7 a single dynamics offset, then any
        other randomized offsets (``disturbances.scheduled_offsets``)."""
        B = env_seed.shape[0]
        base = ctr_prng.episode_base(env_seed, episode_idx)
        u_all = ctr_prng.uniform_slots(base, n_slots).to(dtype)  # (n_slots, B)
        drawn = rand_a + u_all[:7].T * rand_b
        offsets = scheduled_offsets(dist_progs, u_all, 8, 7, max_steps)
        zi = torch.zeros(B, dtype=torch.int32, device=device)
        state = CartPoleState(
            x=drawn[:, 3:7].contiguous(),
            ctrl_step=zi,
            pyb_step=zi,
            env_seed=env_seed,
            episode_idx=episode_idx.to(torch.int32),
            pole_length=drawn[:, 0].contiguous(),
            pole_mass=drawn[:, 1].contiguous(),
            cart_mass=drawn[:, 2].contiguous(),
            dist_offsets=offsets,
            dist_walk={ch: torch.zeros((B, n), dtype=dtype, device=device)
                       for ch, n in walk_dims.items()},
            cnstr_violation=torch.zeros(B, dtype=torch.bool, device=device),
            adv_force=torch.zeros((B, NU), dtype=dtype, device=device),
            adv_act=torch.zeros((B, NU), dtype=dtype, device=device),
        )
        info = {}
        if constraints is not None:
            info["constraint_values_state"] = constraints.get_state_values(state.x)
        return state, _obs(state), info

    def reset(env_seeds):
        """Fresh batch: episode 0 of each env seed (int32, shape (B,))."""
        env_seeds = torch.as_tensor(env_seeds, device=device).to(torch.int32)
        return _reset_core(env_seeds, torch.zeros_like(env_seeds))

    def reset_episode(state: CartPoleState):
        """Next episode of the same envs (the auto-reset path)."""
        return _reset_core(state.env_seed, state.episode_idx + 1)

    def set_adversary_control(state: CartPoleState, adv_action):
        """The adversary's action for the next step (benchmark_env.py:256-266):
        clipped to [-1, 1], scaled and offset, as an action offset or a
        force on the cart, (B, 1)."""
        adv = torch.clamp(torch.as_tensor(adv_action, dtype=dtype, device=device), -1.0, 1.0)
        adv = (adv * cfg.adversary_disturbance_scale
               + cfg.adversary_disturbance_offset).reshape(state.x.shape[0], NU)
        if cfg.adversary_disturbance == "action":
            return state.replace(adv_act=adv)
        if cfg.adversary_disturbance == "dynamics":
            return state.replace(adv_force=adv)
        raise RuntimeError("adversary_disturbance is not configured for this env.")

    def step(state: CartPoleState, action):
        B = state.x.shape[0]
        identity = (state.env_seed, state.episode_idx)
        action = torch.as_tensor(action, dtype=dtype, device=device).reshape(B, NU)
        # Preprocess: clip, or scale the normalized action to a force.
        if cfg.normalized_rl_action_space:
            force = ACTION_THRESHOLD * torch.clamp(action, -1.0, 1.0)
        else:
            force = torch.clamp(action, a_low_t, a_high_t)
        preprocessed = force
        if cfg.adversary_disturbance == "action":
            # After preprocessing, before the passive action disturbances
            # (cartpole.py:363-366).
            force = force + state.adv_act
        if dist_progs["action"] is not None:
            force = dist_progs["action"].apply(
                state.dist_offsets["action"], state.ctrl_step, force, identity, state.pyb_step,
                state.x, state.dist_walk["action"])
        # Passive dynamics disturbance and the adversary's force: extra
        # horizontal force on the cart.
        ext_force = torch.zeros((B, NU), dtype=dtype, device=device)
        if dist_progs["dynamics"] is not None:
            ext_force = dist_progs["dynamics"].apply(
                state.dist_offsets["dynamics"], state.ctrl_step, ext_force, identity,
                state.pyb_step, state.x, state.dist_walk["dynamics"])
        ext_force = ext_force + state.adv_force

        def fc(xx, u):
            return cartpole_fc(xx, u + ext_force, state.pole_length, state.pole_mass,
                               state.cart_mass)

        x = state.x
        for _ in range(n_sub):
            x = rk4_step(fc, x, force, pyb_dt)
        # The brownian walks one step on (cartpole.py:391-399).
        walk = {ch: prog.evolve(state.dist_walk[ch], state.ctrl_step, identity)
                if prog is not None else state.dist_walk[ch] for ch, prog in dist_progs.items()}

        # Reward: the pre-increment step indexes the goal.
        goal = x_goal_t if task == Task.STABILIZATION else _goal_rows(state.ctrl_step)
        act_err = preprocessed - u_goal_t
        if cost == Cost.RL_REWARD:
            state_err = x - goal
            dist = (rew_state_w * state_err * state_err).sum(-1) + (
                rew_act_w * act_err * act_err).sum(-1)
            rew = torch.exp(-dist) if cfg.rew_exponential else -dist
        else:
            dx = x - goal
            rew = -(((0.5 * dx) @ Q * dx).sum(-1) + ((0.5 * act_err) @ R * act_err).sum(-1))

        # Done.
        goal_reached = torch.zeros(B, dtype=torch.bool, device=device)
        done = torch.zeros(B, dtype=torch.bool, device=device)
        if task == Task.STABILIZATION and cost == Cost.QUADRATIC:
            goal_reached = torch.linalg.norm(x - goal, dim=-1) < goal_tol
            done = done | goal_reached
        if cfg.done_on_out_of_bound:
            # Out of bound on x and theta only (upstream cartpole semantics).
            oob = (x[:, 0].abs() > X_THRESHOLD) | (x[:, 2].abs() > THETA_THRESHOLD)
            done = done | oob
        else:
            oob = torch.zeros(B, dtype=torch.bool, device=device)
        info = {"goal_reached": goal_reached, "out_of_bound": oob}
        err = x - goal
        info["mse"] = (err * err).sum(-1)

        # after_step: constraints, penalty, time limit (benchmark_env.py:422-463).
        violated = state.cnstr_violation
        if constraints is not None:
            c_val = constraints.get_values(x, action)
            violated = constraints.is_violated(c_val)
            info["constraint_values"] = c_val
            info["constraint_violation"] = violated.to(torch.int32)
            if cfg.done_on_violation:
                done = done | violated
            if cost == Cost.RL_REWARD and cfg.use_constraint_penalty:
                rew = torch.where(constraints.is_almost_active(c_val),
                                  rew + cfg.constraint_penalty, rew)
        # Non-finite safety net (cartpole.py:452-464): freeze the last finite
        # state, end the episode and zero the reward.
        finite = torch.isfinite(x).all(-1)
        x = torch.where(finite[:, None], x, state.x)
        done = done | ~finite
        rew = torch.where(finite, rew, torch.zeros_like(rew))

        new_ctrl = state.ctrl_step + 1
        timeout = new_ctrl >= max_steps
        info["TimeLimit.truncated"] = timeout & ~done
        done = done | timeout
        new_state = state.replace(x=x, ctrl_step=new_ctrl, pyb_step=state.pyb_step + n_sub,
                                  dist_walk=walk, cnstr_violation=violated,
                                  adv_force=torch.zeros_like(state.adv_force),
                                  adv_act=torch.zeros_like(state.adv_act))
        return new_state, _obs(new_state), rew.to(dtype), done, info

    def symbolic_fc(x_s, u_s):
        """The a-priori model on nominal parameters (cartpole.py:488-493)."""
        return cartpole_fc(x_s, u_s, *nominal_inertia)

    return FnEnv(
        reset=reset,
        step=step,
        spaces=spaces,
        symbolic=DynamicsModel(fc_func=symbolic_fc, nx=4, nu=1, dt=ctrl_dt),
        config=cfg,
        x_goal=x_goal,
        u_goal=u_goal,
        ctrl_freq=cfg.ctrl_freq,
        pyb_freq=cfg.pyb_freq,
        episode_len_sec=cfg.episode_len_sec,
        device=device,
        extras={"set_adversary_control": set_adversary_control,
                "reset_episode": reset_episode},
    )


def make_cartpole_from_dict(device=None, **kwargs) -> FnEnv:
    """Registry entry point: build from flat YAML kwargs on ``device``; keys
    that are not config fields are dropped."""
    known = {f.name for f in dataclasses.fields(CartPoleConfig)}
    return make_cartpole(CartPoleConfig(**{k: v for k, v in kwargs.items() if k in known}),
                         device=device)
