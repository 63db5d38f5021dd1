"""Competition main loop.

Port of ``safe_control_gym_tpu/competition/getting_started.py`` (the
counterpart of reference competition/getting_started.py:42-342): build the
(optionally firmware-wrapped) quadrotor env from a level config on
``device`` (CUDA unless the caller names one), instantiate the user
Controller, dispatch its commands each control step, accumulate
reward/collision/gate stats, and report steps/sec.

Two pieces of the JAX module have no counterpart here:

  * ``_enable_jit_cache``, JAX's persistent compilation cache: the port
    compiles nothing per run;
  * the per-config ``FirmwareWrapper`` memo (the JAX package's
    ``_WRAPPER_MEMO``, which reused a compiled fused block across ``run``
    calls): a wrapper costs nothing to build here, so each ``run`` builds
    its own.  The memo's fault (b) (its key omits ``verbose``, and it grows
    without bound) is gone with it.

The level's seed draws the JAX package's course: the env resets with the
env seed ``jax.random.key(seed)`` gives (``ops/ctr_prng.py::key_env_seed``).
``gui=True`` attaches the live viewer (``utils/viewer``); on a host with no
display it records each episode to ``gui_episode<N>.gif`` in the working
directory.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from safe_control_gym_torch.competition.competition_utils import Command, dispatch_command
from safe_control_gym_torch.competition.controller import Controller
from safe_control_gym_torch.controllers.firmware import FirmwareWrapper
from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
from safe_control_gym_torch.ops.ctr_prng import key_env_seed
from safe_control_gym_torch.utils.device import resolve_device
from safe_control_gym_torch.utils.viewer import LiveViewer, sync


def _env_config_from_level(level: dict, ctrl_freq: int, pyb_freq: int) -> QuadrotorConfig:
    keys = {f.name for f in QuadrotorConfig.__dataclass_fields__.values()}
    cfg = {k: v for k, v in level.items() if k in keys}
    cfg.update(quad_type=3, ctrl_freq=ctrl_freq, pyb_freq=pyb_freq)
    return QuadrotorConfig(**cfg)


def _reset_info(env, obs, ctrl_freq=None):
    """Reset-info dict with the fields user controllers consume
    (quadrotor.py:1136-1202).  ``ctrl_freq`` is the *command-loop* rate the
    controller runs at (25-30 Hz), not the wrapped env's firmware rate —
    the reference rewrites it the same way (getting_started.py:69-83)."""
    ctrl_freq = ctrl_freq or env.ctrl_freq
    return {
        "ctrl_timestep": 1.0 / ctrl_freq,
        "ctrl_freq": ctrl_freq,
        "episode_len_sec": env.episode_len_sec,
        "nominal_gates_pos_and_type": list(env.config.gates or []),
        "nominal_obstacles_pos": list(env.config.obstacles or []),
        "x_reference": np.asarray(env.x_goal if env.x_goal.ndim == 1 else env.x_goal[-1]),
        "u_reference": np.asarray(env.u_goal),
        "gate_dimensions": {
            "tall": {"shape": "square", "height": 1.0, "edge": 0.45},
            "low": {"shape": "square", "height": 0.525, "edge": 0.45},
        },
        "obstacle_dimensions": {"shape": "cylinder", "height": 1.05, "radius": 0.05},
        "physical_action_bounds": (
            np.asarray(env.spaces.action_low),
            np.asarray(env.spaces.action_high),
        ),
    }


def _sim_step(env, state, action):
    """One sim-only env step; reads obs, reward, done, collision and the
    target gate id back in one copy."""
    a = torch.from_numpy(np.asarray(action, np.float32).reshape(1, 4)).to(env.device)
    state, obs, rew, done, info = env.step(state, a)
    f = obs.dtype
    out = torch.cat([obs[0], rew, done.to(f), info["collision"].to(f),
                     info["current_target_gate_id"].to(f)]).cpu().numpy()
    step_info = {"collision": bool(out[14] > 0.5),
                 "current_target_gate_id": int(round(float(out[15])))}
    return state, out[:12], float(out[12]), bool(out[13] > 0.5), step_info


def run(
    level_config: dict,
    num_episodes: int = 1,
    use_firmware: bool = True,
    use_mpcc: bool = True,
    firmware_freq: int = 500,
    ctrl_freq: int = 25,
    verbose: bool = False,
    controller_cls=Controller,
    gui: bool = False,
    gui_every: int = 2,
    fused: bool = True,
    kd_omega_rp: float = 0.0,
    device=None,
):
    """Run competition episodes on ``device``; returns per-episode stats
    (reference getting_started.py run(), :42-342).

    ``gui=True`` shows every ``gui_every``-th control step in the live
    viewer, paced to the wall clock; without a display it writes
    ``gui_episode<N>.gif``."""
    device = resolve_device(device)
    episodes = []
    if use_firmware:
        # kd_omega_rp=0 is the competition stack's sim2real trim: the stock
        # attitude-rate-derivative gain (200) is tuned for a real MEMS gyro
        # and destabilizes against the SITL's finite-difference+LPF gyro
        # (see controllers/mellinger.py).  Pass kd_omega_rp=None for the
        # stock firmware behavior.
        env = make_quadrotor(_env_config_from_level(level_config, firmware_freq, firmware_freq),
                             device=device)
        wrapper = FirmwareWrapper(env, firmware_freq, ctrl_freq, verbose=verbose, fused=fused,
                                  kd_omega_rp=kd_omega_rp)
    else:
        env = make_quadrotor(_env_config_from_level(level_config, ctrl_freq, ctrl_freq),
                             device=device)
        wrapper = None

    episode_len = level_config.get("episode_len_sec", env.episode_len_sec)
    # reseed_on_reset=True (levels 0-2) re-seeds to the SAME seed each
    # episode, so the randomized course is static across episodes; level 3
    # sets it False and the poses drift (reference level*.yaml:17-18,
    # benchmark_env.py before_reset).  The RiskAdviser exploits exactly this.
    base_seed = int(level_config.get("seed", 1337))
    reseed = bool(level_config.get("reseed_on_reset", True))
    for ep in range(num_episodes):
        ep_seed = base_seed if reseed else base_seed + ep
        t_start = time.time()
        if use_firmware:
            obs, _ = wrapper.reset(seed=ep_seed)
        else:
            seeds = torch.full((1,), key_env_seed(ep_seed), dtype=torch.int32, device=device)
            env_state, obs_t, _ = env.reset(seeds)
            obs = obs_t[0].cpu().numpy()
        info = _reset_info(env, obs, ctrl_freq)
        if ep == 0:
            # One controller for the whole run (reference getting_started.py:93
            # builds it once): cross-episode learning — gate corrections,
            # risk advice, flight-plan cache — must survive episode resets.
            ctrl = controller_cls(obs, info, use_firmware=use_firmware, use_mpcc=use_mpcc,
                                  verbose=verbose, device=device)
        viewer = LiveViewer(env=env, every=gui_every) if gui else None

        cum_reward = 0.0
        collisions = 0
        gates_passed = 0
        min_gate_m = min_obst_m = None  # tick-rate clearance minima (fused)
        # Idle motors spin at MIN_PWM (the firmware wrapper's PWM clip floor),
        # so the initial action is the corresponding per-motor force — zeros
        # would trip the level configs' default input constraint at step 1.
        action = np.asarray(env.spaces.action_low, np.float64).copy()
        steps = int(episode_len * ctrl_freq)
        done = False
        reward = 0.0
        step_info = {}
        for i in range(steps):
            t = i / ctrl_freq
            if use_firmware:
                # Thread the previous step's reward/done/info to the user
                # controller (reference getting_started.py:172) — gate
                # corrections and episode-outcome tracking live in info.
                command, args = ctrl.cmdFirmware(t, obs, reward, done, step_info)
                dispatch_command(wrapper, command, args, t=t)
                obs, reward, done, step_info, action = wrapper.step(t, action)
                if command == Command.FINISHED:
                    break
            else:
                action = ctrl.cmdSimOnly(t, obs)
                env_state, obs, reward, done, step_info = _sim_step(env, env_state, action)
            cum_reward += float(reward)
            if step_info:
                collisions += int(np.asarray(step_info.get("collision", 0)))
            bc = getattr(wrapper, "block_clearance", None) if use_firmware else None
            if bc is not None and bc["gates"].size:
                min_gate_m = bc["gates"] if min_gate_m is None \
                    else np.minimum(min_gate_m, bc["gates"])
                min_obst_m = bc["obstacles"] if min_obst_m is None \
                    else np.minimum(min_obst_m, bc["obstacles"])
            ctrl.interStepLearn()
            if viewer is not None:
                viewer.update(np.asarray(obs)[:12], t=t, reward=float(reward))
                if viewer.interactive:
                    sync(i, t_start, 1.0 / ctrl_freq)
            if done:
                break
        if step_info:
            gid = int(np.asarray(step_info.get("current_target_gate_id", -1)))
            n_gates = len(level_config.get("gates", []) or [])
            gates_passed = n_gates if gid == -1 else gid
        elapsed = time.time() - t_start
        if viewer is not None:
            saved = viewer.close(save_path=None if viewer.interactive else f"gui_episode{ep}.gif",
                                 fps=max(1, ctrl_freq // gui_every))
            if saved and verbose:
                print(f"episode {ep}: wrote {saved}")
        ctrl.interEpisodeLearn()
        ep_stats = {
            "reward": cum_reward,
            "collisions": collisions,
            "gates_passed": gates_passed,
            "steps": i + 1,
            "steps_per_sec": (i + 1) / elapsed,
            "sim_speedup": ((i + 1) / ctrl_freq) / elapsed,
        }
        if min_gate_m is not None:
            # Per-gate / per-obstacle signed-margin minima at the 500 Hz
            # tick rate (fused loop diagnostics: a 25 Hz sample can miss an
            # 8 cm excursion at race speed).
            ep_stats["min_gate_margin"] = [round(float(v), 4) for v in min_gate_m]
            ep_stats["min_obstacle_margin"] = [round(float(v), 4) for v in min_obst_m]
        episodes.append(ep_stats)
        if verbose:
            print(f"episode {ep}: {episodes[-1]}")
    return episodes
