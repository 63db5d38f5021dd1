#!/usr/bin/env python3
"""The whole-rollout kernels against the general engine on one device, with
resets: the counterpart of ``benchmarks/on_device_checks.py``.

K2 (3D quad), K5 (CartPole) and K7 (2D quad) run one call of 25
constant-action steps at B = 1024 through timeout auto-resets (0.12-0.2 s episodes)
with an impulse disturbance, randomized inertia and initial state; the
general engine (``make_vec_env`` + ``rollout``, K1 on the 3D quad) runs the
same 25 steps from the same per-env seeds on the same device.  Reported
per engine: the relative error of the reset states, of the states after the
call, and of a randomized parameter and the episode index (the reset
draws are bit-exact by construction, ``ops/ctr_prng.py``); the trajectories
agree to float32 accumulation order.  Prints a JSON line per engine and a
summary with the largest state error (no error is caught: a failing engine
fails the script); writes the record only under ``--out``.

    python3 scripts/on_device_checks_port.py [--device cpu]
        [--out results/on_device_checks.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 1024
STEPS = 25


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())


def compare(env, fr, action, extra_rows, batch):
    """Seeded rollout with resets on both engines -> relative errors."""
    import torch

    from safe_control_gym_torch.parallel.rollout import EpisodeStats, RolloutCarry, rollout
    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, batch)
    state, obs, _ = vec.reset(seed=0)
    rows0 = fr.reset(seed=0)
    out = {"reset_rel_err": rel_err(fr.states(rows0), state.x)}
    rows = fr.run(rows0, action, seed=0)
    act = torch.as_tensor(action, dtype=torch.float32, device=env.device).expand(batch, -1)
    carry = RolloutCarry(state, obs, (), EpisodeStats.create(batch, device=env.device))
    carry, _ = rollout(vec, lambda ps, o: (act, ps), carry, fr.steps, collect=False)
    out["rollout_rel_err"] = rel_err(fr.states(rows), carry.env_state.x)
    packed = fr.pack(carry.env_state)  # the general engine's state in the kernel's rows
    for name, r in extra_rows:
        out[name] = rel_err(rows[r], packed[r])
    out["episodes"] = fr.stats(rows)["episodes"]
    return out


def check_quad3d(dev, batch, steps):
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.parallel import fast_env

    env = make_quadrotor(QuadrotorConfig(
        quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.2, task="stabilization",
        task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
        randomized_init=True, randomized_inertial_prop=True, done_on_out_of_bound=False,
        disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02,
                                    "duration": 4, "decay_rate": 0.8},)}), device=dev)
    fr = fast_env.FastQuadRollout(env, batch, steps_per_call=steps, device=dev)
    return compare(env, fr, [float(env.u_goal[0])] * 4,
                   (("mass_rel_err", fast_env._R_MASS), ("episode_idx_rel_err", fast_env._R_EP)),
                   batch)


def check_cartpole(dev, batch, steps):
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
    from safe_control_gym_torch.parallel import fast_cartpole

    env = make_cartpole(CartPoleConfig(
        ctrl_freq=50, pyb_freq=50, episode_len_sec=0.12, task="stabilization",
        randomized_init=True, randomized_inertial_prop=True, done_on_out_of_bound=False,
        disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.4,
                                    "duration": 4, "decay_rate": 0.8},)}), device=dev)
    fr = fast_cartpole.FastCartPoleRollout(env, batch, steps_per_call=steps, device=dev)
    return compare(env, fr, [0.0], (("pole_length_rel_err", fast_cartpole._R_PL),
                                    ("episode_idx_rel_err", fast_cartpole._R_EP)), batch)


def check_quad2d(dev, batch, steps):
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.parallel.fast_quad_planar import FastPlanarQuadRollout

    env = make_quadrotor(QuadrotorConfig(
        quad_type=2, ctrl_freq=50, pyb_freq=200, episode_len_sec=0.2, task="stabilization",
        task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.05},
        randomized_init=True, randomized_inertial_prop=True, done_on_out_of_bound=False,
        disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02,
                                    "duration": 4, "decay_rate": 0.8},)}), device=dev)
    fr = FastPlanarQuadRollout(env, batch, steps_per_call=steps, device=dev)
    L = fr.layout
    return compare(env, fr, [float(env.u_goal[0])] * 2,
                   (("mass_rel_err", L["MASS"]), ("episode_idx_rel_err", L["EP"])), batch)


def main(device=None, batch=B, steps=STEPS, out=None):
    import torch

    from safe_control_gym_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    record = {"metric": "on_device_cross_engine_rel_err", "device": card_line(dev),
              "batch": batch, "steps": steps,
              "note": ("seeded rollouts with auto-resets: K2, K5 and K7 against the general "
                       "engine on the same device; reset draws bit-exact by construction "
                       "(ops/ctr_prng.py), trajectories to float32 accumulation order"),
              "engines": {}}
    for name, fn in (("quad3d", check_quad3d), ("cartpole", check_cartpole),
                     ("quad2d", check_quad2d)):
        t0 = time.perf_counter()
        r = fn(dev, batch, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        r["wall_s"] = time.perf_counter() - t0
        record["engines"][name] = r
        print(json.dumps({name: r}), flush=True)
    record["value"] = max(r["rollout_rel_err"] for r in record["engines"].values())
    print(json.dumps({"metric": record["metric"], "value": record["value"],
                      "device": record["device"]}), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    main(a.device, out=a.out)
