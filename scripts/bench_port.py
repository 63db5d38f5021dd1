#!/usr/bin/env python3
"""Time the workloads of ``bench.py`` on one CUDA card through the port.

The port's counterpart of ``bench.py`` (the JAX package's headline bench),
on the BASELINE configs of ``safe_control_gym_torch/baseline.py`` at B =
4096 envs:

- ``general_engine_value``: config 4 on the general engine (``make_vec_env``
  + ``rollout``, K1 once a step), calls of 256 hover steps (bench.py:70-112);
- ``value``: config 4 on the whole-rollout engine, K2 calls of 8192 hover
  steps (bench.py:115-144);
- ``maze_level2_value``: config 5 on K2's maze instance, calls of 8192 hover
  steps under its step noise (bench.py:147-210);
- ``cartpole_value`` and ``quad2d_value``: config 2 on K5 (8192 steps a
  call) and config 3 on K7 (4096) (bench.py:213-308);
- ``policy_in_loop_value``: config 4 with the normalized action space, the
  PPO actor-critic of ``PPO(env, seed=0)`` acting in K3, calls of 512 steps
  (bench.py:311-354);
- ``rl_train_value``: PPO train steps on the same config, T = 128, 10 epochs
  of 4 minibatches (K3 once and K4 forty times a step; bench.py:357-402).

Each workload runs two warm-up calls, one timed call, then ``iters`` timed
calls (bench.py's counts), with ``torch.cuda.synchronize()`` as the barrier;
its value is env-steps/s over the ``iters`` calls.  The two timings give the
per-engine busy record of bench.py's ``_busy_record`` (the fit t(N) = a + N
b: per-call time b, per-region overhead a, busy share N b / t(N); a fit
whose overhead clamps to 0 is marked ``clamped`` and gives no share).  Prints
one JSON line with bench.py's keys, the busy records, and the card's name
and power limit as ``nvidia-smi`` gives them; no TPU peak and no ratio to a
TPU number.  A workload that fails raises: no value turns into null.

    python3 scripts/bench_port.py [--out results.json]

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096
_BUSY = {}


def busy_record(name, t1, tn, n):
    """bench.py:_busy_record: the two-point fit of t(N) = a + N b.

    Where the single call beat the average, the fit clamps ``a`` to 0 and
    its busy share would read 1.0 whatever the device did: such a record is
    marked ``clamped`` and its share is null, not a measurement."""
    b = max((tn - t1) / (n - 1), 1e-12)
    clamped = t1 - b < 0.0
    a = max(t1 - b, 0.0)
    _BUSY[name] = {"device_busy_frac": None if clamped else n * b / (a + n * b),
                   "per_call_s": b, "per_region_overhead_s": a, "clamped": clamped}


def timed(name, call, state, iters, steps_per_call):
    """Two warm-up calls, one timed call, then ``iters`` timed calls of
    ``state = call(state, i)``; returns env-steps/s over the ``iters``."""
    import torch

    for i in range(2):
        state = call(state, i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = call(state, 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(iters):
        state = call(state, 3 + i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    busy_record(name, t1, dt, iters)
    return iters * steps_per_call * B / dt, state


def bench_general(dev):
    """Config 4 on the general engine, 256 hover steps a call."""
    import torch

    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import rollout as R
    from safe_control_gym_torch.parallel.vector import make_vec_env

    env = make_quadrotor(cfg4(), device=dev)
    vec = make_vec_env(env, B)
    hover = torch.full((B, 4), float(env.u_goal[0]), device=dev)
    state, obs, _ = vec.reset(seed=0)
    carry = R.RolloutCarry(state, obs, (), R.EpisodeStats.create(B, device=dev))
    steps = 256

    def call(c, i):
        return R.rollout(vec, lambda ps, o: (hover, ps), c, steps, collect=False)[0]

    value, carry = timed("general", call, carry, 8, steps)
    if not bool(torch.isfinite(carry.env_state.x).all()):
        raise RuntimeError("general engine: non-finite states")
    return value


def bench_whole_rollout(name, fr, act, steps):
    """``iters`` = 4 calls of a whole-rollout engine, each with its own seed."""
    import torch

    value, rows = timed(name, lambda r, i: fr.run(r, act, seed=1 + i), fr.reset(seed=0), 4, steps)
    if not (bool(torch.isfinite(fr.states(rows)).all())
            and np.isfinite(list(fr.stats(rows).values())).all()):
        raise RuntimeError(f"{name}: non-finite states or statistics")
    return value


def bench_fast(dev):
    """Config 4 on K2, 8192 hover steps a call."""
    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel.fast_env import FastQuadRollout

    env = make_quadrotor(cfg4(), device=dev)
    fr = FastQuadRollout(env, B, steps_per_call=8192, device=dev)
    return bench_whole_rollout("fast", fr, fr.prepare_action(np.full(4, float(env.u_goal[0]))),
                               8192)


def bench_maze(dev):
    """Config 5 on K2's maze instance, 8192 hover steps a call."""
    from safe_control_gym_torch.baseline import cfg5
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel.fast_env import FastQuadRollout

    env = make_quadrotor(cfg5(), device=dev)
    fr = FastQuadRollout(env, B, steps_per_call=8192, device=dev)
    return bench_whole_rollout("maze", fr, fr.prepare_action(np.full(4, float(env.u_goal[0]))),
                               8192)


def bench_cartpole(dev):
    """Config 2 on K5, 8192 steps of a zero force a call."""
    from safe_control_gym_torch.baseline import cfg_cartpole
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.parallel.fast_cartpole import FastCartPoleRollout

    fr = FastCartPoleRollout(make_cartpole(cfg_cartpole(), device=dev), B, steps_per_call=8192,
                             device=dev)
    return bench_whole_rollout("cartpole", fr, fr.prepare_action(0.0), 8192)


def bench_quad2d(dev):
    """Config 3 on K7, 4096 hover steps a call."""
    from safe_control_gym_torch.baseline import cfg_quad2d
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel.fast_quad_planar import FastPlanarQuadRollout

    env = make_quadrotor(cfg_quad2d(), device=dev)
    fr = FastPlanarQuadRollout(env, B, steps_per_call=4096, device=dev)
    act = fr.prepare_action(np.full(2, float(env.u_goal[0]), np.float32))
    return bench_whole_rollout("quad2d", fr, act, 4096)


def bench_policy_in_loop(dev):
    """Config 4 (normalized actions) on K3: the actor-critic of
    ``PPO(env, seed=0)`` acting every step, 512 steps a call, 2 calls."""
    import torch

    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.parallel import fast_policy as P

    env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
    T = 512
    fp = P.FastPolicyRollout(env, B, T, device=dev)
    ac = PPO(env, seed=0, rollout_batch_size=B, rollout_steps=T).state.ac
    w = P.pack_weights(ac.actor, ac.critic, ac.logstd)
    value, rows = timed("policy_in_loop", lambda r, i: fp.run(r, w, seed=1 + i)[0],
                        fp.reset(seed=0), 2, T)
    if not bool(torch.isfinite(rows[:12]).all()):
        raise RuntimeError("policy_in_loop: non-finite states")
    return value


def bench_rl_train(dev):
    """PPO train steps on config 4 (normalized actions): B = 4096, T = 128,
    10 epochs of 4 minibatches, K3 and K4 (``use_fast_rollout``); calls of
    4 train steps (``train_many``), 2 timed calls."""
    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
    T, chunk = 128, 4
    ppo = PPO(env, seed=0, rollout_batch_size=B, rollout_steps=T, opt_epochs=10,
              mini_batch_size=B * T // 4, use_fast_rollout=True, reshuffle_each_epoch=False)
    if ppo._fp is None or ppo._fu is None:
        raise RuntimeError("rl_train: PPO did not take the policy kernel and K4")
    run = ppo.train_many(chunk)
    value, state = timed("rl_train", lambda s, i: run(s)[0], ppo.state, 2, chunk * T)
    if not np.isfinite(float(run(state)[1]["policy_loss"])):
        raise RuntimeError("rl_train: non-finite loss")
    return value


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the record here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_port: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    from safe_control_gym_torch import kernels

    kernels.lib()  # builds the kernels once, outside every timed region
    t_start = time.perf_counter()
    general = bench_general(dev)
    fast = bench_fast(dev)
    policy_loop = bench_policy_in_loop(dev)
    maze = bench_maze(dev)
    rl_train = bench_rl_train(dev)
    cartpole = bench_cartpole(dev)
    quad2d = bench_quad2d(dev)
    record = {
        "metric": "env_steps_per_sec_per_card_quad3d_4096",
        "value": fast,
        "unit": "env-steps/s",
        "engine": "fast_rollout",
        "platform": "gpu",
        "general_engine_value": general,
        "policy_in_loop_value": policy_loop,
        "maze_level2_value": maze,
        "rl_train_value": rl_train,
        "cartpole_value": cartpole,
        "quad2d_value": quad2d,
        "device_busy": _BUSY,
        "card": card_line(),
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "seconds": time.perf_counter() - t_start,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
