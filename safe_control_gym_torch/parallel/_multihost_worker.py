"""Multi-process validation worker (run through ``distributed.launch_workers``).

Port of ``safe_control_gym_tpu/parallel/_multihost_worker.py``.  Joins the
cluster, builds the 2D (host, chip) mesh, resets its envs rank-locally, runs
a sharded rollout with a fixed policy, then one sharded PPO train step, and
prints one ``MULTIHOST_STATS`` JSON line on rank 0.  A test launches it at
several (process x device) layouts of the same global batch and holds the
global episode statistics equal (the distributed counterpart of the
reference's SubprocVecEnv-against-DummyVecEnv equivalence).

``SCG_TEST_MODE=perf`` times the sharded rollout instead (:func:`perf_main`,
one ``MULTIHOST_PERF`` line).  Sizes come from ``SCG_TEST_NUM_ENVS``,
``SCG_TEST_NUM_STEPS``, ``SCG_TEST_STEPS_SHORT``, ``SCG_TEST_STEPS_LONG`` and
``SCG_TEST_ITERS``.

    python -m safe_control_gym_torch.parallel._multihost_worker

(started by ``launch_workers``, or by torchrun with ``SCG_DEVICE`` set.)
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.distributed as dist

from safe_control_gym_torch.baseline import STATE_BOX
from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
from safe_control_gym_torch.parallel import distributed
from safe_control_gym_torch.parallel.rollout import sharded_rollout_fn
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils.device import card_line

AXES = (distributed.HOST_AXIS, distributed.CHIP_AXIS)


def _env(n: str, default: int) -> int:
    return int(os.environ.get(n, default))


def stats_config() -> QuadrotorConfig:
    """Config-4-like stabilization with 1-s episodes at 30 Hz (the JAX
    worker's): random initial states and inertia, the state box."""
    return QuadrotorConfig(quad_type=3, ctrl_freq=30, pyb_freq=60, episode_len_sec=1.0,
                           task="stabilization", cost="rl_reward", randomized_init=True,
                           randomized_inertial_prop=True, constraints=STATE_BOX)


def stats(num_envs: int, num_steps: int, device, mesh) -> dict:
    """The sharded rollout's global episode statistics under the altitude
    feedback policy, then one sharded PPO train step (one epoch of one
    minibatch): its policy loss and ``total_steps``.  Runs as it is at
    world size 1, with or without a group."""
    env = make_quadrotor(stats_config(), device=device)
    carry = distributed.sharded_init_fn(env, num_envs, mesh)(seed=0)
    hover = torch.as_tensor(env.u_goal, dtype=torch.float32, device=env.device)

    def policy(pstate, obs):
        # State feedback on the altitude: the same on any layout, and it
        # drives episodes through done and auto-reset without a model.
        err = 0.5 - obs[..., 4]
        return hover[None, :] + 0.02 * err[..., None], pstate

    run = sharded_rollout_fn(make_vec_env(env, num_envs), policy, num_steps, mesh, axis_name=AXES)
    _, out = run(carry)

    from safe_control_gym_torch.controllers.ppo import PPO

    ppo = PPO(env, seed=0, rollout_batch_size=num_envs, rollout_steps=4, opt_epochs=1,
              mini_batch_size=num_envs * 4)
    state = distributed.shard_ppo_state(ppo, mesh)
    state, metrics = distributed.sharded_train_step(ppo, state, mesh)
    out["ppo_policy_loss"] = float(metrics["policy_loss"])
    out["total_steps"] = int(state.total_steps)
    return out


def launches() -> dict:
    """K1, K2 and K4's launch counters in this process."""
    from safe_control_gym_torch.ops import quad_substeps
    from safe_control_gym_torch.parallel import fast_env, fast_update

    return {"k1": quad_substeps.quad3d_substeps.launches,
            "k2": fast_env.quad3d_rollout.launches, "k4": fast_update.ppo_grads.launches}


def summed_launches(mesh, device) -> dict:
    """:func:`launches` summed over the ranks."""
    from safe_control_gym_torch.parallel.mesh import all_reduce_sum

    c = launches()
    total = all_reduce_sum(torch.tensor(list(c.values()), dtype=torch.float64, device=device),
                           mesh.group())
    return dict(zip(c, (int(v) for v in total.tolist())))


def main():
    dev = distributed.worker_initialize()
    mesh = distributed.host_mesh()
    out = stats(_env("SCG_TEST_NUM_ENVS", 32), _env("SCG_TEST_NUM_STEPS", 40), dev, mesh)
    out["launches"] = summed_launches(mesh, dev)
    if dist.get_rank() == 0:
        print("MULTIHOST_STATS " + json.dumps(out, sort_keys=True), flush=True)
    dist.destroy_process_group()


def perf(num_envs: int, s_short: int, s_long: int, iters: int, device, mesh) -> dict:
    """Weak-scaling probe with the coordination cost split out: the sharded
    rollout (hover on 6-s stabilization episodes, the general engine, K1
    once a step) timed at two lengths and fit to ``t(S) = a + b S``.  ``a``
    is a call's fixed cost (the statistics' all-reduce, the host's
    synchronization), ``b`` a step's; ``coordination_fraction`` = a /
    t(S_long) tells whether the timed region was compute-dominated."""
    env = make_quadrotor(QuadrotorConfig(quad_type=3, ctrl_freq=60, pyb_freq=240,
                                         episode_len_sec=6.0, task="stabilization",
                                         cost="rl_reward", randomized_inertial_prop=True),
                         device=device)
    init = distributed.sharded_init_fn(env, num_envs, mesh)
    hover = float(env.u_goal[0])

    def policy(pstate, obs):
        return torch.full(obs.shape[:-1] + (4,), hover, dtype=obs.dtype, device=obs.device), pstate

    vec = make_vec_env(env, num_envs)
    group = mesh.group()

    def timed(num_steps):
        run = sharded_rollout_fn(vec, policy, num_steps, mesh, axis_name=AXES)
        carry, _ = run(init(seed=0))  # warm-up; means() ends in a host read
        if group is not None:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            carry, _ = run(carry)
        return (time.perf_counter() - t0) / iters

    t_s, t_l = timed(s_short), timed(s_long)
    b = max((t_l - t_s) / (s_long - s_short), 1e-12)
    a = max(t_s - b * s_short, 0.0)
    return {"processes": mesh.shape[distributed.HOST_AXIS], "ranks": mesh.size,
            "device": card_line(device),
            "backend": dist.get_backend() if group is not None else None, "envs": num_envs,
            "steps_per_sec": num_envs * s_long / t_l, "steps_timed": [s_short, s_long],
            "per_call_overhead_ms": a * 1e3, "per_step_us": b * 1e6,
            "coordination_fraction": a / max(t_l, 1e-12)}


def perf_main():
    """:func:`perf` on the cluster; one ``MULTIHOST_PERF`` line, read by
    ``scripts/scaling_multihost_port.py`` and ``scripts/scaling_port.py``."""
    dev = distributed.worker_initialize()
    mesh = distributed.host_mesh()
    s_short = _env("SCG_TEST_STEPS_SHORT", _env("SCG_TEST_NUM_STEPS", 64))
    out = perf(_env("SCG_TEST_NUM_ENVS", 512), s_short, _env("SCG_TEST_STEPS_LONG", 4 * s_short),
               _env("SCG_TEST_ITERS", 4), dev, mesh)
    if dist.get_rank() == 0:
        print("MULTIHOST_PERF " + json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if os.environ.get("SCG_TEST_MODE") == "perf":
        perf_main()
    else:
        main()
