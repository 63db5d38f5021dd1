"""Rollout loop with on-device episode statistics.

Port of ``safe_control_gym_tpu/parallel/rollout.py``: the ``lax.scan``
becomes a Python loop over batched steps; the episode accumulators stay on
the env's device.  The sharded rollout (:func:`sharded_rollout_fn`) runs the
same loop on each rank's slice of the batch and sums the episode
statistics over the mesh's process group, where the JAX package runs it
under ``shard_map`` with ``psum``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from safe_control_gym_torch.parallel.mesh import all_reduce_sum


@dataclasses.dataclass
class EpisodeStats:
    """Masked per-env episode accumulators (reference
    record_episode_statistics.py:11-169): running return/length reset on
    done; completed-episode sums give exact means."""

    ep_return: torch.Tensor  # (B,) running return of the current episode
    ep_length: torch.Tensor  # (B,) int32 running length
    ep_violations: torch.Tensor  # (B,) running constraint violations
    done_count: torch.Tensor  # (B,) int32 completed episodes
    sum_return: torch.Tensor  # (B,) sum of completed-episode returns
    sum_length: torch.Tensor  # (B,)
    sum_violations: torch.Tensor  # (B,)

    @classmethod
    def create(cls, num_envs, dtype=torch.float32, device=None):
        z = torch.zeros(num_envs, dtype=dtype, device=device)
        zi = torch.zeros(num_envs, dtype=torch.int32, device=device)
        return cls(z, zi, z, zi, z, z, z)

    def update(self, rew, done, info):
        viol = info.get("constraint_violation")
        viol = torch.zeros_like(rew) if viol is None else viol.to(rew.dtype)
        ep_ret = self.ep_return + rew
        ep_len = self.ep_length + 1
        ep_vio = self.ep_violations + viol
        d = done.to(torch.bool)
        zero = torch.zeros_like(ep_ret)
        return EpisodeStats(
            ep_return=torch.where(d, zero, ep_ret),
            ep_length=torch.where(d, torch.zeros_like(ep_len), ep_len),
            ep_violations=torch.where(d, zero, ep_vio),
            done_count=self.done_count + d.to(torch.int32),
            sum_return=self.sum_return + torch.where(d, ep_ret, zero),
            sum_length=self.sum_length
            + torch.where(d, ep_len, torch.zeros_like(ep_len)).to(self.sum_length.dtype),
            sum_violations=self.sum_violations + torch.where(d, ep_vio, zero),
        )

    def means(self, group=None):
        """Completed-episode means (host floats).  With a process ``group``
        the counts and sums are summed over its ranks before dividing (the
        JAX package's ``psum`` over ``axis_name``); one collective, in
        float64, which holds every float32 sum and int count exactly."""
        sums = torch.stack([x.sum().double() for x in (
            self.done_count, self.sum_return, self.sum_length, self.sum_violations)])
        episodes, ret, length, viol = all_reduce_sum(sums, group).tolist()
        episodes = int(episodes)
        n = max(episodes, 1)
        return {
            "mean_return": ret / n,
            "mean_length": length / n,
            "mean_violations": viol / n,
            "episodes": episodes,
        }


@dataclasses.dataclass
class RolloutCarry:
    env_state: Any
    obs: torch.Tensor
    policy_state: Any
    stats: EpisodeStats


def rollout(vec_env, policy_fn: Callable, carry: RolloutCarry, num_steps: int,
            collect: bool = True):
    """Run ``num_steps`` batched env steps.

    policy_fn: ``(policy_state, obs) -> (actions, new_policy_state)``.
    Returns ``(carry, traj)``; traj stacks obs, action, reward, done, mse,
    constraint_violation and terminal_observation along a leading time axis,
    or is None when ``collect=False``."""
    records = []
    for _ in range(num_steps):
        actions, pstate = policy_fn(carry.policy_state, carry.obs)
        env_state, obs, rew, done, info = vec_env.step(carry.env_state, actions)
        stats = carry.stats.update(rew, done, info)
        if collect:
            rec = {
                "obs": carry.obs,
                "action": actions,
                "reward": rew,
                "done": done,
                "mse": info.get("mse"),
                "constraint_violation": info.get("constraint_violation"),
                "terminal_observation": info.get("terminal_observation"),
            }
            records.append({k: v for k, v in rec.items() if v is not None})
        carry = RolloutCarry(env_state, obs, pstate, stats)
    traj = None
    if collect and records:
        traj = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    return carry, traj


def sharded_rollout_fn(vec_env, policy_fn: Callable, num_steps: int, mesh, axis_name="env",
                       collect: bool = False):
    """``(carry) -> (carry, global_stats)`` over a mesh of ranks.

    ``carry`` holds this rank's slice of the env batch
    (``parallel.mesh.shard_batch`` or ``distributed.sharded_init_fn``);
    every rank runs :func:`rollout` on its own slice, so a rank's code is
    the one-process path's, kernels included, and the episode statistics
    are summed over the ranks of ``axis_name`` (:meth:`EpisodeStats.means`;
    the mesh's axes: a rank's group spans them all).  ``policy_fn`` must take its
    batch size from ``obs``: it sees the local slice.  ``vec_env`` may be
    built for the global batch: its step takes any batch."""

    def run(carry: RolloutCarry):
        carry, _ = rollout(vec_env, policy_fn, carry, num_steps, collect=collect)
        return carry, carry.stats.means(group=mesh.group(axis_name))

    return run
