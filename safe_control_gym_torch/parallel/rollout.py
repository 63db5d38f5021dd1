"""Rollout loop with on-device episode statistics.

Port of ``safe_control_gym_tpu/parallel/rollout.py``: the ``lax.scan``
becomes a Python loop over batched steps; the episode accumulators stay on
the env's device.  The sharded rollout is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


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

    def means(self):
        """Completed-episode means over the batch (host floats)."""
        episodes = int(self.done_count.sum())
        n = max(episodes, 1)
        return {
            "mean_return": float(self.sum_return.sum()) / n,
            "mean_length": float(self.sum_length.sum()) / n,
            "mean_violations": float(self.sum_violations.sum()) / n,
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
