"""Batched and distributed execution.

Port of ``safe_control_gym_tpu/parallel``: the vectorized env with masked
auto-reset, the rollout loop with on-device episode statistics, the
whole-rollout kernels' host wrappers, and distribution over the ranks of a
``torch.distributed`` process group (``mesh``, ``distributed``), where the
JAX package shards the env batch over a ``jax.sharding.Mesh`` of devices.
"""

from safe_control_gym_torch.parallel.vector import VecEnv, make_vec_env
# The JAX package also exports the function ``rollout`` here; in the port the
# name stays the submodule's, which callers import as ``parallel.rollout``.
from safe_control_gym_torch.parallel.rollout import RolloutCarry, EpisodeStats
from safe_control_gym_torch.parallel.mesh import make_mesh, shard_batch
from safe_control_gym_torch.parallel.distributed import (
    host_mesh,
    initialize as distributed_initialize,
    sharded_init_fn,
)
from safe_control_gym_torch.parallel.episode_stats import RecordEpisodeStatistics
from safe_control_gym_torch.parallel.fast_env import FastQuadRollout
from safe_control_gym_torch.parallel.fast_quad_planar import FastPlanarQuadRollout

__all__ = [
    "VecEnv",
    "make_vec_env",
    "RolloutCarry",
    "EpisodeStats",
    "make_mesh",
    "shard_batch",
    "host_mesh",
    "distributed_initialize",
    "sharded_init_fn",
    "RecordEpisodeStatistics",
    "FastQuadRollout",
    "FastPlanarQuadRollout",
]
