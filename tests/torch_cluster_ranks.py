"""A rank of the CPU clusters that tests/test_torch_sharding.py and
tests/test_torch_multihost.py launch (``distributed.launch_workers``).

Imports the port alone.  ``SCG_TEST_DIR`` holds the parent's inputs
(``<mode>_inputs.pt``) and gets rank 0's results (``<mode>_<world size>.pt``);
``SCG_TEST_MODE`` picks the work:

- ``sharding``: over the (host, chip) layouts (1, 4), (2, 2) and (4, 1) of
  the same ranks, ``sharded_init_fn`` from the given env seeds and
  ``sharded_rollout_fn``; the gathered states and the global statistics;
- ``train``: one ``sharded_train_step`` with the given ``eps`` and ``perm``;
  the parameters, Adam moments and normalizer statistics, after checking
  that every rank holds rank 0's parameters.
"""

import dataclasses
import os

import torch
import torch.distributed as dist

from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
from safe_control_gym_torch.parallel import distributed
from safe_control_gym_torch.parallel.mesh import all_gather_cat, broadcast_, make_mesh
from safe_control_gym_torch.parallel.rollout import sharded_rollout_fn
from safe_control_gym_torch.parallel.vector import make_vec_env

AXES = (distributed.HOST_AXIS, distributed.CHIP_AXIS)


def gather(tree, group):
    """Every rank's slice of a tree of leading-B tensors, concatenated."""
    if torch.is_tensor(tree):
        return all_gather_cat(tree, group, 0)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: gather(getattr(tree, f.name), group)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: gather(v, group) for k, v in tree.items()}
    return tree


def sharding(dev, inputs):
    env = make_quadrotor(QuadrotorConfig(**inputs["config"]), device=dev)
    B, steps = inputs["num_envs"], inputs["steps"]
    vec = make_vec_env(env, B)

    def policy(pstate, obs):  # the batch comes from obs: each rank sees its slice
        return torch.full((obs.shape[0], 4), 0.084), pstate

    out = {}
    for d in (4, 2, 1):
        mesh = distributed.host_mesh(devices_per_host=d)
        group = mesh.group()
        carry = distributed.sharded_init_fn(env, B, mesh)(env_seeds=inputs["env_seeds"])
        init = gather(carry.env_state, group), gather(carry.obs, group)
        carry, stats = sharded_rollout_fn(vec, policy, steps, mesh, axis_name=AXES)(carry)
        out[mesh.sizes] = {"init_state": init[0], "init_obs": init[1], "stats": stats,
                           "state": gather(carry.env_state, group),
                           "obs": gather(carry.obs, group)}
    return out


def train(dev, inputs):
    from safe_control_gym_torch.controllers.ppo import PPO

    mesh = make_mesh()
    env = make_quadrotor(QuadrotorConfig(**inputs["config"]), device=dev)
    ppo = PPO(env, seed=0, **inputs["ppo"])
    state = distributed.shard_ppo_state(ppo, mesh)
    state, metrics = distributed.sharded_train_step(ppo, state, mesh, eps=inputs["eps"],
                                                    perm=inputs["perm"])
    params = torch.cat([p.detach().reshape(-1) for p in state.ac.parameters()])
    ref = params.clone()
    broadcast_(ref, mesh.group())
    assert torch.equal(ref, params), "a rank's parameters differ from rank 0's"
    opt = {f"{name}_{m}": [t.clone() for t in getattr(getattr(state, name), m)]
           for name in ("actor_opt", "critic_opt") for m in ("mu", "nu")}
    return {"params": [p.detach().clone() for p in state.ac.parameters()], **opt,
            "obs_rms": (state.obs_norm.rms.mean, state.obs_norm.rms.var),
            "rew_rms": (state.rew_norm.rms.mean, state.rew_norm.rms.var),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "total_steps": state.total_steps,
            "x": gather(state.env_state.x, mesh.group())}


def main():
    dev = distributed.worker_initialize()
    root = os.environ["SCG_TEST_DIR"]
    mode = os.environ["SCG_TEST_MODE"]
    inputs = torch.load(os.path.join(root, f"{mode}_inputs.pt"), weights_only=False)
    out = {"sharding": sharding, "train": train}[mode](dev, inputs)
    if dist.get_rank() == 0:
        torch.save(out, os.path.join(root, f"{mode}_{dist.get_world_size()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
