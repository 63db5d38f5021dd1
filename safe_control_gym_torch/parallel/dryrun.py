"""Dry runs of the distributed path on a cluster of ranks.

The port's counterpart of ``__graft_entry__.py::dryrun_multihost`` and
``::dryrun_multichip``: each launches a cluster (``distributed.launch_workers``)
and asserts what it ran.

- :func:`dryrun_multihost`: the validation worker (``_multihost_worker``) on
  a (processes x devices) layout: sharded init and rollout, one sharded
  PPO train step.
- :func:`dryrun_multichip`: three paths on ``n_ranks`` ranks, each asserted:
  (1) one sharded PPO train step on config 4's task (``total_steps`` is
  B x T, the loss finite); (2) K2 under the group on a noise-free config
  with 12-step episodes: every rank's rows bit-equal to the same K2 calls
  run one after another without the group; (3) K4 under the group: the
  all-reduced actor, critic and logstd gradients of a sharded minibatch
  equal the sum of the per-shard gradients (rtol 2e-5, atol 2e-5).  On the
  CPU, K2 and K4 are their plain versions.

    python -m safe_control_gym_torch.parallel.dryrun   (a rank; launched)
"""

from __future__ import annotations

import json
import os

import torch

from safe_control_gym_torch.parallel import distributed
from safe_control_gym_torch.parallel.mesh import make_mesh
from safe_control_gym_torch.utils.device import resolve_device

MODULE = "safe_control_gym_torch.parallel.dryrun"
WORKER = "safe_control_gym_torch.parallel._multihost_worker"
ENVS_PER_RANK = {"cuda": 1024, "cpu": 256}  # K2's envs and K4's minibatch a rank
GRAD_RTOL = GRAD_ATOL = 2e-5  # __graft_entry__.py:242-245


def dryrun_multihost(n_processes: int = 2, devices_per_process: int = 2, device=None,
                     timeout: float = 420.0) -> dict:
    """The validation worker on an ``n_processes x devices_per_process``
    cluster at 32 envs and 20 steps; returns its statistics."""
    device = resolve_device(device)
    stats = distributed.result_line(distributed.launch_workers(
        WORKER, n_processes, devices_per_process, timeout=timeout, device=device.type,
        env_overrides={"SCG_TEST_NUM_ENVS": "32", "SCG_TEST_NUM_STEPS": "20"}),
        "MULTIHOST_STATS ")
    print(f"dryrun_multihost OK: {n_processes} processes x {devices_per_process} devices "
          f"({device.type}), stats={stats}")
    return stats


def dryrun_multichip(n_ranks: int, device=None, timeout: float = 420.0) -> dict:
    """Paths (1)-(3) on an ``n_ranks`` cluster on ``device`` (CUDA by
    default: gloo ranks sharing the card where it has fewer devices than
    ranks); raises where a rank fails an assertion.  Returns rank 0's
    summary with every rank's K1, K2 and K4 launches summed."""
    device = resolve_device(device)
    n_env = ENVS_PER_RANK[device.type]
    out = distributed.result_line(distributed.launch_workers(
        MODULE, 1, n_ranks, timeout=timeout, device=device.type,
        env_overrides={"SCG_DRYRUN_ENVS_PER_RANK": str(n_env)}), "DRYRUN_MULTICHIP ")
    print(f"dryrun_multichip OK: {n_ranks} ranks ({out['backend']}, {out['device']}) | "
          f"ppo_step {out['ppo']['envs']} envs policy_loss={out['ppo']['policy_loss']:.4f} | "
          f"K2 {n_env * n_ranks} envs bit-equal (episodes={out['k2']['episodes']}) | "
          f"K4 mb={n_env * n_ranks} all-reduced grads within {out['k4']['max_abs_err']:.3g}")
    return out


def _build_env(device, episode_len_sec=1):
    """``__graft_entry__.py::_build_env``: config 4's figure-8 task with a
    white-noise dynamics disturbance and the normalized action space."""
    from safe_control_gym_torch.baseline import STATE_BOX
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor

    return make_quadrotor(QuadrotorConfig(
        quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=episode_len_sec,
        task="traj_tracking",
        task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
                   "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
                   "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
        cost="rl_reward", normalized_rl_action_space=True, randomized_inertial_prop=True,
        constraints=STATE_BOX,
        disturbances={"dynamics": ({"disturbance_func": "white_noise", "std": 0.002},)}),
        device=device)


def _launched(fn):
    """``fn()`` and this rank's K1, K2 and K4 launches in it."""
    from safe_control_gym_torch.parallel._multihost_worker import launches

    before = launches()
    out = fn()
    return out, {k: v - before[k] for k, v in launches().items()}


def path_ppo(dev, mesh):
    """(1) One sharded PPO train step, 4 envs a rank, T = 4, two epochs of
    two minibatches.  Returns its summary, its launches and the networks."""
    from safe_control_gym_torch.controllers.ppo import PPO

    B = 4 * mesh.size
    ppo = PPO(_build_env(dev), seed=0, rollout_batch_size=B, rollout_steps=4, opt_epochs=2,
              mini_batch_size=B * 4 // 2)
    state = distributed.shard_ppo_state(ppo, mesh)
    (state, metrics), n = _launched(lambda: distributed.sharded_train_step(ppo, state, mesh))
    loss = float(metrics["policy_loss"])
    assert state.total_steps == B * 4, state.total_steps
    assert torch.isfinite(torch.tensor(loss)), loss
    return {"envs": B, "policy_loss": loss, "total_steps": state.total_steps}, n, state.ac


def path_k2(dev, mesh, n_env: int) -> dict:
    """(2) K2 under the group: rank r runs one call from ``reset(seed=r)``;
    the gathered rows equal the same calls run one after another."""
    from safe_control_gym_torch.baseline import STATE_BOX
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.parallel.fast_env import FastQuadRollout, supports
    from safe_control_gym_torch.parallel.mesh import all_gather_cat

    cfg = QuadrotorConfig(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.2,
                          task="stabilization", cost="rl_reward", randomized_init=True,
                          randomized_inertial_prop=True, constraints=STATE_BOX,
                          done_on_out_of_bound=True)
    assert supports(cfg)
    env = make_quadrotor(cfg, device=dev)
    fr = FastQuadRollout(env, n_env, steps_per_call=14, device=dev)
    act = fr.prepare_action([float(env.u_goal[0])] * 4)
    rank, W = mesh.shard()[0], mesh.size
    rows = fr.reset(seed=rank)
    out, n = _launched(lambda: fr.run(rows, act, seed=11))
    gathered = all_gather_cat(out[None], mesh.group(), 0)
    seq = torch.stack([fr.run(fr.reset(seed=k), act, seed=11) for k in range(W)])
    # As bits: the seed row carries int32 seeds as float32 patterns (NaNs).
    differ = int((gathered.view(torch.int32) != seq.view(torch.int32)).sum())
    assert differ == 0, f"sharded K2 rows differ from the sequential calls in {differ} entries"
    assert bool(torch.isfinite(gathered[:, :12]).all())
    episodes = sum(fr.stats(gathered[k])["episodes"] for k in range(W))
    assert episodes > 0, "no episode completed: the rollout did not advance"
    return {"envs_per_rank": n_env, "episodes": episodes, "bit_equal": True}, n


def path_k4(dev, mesh, n_env: int, ac):
    """(3) K4 under the group: each rank's minibatch gradients (``ac``'s
    networks) all-reduced equal the sum of every shard's gradients computed
    in turn."""
    from safe_control_gym_torch.parallel.fast_update import FastPPOUpdate, prep_weights
    from safe_control_gym_torch.parallel.mesh import all_reduce_sum

    fu = FastPPOUpdate(mb_size=n_env, hidden=64, act="tanh", clip_param=0.2, obs_dim=12,
                       act_dim=4)
    w = prep_weights(ac.actor, ac.critic, ac.logstd)
    gen = torch.Generator().manual_seed(3)
    mbs = (0.5 * torch.randn((mesh.size, fu.F, n_env), generator=gen)).to(dev)

    def flat(k):
        ga, gc, gl, _ = fu.grads(mbs[k], w)
        return torch.cat([*(g.reshape(-1) for g in ga.values()),
                          *(g.reshape(-1) for g in gc.values()), gl])

    local, n = _launched(lambda: flat(mesh.shard()[0]))
    summed = all_reduce_sum(local, mesh.group())
    seq = sum(flat(k) for k in range(mesh.size))
    err = float((summed - seq).abs().max())
    assert torch.allclose(summed, seq, rtol=GRAD_RTOL, atol=GRAD_ATOL), \
        f"all-reduced K4 gradients differ from the sequential sum by {err}"
    return {"mb_per_rank": n_env, "max_abs_err": err, "grad_floats": local.numel(),
            "allreduce_ms": _allreduce_ms(local, mesh)}, n


def _allreduce_ms(t, mesh, reps: int = 20) -> float:
    """Host ms an all-reduce of ``t`` over the mesh takes, the device
    synchronized after the last."""
    import time

    from safe_control_gym_torch.parallel.mesh import all_reduce_sum

    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_sum(t, mesh.group())
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return (time.perf_counter() - t0) / reps * 1e3


def rank_main():
    from safe_control_gym_torch.parallel.mesh import all_reduce_sum

    dev = distributed.worker_initialize()
    mesh = make_mesh()
    n_env = int(os.environ["SCG_DRYRUN_ENVS_PER_RANK"])
    out = {"ranks": mesh.size, "backend": torch.distributed.get_backend(),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    out["ppo"], n_ppo, ac = path_ppo(dev, mesh)
    out["k2"], n_k2 = path_k2(dev, mesh, n_env)
    out["k4"], n_k4 = path_k4(dev, mesh, n_env, ac)
    # The launches of the sharded work of the three paths over every rank
    # (the sequential calls they are held against are left out).
    local = [n_ppo[k] + n_k2[k] + n_k4[k] for k in ("k1", "k2", "k4")]
    total = all_reduce_sum(torch.tensor(local, dtype=torch.float64, device=dev), mesh.group())
    out["launches"] = dict(zip(("k1", "k2", "k4"), (int(v) for v in total.tolist())))
    if torch.distributed.get_rank() == 0:
        print("DRYRUN_MULTICHIP " + json.dumps(out, sort_keys=True), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rank_main()
