"""The port's multi-process path on CPU clusters (twin of
tests/test_multihost.py).

The validation worker (``parallel/_multihost_worker.py``) runs at the (host x
chip) layouts (1 x 4), (2 x 2) and (4 x 1) of the same 32-env global batch,
each a 4-rank gloo cluster with one thread a rank, and its global episode
statistics are held to the same computation in one process.  The
data-parallel PPO step (``distributed.sharded_train_step``) on 2 and 4 ranks
is held to the one-process ``_train_step`` with the same sample normals and
permutations, and at world size 1 in a one-rank group bit for bit.  Each
cluster is launched once for the module.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from safe_control_gym_torch.baseline import cfg4
from safe_control_gym_torch.controllers.ppo import PPO
from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
from safe_control_gym_torch.parallel import _multihost_worker as MW
from safe_control_gym_torch.parallel import distributed

WORKER = "safe_control_gym_torch.parallel._multihost_worker"
RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cluster_ranks.py")
LAYOUTS = ((1, 4), (2, 2), (4, 1))
# A short config 4: 6-step episodes, so the 8-step collection crosses
# truncations and auto-resets; 4 minibatches of 32 a epoch.
TRAIN_CONFIG = {k: v for k, v in dataclasses.asdict(cfg4(episode_len_sec=0.1)).items()
                if k != "dtype"}
TRAIN_B, TRAIN_T, EPOCHS, MB = 16, 8, 2, 32
TRAIN_CASES = {
    # world size: PPO options (the autograd update with both running
    # normalizers; K4's update, its plain version on the CPU)
    2: dict(norm_obs=True, norm_reward=True),
    4: dict(use_fast_update=True),
}


def _ppo_kwargs(world):
    return dict(rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
                mini_batch_size=MB, **TRAIN_CASES[world])


def _draws():
    rng = np.random.default_rng(7)
    eps = torch.from_numpy(rng.standard_normal((TRAIN_T, TRAIN_B, 4)).astype(np.float32))
    n = TRAIN_B * TRAIN_T
    perm = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(EPOCHS)]))
    return eps, perm


@pytest.fixture(scope="module")
def worker_stats(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multihost"))
    return {(p, d): distributed.result_line(distributed.launch_workers(
        WORKER, p, d, timeout=300.0, store_dir=root,
        env_overrides={"SCG_TEST_NUM_ENVS": "32", "SCG_TEST_NUM_STEPS": "40"}),
        "MULTIHOST_STATS ") for p, d in LAYOUTS}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    eps, perm = _draws()
    out = {}
    for world in TRAIN_CASES:
        torch.save({"config": TRAIN_CONFIG, "ppo": _ppo_kwargs(world), "eps": eps, "perm": perm},
                   root / "train_inputs.pt")
        res = distributed.launch_workers(RANKS, 1, world, timeout=300.0, store_dir=str(root),
                                         env_overrides={"SCG_TEST_DIR": str(root),
                                                        "SCG_TEST_MODE": "train"})
        for rank, (rc, text) in enumerate(res):
            assert rc == 0, f"rank {rank} of {world} failed (rc={rc}):\n{text[-3000:]}"
        out[world] = torch.load(root / f"train_{world}.pt", weights_only=False)
    return out


def _one_process_step(world):
    env = make_quadrotor(QuadrotorConfig(**TRAIN_CONFIG), device="cpu")
    ppo = PPO(env, seed=0, **_ppo_kwargs(world))
    eps, perm = _draws()
    state, metrics = ppo._train_step(ppo.state, eps=eps, perm=perm)
    return state, metrics


@pytest.mark.parametrize("layout", LAYOUTS)
def test_worker_stats_match_one_process(worker_stats, layout):
    ref = MW.stats(32, 40, torch.device("cpu"), distributed.host_mesh())
    got = worker_stats[layout]
    assert ref["episodes"] > 0, ref
    assert got["episodes"] == ref["episodes"], (got, ref)
    for k in ("mean_return", "mean_length", "mean_violations"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # The sharded PPO step ran and produced a finite loss.
    assert np.isfinite(got["ppo_policy_loss"])
    assert got["total_steps"] == ref["total_steps"] == 32 * 4


@pytest.mark.parametrize("world", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_one_process(train_runs, world):
    state, metrics = _one_process_step(world)
    got = train_runs[world]
    # The collection precedes the update: every env's state is bit-equal.
    assert torch.equal(got["x"], state.env_state.x)
    assert got["total_steps"] == state.total_steps == TRAIN_B * TRAIN_T
    for a, b in zip(got["params"], state.ac.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=2e-4, atol=1e-6)
    for name in ("actor_opt", "critic_opt"):
        for m in ("mu", "nu"):
            for a, b in zip(got[f"{name}_{m}"], getattr(getattr(state, name), m)):
                scale = float(b.abs().max())
                torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4 * scale,
                                           msg=f"{name}.{m}")
    for rms, key in ((state.obs_norm.rms, "obs_rms"), (state.rew_norm.rms, "rew_rms")):
        torch.testing.assert_close(got[key][0], rms.mean, rtol=2e-4, atol=1e-6)
        torch.testing.assert_close(got[key][1], rms.var, rtol=2e-4, atol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=2e-4, atol=1e-6, err_msg=k)


def test_sharded_train_step_in_a_one_rank_group_is_bit_equal(tmp_path):
    """World size 1 with a group formed (chip_smoke.py's NCCL case on the
    card): every collective runs and changes no bit."""
    kwargs = dict(use_fast_update=True, norm_obs=True, norm_reward=True)
    env = make_quadrotor(QuadrotorConfig(**TRAIN_CONFIG), device="cpu")
    eps, perm = _draws()
    ref = PPO(env, seed=0, **{**_ppo_kwargs(4), **kwargs})
    ref._train_step(ref.state, eps=eps, perm=perm)
    ppo = PPO(env, seed=0, **{**_ppo_kwargs(4), **kwargs})
    distributed.initialize(f"file://{tmp_path}/store", world_size=1, rank=0, device="cpu",
                           timeout=60)
    try:
        mesh = distributed.host_mesh()
        assert mesh.group() is dist.group.WORLD
        state = distributed.shard_ppo_state(ppo, mesh)
        state, _ = distributed.sharded_train_step(ppo, state, mesh, eps=eps, perm=perm)
    finally:
        dist.destroy_process_group()
    for a, b in zip(state.ac.parameters(), ref.state.ac.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(state.actor_opt.nu + state.critic_opt.nu,
                    ref.state.actor_opt.nu + ref.state.critic_opt.nu):
        assert torch.equal(a, b)
    assert torch.equal(state.obs_norm.rms.var, ref.state.obs_norm.rms.var)
    assert ppo.data_parallel is None and state.obs_norm.rms.reduce is None


def test_sharded_train_step_refuses_what_it_cannot_split():
    env = make_quadrotor(QuadrotorConfig(**TRAIN_CONFIG), device="cpu")
    two = distributed.Mesh(("env",), (2,), (0,))  # rank 0's view of two ranks
    ppo = PPO(env, seed=0, **{**_ppo_kwargs(4), "mini_batch_size": 40})
    with pytest.raises(ValueError, match="multiple of 8"):  # K4 takes shares of 20
        distributed.sharded_train_step(ppo, ppo.state, two)
    ppo = PPO(env, seed=0, rollout_batch_size=4, rollout_steps=4, use_fast_rollout=True,
              mini_batch_size=16)
    with pytest.raises(ValueError, match="general engine"):
        distributed.sharded_train_step(ppo, ppo.state, distributed.host_mesh())


def test_host_mesh_and_slices_single_process():
    """Mesh and slice helpers in one process (the same code path)."""
    mesh = distributed.host_mesh()
    assert mesh.axis_names == ("host", "chip")
    assert mesh.shape == {"host": 1, "chip": 1}
    assert distributed.local_env_slice(mesh, 8) == (0, 8)
    with pytest.raises(ValueError):
        distributed.host_mesh(devices_per_host=2)  # one rank does not make hosts of 2
    two = distributed.Mesh(("host", "chip"), (2, 2), (1, 0))  # rank 2's view of a 2 x 2 mesh
    assert distributed.local_env_slice(two, 16) == (8, 4)
    assert distributed.local_env_slice(two, 16, axis_names=("host",)) == (8, 8)
    with pytest.raises(ValueError):
        distributed.local_env_slice(two, 6)  # not divisible by 4 shards


def test_backend_rule(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert distributed.backend_for(cpu, 4) == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        distributed.backend_for(cpu, 1, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.backend_for(cuda, 1) == "nccl"
    assert distributed.backend_for(cuda, 2) == "gloo"  # two ranks share the card
    with pytest.raises(ValueError, match="NCCL"):
        distributed.backend_for(cuda, 2, "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        distributed.initialize("file:///nonexistent", world_size=2, rank=0, backend="nccl",
                               device="cpu")
    assert not dist.is_initialized()
