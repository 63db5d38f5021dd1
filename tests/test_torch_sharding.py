"""The port's mesh helpers, rank-local reset and sharded rollout (twin of
tests/test_sharding.py).

One 4-rank CPU cluster (gloo, one thread a rank, ``torch_cluster_ranks.py``)
runs ``sharded_init_fn`` and ``sharded_rollout_fn`` over the (host, chip)
layouts (1, 4), (2, 2) and (4, 1) of its ranks.  The gathered states are
held bit for bit to the port's one-process reset and rollout, the global
statistics to the one-process rollout (episodes exact, means rtol 1e-5) and
to the JAX package's ``sharded_rollout_fn`` on conftest's 8-device mesh from
the same JAX-derived env seeds (rtol 2e-4).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import distributed
from safe_control_gym_torch.parallel import mesh as tm
from safe_control_gym_torch.parallel.rollout import (
    EpisodeStats, RolloutCarry, rollout, sharded_rollout_fn)
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jctr
from safe_control_gym_tpu.parallel import make_mesh as jmake_mesh
from safe_control_gym_tpu.parallel import make_vec_env as jmake_vec_env
from safe_control_gym_tpu.parallel import shard_batch as jshard_batch
from safe_control_gym_tpu.parallel.rollout import EpisodeStats as JStats
from safe_control_gym_tpu.parallel.rollout import RolloutCarry as JCarry
from safe_control_gym_tpu.parallel.rollout import sharded_rollout_fn as jsharded_rollout_fn

CONFIG = dict(quad_type=3, ctrl_freq=50, pyb_freq=100, episode_len_sec=0.5,
              randomized_inertial_prop=True)  # tests/test_sharding.py's env
B, STEPS = 64, 30
RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cluster_ranks.py")
LAYOUTS = ((1, 4), (2, 2), (4, 1))


def _policy(pstate, obs):
    return torch.full((obs.shape[0], 4), 0.084), pstate


def _seeds():
    return np.array(jax.vmap(jctr.env_seed_from_key)(jax.random.split(jax.random.key(5), B)))


def _assert_bits(a, b, what):
    """Two trees of tensors equal as bytes (dataclasses, dicts, tensors)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_bits(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_bits(a[k], b[k], f"{what}[{k}]")
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, what
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), what


@pytest.fixture(scope="module")
def env():
    return tq.make_quadrotor(tq.QuadrotorConfig(**CONFIG), device="cpu")


@pytest.fixture(scope="module")
def single(env):
    """The port's one-process reset and rollout from the JAX env seeds."""
    vec = make_vec_env(env, B)
    state, obs, _ = vec.reset(env_seeds=torch.from_numpy(_seeds()))
    carry, _ = rollout(vec, _policy, RolloutCarry(state, obs, (), EpisodeStats.create(B)), STEPS,
                       collect=False)
    return state, obs, carry


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharding")
    torch.save({"config": CONFIG, "num_envs": B, "steps": STEPS,
                "env_seeds": torch.from_numpy(_seeds())}, root / "sharding_inputs.pt")
    res = distributed.launch_workers(RANKS, 1, 4, timeout=300.0, store_dir=str(root),
                                     env_overrides={"SCG_TEST_DIR": str(root),
                                                    "SCG_TEST_MODE": "sharding"})
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {rank} failed (rc={rc}):\n{out[-3000:]}"
    return torch.load(root / "sharding_4.pt", weights_only=False)


def test_mesh_helpers_at_world_size_one(env):
    mesh = tm.make_mesh()
    assert mesh.axis_names == (tm.ENV_AXIS,) and mesh.size == 1 and mesh.group() is None
    with pytest.raises(ValueError):
        tm.make_mesh(2)
    x = torch.arange(12.0).reshape(4, 3)
    carry = RolloutCarry({"a": x}, x, (), EpisodeStats.create(4))
    sharded = tm.shard_batch(carry, mesh)
    _assert_bits(sharded.env_state, carry.env_state, "env_state")
    assert tm.shard_slice(mesh, 4) == (0, 4)
    # Collectives are skipped where no group is formed.
    assert tm.all_reduce_sum(x) is x and tm.all_gather_cat(x) is x and tm.broadcast_(x) is x
    # The rank-local reset and the sharded rollout are the one-process ones.
    hmesh = distributed.host_mesh()
    init = distributed.sharded_init_fn(env, B, hmesh)(seed=3)
    state, obs, _ = make_vec_env(env, B).reset(seed=3)
    _assert_bits(init.env_state, state, "state")
    assert torch.equal(init.obs, obs)
    run = sharded_rollout_fn(make_vec_env(env, B), _policy, 10, hmesh,
                             axis_name=(distributed.HOST_AXIS, distributed.CHIP_AXIS))
    carry, stats = run(init)
    ref, _ = rollout(make_vec_env(env, B), _policy,
                     RolloutCarry(state, obs, (), EpisodeStats.create(B)), 10, collect=False)
    _assert_bits(carry.env_state, ref.env_state, "rollout")
    assert stats == ref.stats.means()


def test_episode_means_sum_completed_episodes():
    st = EpisodeStats.create(2)
    for _ in range(3):
        st = st.update(torch.tensor([1.0, 2.0]), torch.tensor([False, True]),
                       {"constraint_violation": torch.tensor([0.0, 1.0])})
    m = st.means()
    assert m == {"mean_return": 2.0, "mean_length": 1.0, "mean_violations": 1.0, "episodes": 3}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_init_is_the_global_reset(cluster, single, layout):
    state, obs, _ = single
    out = cluster[layout]
    _assert_bits(out["init_state"], state, f"{layout} init")
    assert torch.equal(out["init_obs"], obs)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_rollout_matches_one_process(cluster, single, layout):
    _, _, carry = single
    out = cluster[layout]
    _assert_bits(out["state"], carry.env_state, f"{layout} state")
    assert torch.equal(out["obs"], carry.obs)
    ref = carry.stats.means()
    assert out["stats"]["episodes"] == ref["episodes"] >= B
    for k in ("mean_return", "mean_length", "mean_violations"):
        np.testing.assert_allclose(out["stats"][k], ref[k], rtol=1e-5, err_msg=k)


def test_sharded_rollout_matches_jax(cluster):
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**CONFIG))
    vec = jmake_vec_env(jenv, B)
    mesh = jmake_mesh()
    state, obs, _ = jax.jit(vec.reset)(jax.random.key(5))
    carry = JCarry(jshard_batch(state, mesh), jshard_batch(obs, mesh), (),
                   jshard_batch(JStats.create(B), mesh))
    policy = lambda ps, o: (jnp.full((o.shape[0], 4), 0.084), ps)  # noqa: E731
    _, stats = jsharded_rollout_fn(vec, policy, STEPS, mesh)(carry)
    stats = jax.device_get(stats)
    for layout in LAYOUTS:
        got = cluster[layout]["stats"]
        assert got["episodes"] == int(stats["episodes"]), layout
        for k in ("mean_return", "mean_length", "mean_violations"):
            np.testing.assert_allclose(got[k], float(stats[k]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"{layout} {k}")
