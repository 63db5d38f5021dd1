"""The rollout path as a whole on the general engine: the port's ``make_vec_env`` +
``rollout`` (K1 in its plain version here) against the JAX package's, on
BASELINE config 4 with short episodes so that time-limit and out-of-bound
auto-resets both occur."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import rollout as tro
from safe_control_gym_torch.parallel.vector import make_vec_env as t_make_vec_env
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel import make_vec_env as j_make_vec_env
from safe_control_gym_tpu.parallel.rollout import EpisodeStats as JStats
from safe_control_gym_tpu.parallel.rollout import RolloutCarry as JCarry
from safe_control_gym_tpu.parallel.rollout import rollout as j_rollout

B, STEPS = 128, 25

CFG4 = dict(
    quad_type=3, ctrl_freq=60, pyb_freq=240,
    episode_len_sec=0.35,  # 21-step episodes: a time-limit reset in 25 steps
    task="traj_tracking",
    task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
               "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
               "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
    cost="rl_reward", randomized_inertial_prop=True, randomized_init=True,
    constraints=({"constraint_form": "default_constraint", "constrained_variable": "state"},
                 {"constraint_form": "default_constraint", "constrained_variable": "input"}),
    disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.005,
                                "duration": 10, "decay_rate": 0.8},)},
    done_on_out_of_bound=True,
)


def test_general_engine_rollout_matches_jax():
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**CFG4))
    jvec = j_make_vec_env(jenv, B)
    js, jo, _ = jax.jit(jvec.reset)(jax.random.key(0))
    hover = float(jenv.u_goal[0])
    jact = jnp.full((B, 4), hover, jnp.float32)
    jcarry = JCarry(js, jo, (), JStats.create(B))
    jcarry, jtraj = jax.jit(
        lambda c: j_rollout(jvec, lambda ps, o: (jact, ps), c, STEPS))(jcarry)

    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**CFG4), device="cpu")
    tvec = t_make_vec_env(tenv, B)
    ts, to, _ = tvec.reset(env_seeds=torch.tensor(np.asarray(js.env_seed)))
    tact = torch.full((B, 4), hover)
    tcarry = tro.RolloutCarry(ts, to, (), tro.EpisodeStats.create(B))
    tcarry, ttraj = tro.rollout(tvec, lambda ps, o: (tact, ps), tcarry, STEPS)

    done = np.asarray(jtraj["done"])
    # Per-step done flags agree exactly, with both kinds of reset present.
    np.testing.assert_array_equal(ttraj["done"].numpy(), done)
    # Envs that ran out of bounds earlier restarted their episode clock.
    assert done[20].sum() == B - done[:20].any(0).sum()  # time limits
    assert done[:20].any()  # out-of-bound terminations
    np.testing.assert_allclose(tcarry.env_state.x.numpy(), np.asarray(jcarry.env_state.x),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ttraj["reward"].numpy(), np.asarray(jtraj["reward"]), atol=1e-5)
    np.testing.assert_allclose(ttraj["terminal_observation"].numpy(),
                               np.asarray(jtraj["terminal_observation"]), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(ttraj["constraint_violation"].numpy(),
                                  np.asarray(jtraj["constraint_violation"]))
    es = tcarry.env_state
    np.testing.assert_array_equal(es.episode_idx.numpy(), np.asarray(jcarry.env_state.episode_idx))
    np.testing.assert_array_equal(es.ctrl_step.numpy(), np.asarray(jcarry.env_state.ctrl_step))
    np.testing.assert_allclose(es.mass.numpy(), np.asarray(jcarry.env_state.mass), rtol=1e-6)
    np.testing.assert_array_equal(
        es.dist_offsets["dynamics"].numpy(),
        np.asarray(jcarry.env_state.dist_sched["dynamics"]["offsets"]))

    jm = {k: float(v) for k, v in jax.device_get(jcarry.stats.means()).items()}
    tm = tcarry.stats.means()
    assert tm["episodes"] == jm["episodes"] >= B
    for k in ("mean_return", "mean_length", "mean_violations"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, err_msg=k)
    assert tcarry.stats.ep_length.dtype == torch.int32
    assert tcarry.stats.done_count.dtype == torch.int32


def test_vec_reset_seed_path():
    """reset(seed=...) draws the port's own per-env seeds; env_seeds wins."""
    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**CFG4), device="cpu")
    vec = t_make_vec_env(tenv, 16)
    s0, _, _ = vec.reset(seed=0)
    s1, _, _ = vec.reset(seed=0)
    s2, _, _ = vec.reset(seed=1)
    assert torch.equal(s0.x, s1.x) and not torch.equal(s0.x, s2.x)
    s3, _, _ = vec.reset(env_seeds=s2.env_seed)
    assert torch.equal(s3.x, s2.x)
