"""The port's 1D and 2D quadrotors (``envs/quadrotor.py``) against
``jax.vmap`` of the JAX package's env (``use_pallas=False``): BASELINE
config 3 (2D stabilization with randomized mass and inertia and a state
box), and variants on both quad types in RK4 and Euler, with the impulse,
trajectory tracking, the quadratic cost's goal capture, the normalized
action space with goal-horizon observations and the time limit; and through
auto-resets on both packages' vector envs.  States at rtol 2e-4 / atol
2e-5, reset draws and done flags exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import rollout as tro
from safe_control_gym_torch.parallel.vector import make_vec_env as t_make_vec_env
from safe_control_gym_torch.utils.convert import quad_state_from_numpy
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel import make_vec_env as j_make_vec_env
from safe_control_gym_tpu.parallel.rollout import EpisodeStats as JStats
from safe_control_gym_tpu.parallel.rollout import RolloutCarry as JCarry
from safe_control_gym_tpu.parallel.rollout import rollout as j_rollout

B = 128
# BASELINE config 3 (bench.py bench_quad2d).
CFG3 = dict(quad_type=2, ctrl_freq=50, pyb_freq=200, episode_len_sec=10, task="stabilization",
            task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.05},
            randomized_init=True, randomized_inertial_prop=True,
            constraints=({"constraint_form": "default_constraint",
                          "constrained_variable": "state"},),
            done_on_out_of_bound=True)
IMPULSE = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02, "duration": 6,
                         "decay_rate": 0.8},)}
INPUT_BOX = ({"constraint_form": "default_constraint", "constrained_variable": "state"},
             {"constraint_form": "default_constraint", "constrained_variable": "input"})

_VARIANTS = {
    "config3": CFG3,
    "config3_euler_impulse_input_box": dict(CFG3, physics="dyn", disturbances=IMPULSE,
                                            constraints=INPUT_BOX),
    "2d_circle_normalized_goal_horizon": dict(
        CFG3, task="traj_tracking", normalized_rl_action_space=True, obs_goal_horizon=2,
        task_info={"trajectory_type": "circle", "trajectory_plane": "xz",
                   "trajectory_scale": 0.5}),
    "2d_quadratic_goal_time_limit": dict(
        CFG3, cost="quadratic", episode_len_sec=0.1, q_weight=[1, 0.1, 1, 0.1, 0.5, 0.1],
        r_weight=[0.5, 0.5], task_info={"stabilization_goal": [0, 1],
                                        "stabilization_goal_tolerance": 0.7}),
    "1d_stabilization": dict(CFG3, quad_type=1),
    "1d_euler_figure8_impulse": dict(
        CFG3, quad_type=1, physics="dyn", task="traj_tracking", disturbances=IMPULSE,
        task_info={"trajectory_type": "figure8", "trajectory_plane": "zx",
                   "trajectory_position_offset": [1.0, 0.0], "trajectory_scale": 0.5}),
}


def _envs(cfg):
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg, use_pallas=False)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def _actions(nu, center, steps, seed=0):
    """Thrusts around ``center``; a few envs command 0 or three times it,
    outside the action box on the high side."""
    rng = np.random.default_rng(seed)
    a = center * (1.0 + 0.3 * rng.uniform(-1, 1, (steps, B, nu)))
    a[:, :4] = 0.0
    a[:, 4:8] = 3.0 * center
    return a.astype(np.float32)


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_reset_and_steps_match_jax(variant):
    cfg = _VARIANTS[variant]
    jenv, tenv = _envs(cfg)
    nu = tenv.spaces.action_dim
    js, jo, jinfo = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    ts, to, tinfo = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass), rtol=1e-6)
    np.testing.assert_allclose(ts.j_diag.numpy(), np.asarray(js.j_diag), rtol=1e-6)
    if "disturbances" in cfg:
        np.testing.assert_array_equal(ts.dist_offsets["dynamics"].numpy(),
                                      np.asarray(js.dist_sched["dynamics"]["offsets"]))
    np.testing.assert_allclose(tinfo["constraint_values_state"].numpy(),
                               np.asarray(jinfo["constraint_values_state"]), atol=2e-7)

    center = 0.0 if cfg.get("normalized_rl_action_space") else float(jenv.u_goal[0])
    acts = _actions(nu, center, 25) if center else \
        np.random.default_rng(1).uniform(-1.5, 1.5, (25, B, nu)).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step))
    dones = 0
    for a in acts:
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a))
        ts, to, tr, td, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in ("constraint_violation", "TimeLimit.truncated", "collision",
                  "at_goal_position", "task_completed", "current_target_gate_id"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
        np.testing.assert_allclose(ti["mse"].numpy(), np.asarray(ji["mse"]), rtol=2e-4, atol=2e-5)
        dones += int(td.sum())
    assert dones > 0


def test_rollout_through_resets_matches_jax():
    """Both packages' vector envs and rollouts for 25 steps of 6-step 2D
    episodes with impulse and randomized inertia: done flags exactly, states,
    rewards and the impulse offsets through the auto-resets."""
    cfg = dict(CFG3, episode_len_sec=0.12, done_on_out_of_bound=False, disturbances=IMPULSE)
    jenv, tenv = _envs(cfg)
    hover = float(jenv.u_goal[0])
    jvec = j_make_vec_env(jenv, B)
    js, jo, _ = jax.jit(jvec.reset)(jax.random.key(3))
    jact = jnp.full((B, 2), hover, jnp.float32)
    jcarry, jtraj = jax.jit(lambda c: j_rollout(jvec, lambda ps, o: (jact, ps), c, 25))(
        JCarry(js, jo, (), JStats.create(B)))

    tvec = t_make_vec_env(tenv, B)
    ts, to, _ = tvec.reset(env_seeds=torch.tensor(np.asarray(js.env_seed)))
    tact = torch.full((B, 2), hover)
    tcarry, ttraj = tro.rollout(tvec, lambda ps, o: (tact, ps),
                                tro.RolloutCarry(ts, to, (), tro.EpisodeStats.create(B)), 25)
    np.testing.assert_array_equal(ttraj["done"].numpy(), np.asarray(jtraj["done"]))
    assert np.asarray(jtraj["done"]).sum() == 4 * B
    for k in ("obs", "reward", "terminal_observation", "constraint_violation"):
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    es = jcarry.env_state
    np.testing.assert_array_equal(tcarry.env_state.episode_idx.numpy(), np.asarray(es.episode_idx))
    np.testing.assert_allclose(tcarry.env_state.mass.numpy(), np.asarray(es.mass), rtol=1e-6)
    np.testing.assert_array_equal(tcarry.env_state.dist_offsets["dynamics"].numpy(),
                                  np.asarray(es.dist_sched["dynamics"]["offsets"]))


@pytest.mark.parametrize("quad_type", [1, 2])
def test_planar_forces_match_jax_actuation(quad_type):
    """The motor grouping of cmd2pwm: 1D commands all four motors, 2D the
    pairs (T1, T2, T2, T1)."""
    nu = tq.TYPE_NX_NU[quad_type][1]
    rng = np.random.default_rng(quad_type)
    thrust = rng.uniform(-0.05, 0.6, (64, nu)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda t: jq.pwm2rpm(jq.cmd2pwm(t, jnp.float32)) ** 2 * jq.KF)(
        jnp.asarray(thrust)))
    got = tq.planar_forces(torch.from_numpy(thrust), 4 // nu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_convert_carries_planar_state():
    jenv, tenv = _envs(dict(CFG3, disturbances=IMPULSE))
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(5), B))
    fields = jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                        if k != "key"})
    conv = quad_state_from_numpy(fields, "cpu")
    own, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    assert conv.x.shape == (B, 6)
    torch.testing.assert_close(conv.x, own.x, rtol=1e-6, atol=2e-7)
    assert torch.equal(conv.dist_offsets["dynamics"], own.dist_offsets["dynamics"])
    a = torch.full((B, 2), float(tenv.u_goal[0]))
    s1, _, _, d1, _ = tenv.step(conv, a)
    s2, _, _, d2, _ = tenv.step(own, a)
    torch.testing.assert_close(s1.x, s2.x, rtol=2e-4, atol=2e-5)
    assert torch.equal(d1, d2)
