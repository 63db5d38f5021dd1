"""K8's and K6's observation branches (``parallel/fast_quad_planar.py``,
``parallel/fast_cartpole.py`` with ``fast_env.obs_noise_rows`` and
``goal_ext_rows``): the planar quadrotors' goal-horizon rows and the
observation white noise of both families, in the plain versions against the
JAX package (its K8 in Pallas interpret mode, its networks, its general
engine), mirroring tests/test_fast_quad_planar.py:302-420 and the noise
checks of tests/test_fast_policy.py.

Tolerances: goal rows rtol 1e-5 / atol 1e-6 against the env's goal table;
noise-free rows and records rtol 2e-4 / atol 2e-5 against the JAX kernel;
the noise in distribution only (its std within 0.5-2x the configured
one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ppo import PPO as TPPO
from safe_control_gym_torch.controllers.ppo import ActorCritic
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import fast_cartpole as tfc
from safe_control_gym_torch.parallel import fast_quad_planar as tf
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel.fast_quad_planar import (
    FastPlanarQuadPolicyRollout as JPlanarPolicyRollout)
from safe_control_gym_tpu.parallel.vector import make_vec_env as j_make_vec_env

B, T, SEED = 128, 4, 3
STAB2 = dict(quad_type=2, ctrl_freq=50, pyb_freq=200, episode_len_sec=4, task="stabilization",
             task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.05},
             cost="rl_reward", randomized_init=True, randomized_inertial_prop=True,
             done_on_out_of_bound=True, normalized_rl_action_space=True)
TRACK2 = dict(STAB2, task="traj_tracking",
              task_info={"trajectory_type": "figure8", "trajectory_plane": "zx",
                         "trajectory_position_offset": [0.5, 0.0], "trajectory_scale": 0.5,
                         "num_cycles": 1})
OBS_NOISE = {"observation": ({"disturbance_func": "white_noise", "std": 0.05},)}


def _envs(**cfg):
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def _policy(jenv, obs_dim, nu, logstd=None, seed=1):
    """The JAX PPO of ``jenv`` with numpy-seeded noise on the actor, and the
    port's ActorCritic holding the same weights."""
    jppo = JPPO(jenv, seed=0, rollout_batch_size=16, rollout_steps=4)
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(seed)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.full(nu, -0.5 if logstd is None else logstd, np.float32))
    ac = ActorCritic(obs_dim, nu, 64, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    return jppo, jac, ac


def test_goal_horizon_obs_in_kernel_planar():
    """The 2D quad tracking a figure-8 with h = 3 (obs 24): the recorded obs
    carry the env's goal-table rows clip(t + 1 .. t + h), the value and
    log-prob are the JAX networks' on the extended obs, and observe()
    extends the post-rollout state; PPO trains through the plain K8."""
    jenv, tenv = _envs(**TRACK2, obs_goal_horizon=3)
    assert jenv.spaces.obs_dim == tenv.spaces.obs_dim == 24
    jppo, jac, ac = _policy(jenv, 24, 2)
    fp = tf.FastPlanarQuadPolicyRollout(tenv, B, T, device="cpu")
    assert fp.obs_dim == 24 and fp.traj_rows == 55
    rows, traj = fp.run(fp.reset(seed=0), fp.pack_weights(ac.actor, ac.critic, ac.logstd),
                        seed=SEED)
    d = fp.unpack_traj(traj)
    assert d["obs"].shape == (T, B, 24) and d["term_obs"].shape == (T, B, 24)
    xg = np.asarray(jenv.x_goal, np.float32)
    for t in range(T):
        for i in range(3):
            np.testing.assert_allclose(d["obs"][t, :, 6 * (1 + i):6 * (2 + i)].numpy(),
                                       np.broadcast_to(xg[min(t + 1 + i, len(xg) - 1)], (B, 6)),
                                       rtol=1e-5, atol=1e-6)
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)
    full = fp.observe(rows).numpy()
    np.testing.assert_array_equal(full[:, :6], fp.states(rows).numpy())
    np.testing.assert_allclose(full[:, 6:12], np.broadcast_to(xg[T + 1], (B, 6)),
                               rtol=1e-5, atol=1e-6)
    ppo = TPPO(tenv, seed=0, use_fast_rollout=True, use_fast_update=True,
               rollout_batch_size=64, rollout_steps=4, opt_epochs=2, mini_batch_size=128)
    assert isinstance(ppo._fp, tf.FastPlanarQuadPolicyRollout) and ppo._fp.obs_dim == 24
    _, m = ppo._train_step(ppo.state)
    for k in ("policy_loss", "value_loss", "approx_kl"):
        assert torch.isfinite(m[k]), k


@pytest.mark.parametrize("quad_type", [1, 2])
def test_goal_horizon_stab_variant_planar(quad_type):
    """Stabilization appends the static goal once (2D: obs 12; 1D: obs 4)."""
    jenv, tenv = _envs(**dict(STAB2, quad_type=quad_type, obs_goal_horizon=2))
    nx, nu = tf.nx_nu(quad_type)
    assert tenv.spaces.obs_dim == jenv.spaces.obs_dim == 2 * nx
    _, _, ac = _policy(jenv, 2 * nx, nu)
    fp = tf.FastPlanarQuadPolicyRollout(tenv, B, 2, device="cpu")
    assert fp.obs_dim == 2 * nx
    rows, traj = fp.run(fp.reset(seed=0), fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=1)
    d = fp.unpack_traj(traj)
    xg = np.asarray(jenv.x_goal, np.float32)
    np.testing.assert_allclose(d["obs"][:, :, nx:].numpy(), np.broadcast_to(xg, (2, B, nx)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fp.observe(rows)[:, nx:].numpy(), np.broadcast_to(xg, (B, nx)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("task", ["traj_tracking", "stabilization"])
def test_goal_horizon_records_match_jax_kernel_planar(task):
    """The plain K8 against the JAX package's K8 (interpret mode) from the
    same rows, at h = 2 (tracking: obs 18; stabilization: obs 12), some envs
    two steps from the time limit: logstd = -20 makes both packages' actions
    their means.  Rows and records at the suite's tolerances, the log-prob
    (the other package's Gaussian draws) left out."""
    cfg = dict(TRACK2 if task == "traj_tracking" else STAB2, obs_goal_horizon=2)
    jenv, tenv = _envs(**cfg)
    D = 18 if task == "traj_tracking" else 12
    _, jac, ac = _policy(jenv, D, 2, logstd=-20.0)
    jfp = JPlanarPolicyRollout(jenv, B, T, sub=1, interpret=True)
    jrows = np.asarray(jfp.reset(0)).copy()
    L = tf.rows_layout(6)
    jrows[L["STEP"], 0, ::4] = jfp.params["max_steps"] - 2
    jw = jfp.pack_weights(jac.actor_params, jac.critic_params, jac.logstd)
    jout, jtraj = jfp.run(jnp.asarray(jrows), jw, seed=SEED)
    jd = {k: np.asarray(v) for k, v in jfp.unpack_traj(jtraj).items()}
    fp = tf.FastPlanarQuadPolicyRollout(tenv, B, T, device="cpu")
    rows, traj = fp.run(torch.from_numpy(jrows.reshape(L["NROWS"], B).copy()),
                        fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    d = fp.unpack_traj(traj)
    assert d["trunc"].sum() >= B // 4 - 4 and torch.equal(d["trunc"], torch.tensor(jd["trunc"]))
    for k in ("obs", "act", "rew", "done", "v", "term_obs"):
        np.testing.assert_allclose(d[k].numpy(), jd[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert np.abs(d["term_obs"].numpy()[d["trunc"].numpy() > 0][:, 6:]).sum() > 0
    np.testing.assert_allclose(rows.numpy(), np.asarray(jout).reshape(L["NROWS"], B),
                               rtol=2e-4, atol=2e-5)


def test_fault_a_goal_rows_follow_the_env_planar():
    """Fault (a) in K8: with episode_len_sec * ctrl_freq = 200.5 the goal
    table has 201 rows and max_steps is 200; the port's goal rows at the
    last steps equal the port's and the JAX package's general engines
    (quadrotor.py:539), where the JAX kernel clips at max_steps - 1
    (fast_quad_planar.py:154)."""
    cfg = dict(TRACK2, episode_len_sec=4.01, obs_goal_horizon=2, randomized_init=False,
               init_state=[0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    jenv, tenv = _envs(**cfg)
    _, jac, ac = _policy(jenv, 18, 2, logstd=-20.0)
    jfp = JPlanarPolicyRollout(jenv, B, 1, sub=1, interpret=True)
    assert jfp.params["max_steps"] == 200 and np.asarray(jenv.x_goal).shape[0] == 201
    L = tf.rows_layout(6)
    steps = np.arange(B) % 4 + 196  # 196..199; 199 truncates
    jrows = np.asarray(jfp.reset(0)).copy()
    jrows[L["STEP"], 0] = steps
    _, jtraj = jfp.run(jnp.asarray(jrows),
                       jfp.pack_weights(jac.actor_params, jac.critic_params, jac.logstd), seed=1)
    jobs = np.asarray(jfp.unpack_traj(jtraj)["obs"])[0]
    fp = tf.FastPlanarQuadPolicyRollout(tenv, B, 1, device="cpu")
    _, traj = fp.run(torch.from_numpy(jrows.reshape(L["NROWS"], B).copy()),
                     fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=1)
    d = fp.unpack_traj(traj)

    def general(offset):
        vec, jvec = make_vec_env(tenv, B), j_make_vec_env(jenv, B)
        st, _, _ = vec.reset(seed=0)
        st = st.replace(ctrl_step=torch.tensor(steps + offset - 1, dtype=torch.int32))
        tobs = vec.step_no_reset(st, torch.zeros(B, 2))[1].numpy()
        jst, _, _ = jax.jit(jvec.reset)(jax.random.key(0))
        jst = jst.replace(ctrl_step=jnp.asarray(steps + offset - 1, jnp.int32))
        return tobs, np.asarray(jax.jit(jvec.step_no_reset)(jst, jnp.zeros((B, 2)))[1])

    tobs, jgen = general(0)
    got = d["obs"][0, :, 6:].numpy()
    np.testing.assert_allclose(got, tobs[:, 6:], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jgen[:, 6:], rtol=1e-5, atol=1e-6)
    late = steps >= 198  # the env's rows reach index 200, past the kernel's 199
    assert np.abs(jobs[late, 6:] - got[late]).max() > 1e-3
    trunc = d["trunc"][0].numpy() > 0
    assert trunc.any() and (steps[trunc] == 199).all()
    tobs1, jgen1 = general(1)
    for ref in (tobs1, jgen1):
        np.testing.assert_allclose(d["term_obs"][0, trunc, 6:].numpy(), ref[trunc, 6:],
                                   rtol=1e-5, atol=1e-6)


def _noise_pair(make_env, engine, nu, steps=8):
    """An engine with and without observation noise of std 0.05, zero
    weights and logstd = -20: the actions are 0 whatever the observation,
    so the two runs step the same states."""
    out = []
    for dist in (OBS_NOISE, None):
        fp = engine(make_env(dist), B, steps, device="cpu")
        ac = ActorCritic(fp.obs_dim, nu, 64, "tanh")
        with torch.no_grad():
            for prm in ac.parameters():
                prm.zero_()
            ac.logstd.fill_(-20.0)
        rows0 = fp.reset(seed=0)
        rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
        out.append((fp, rows0, rows, fp.unpack_traj(traj)))
    return out


FAMILIES = {
    # 4-step episodes: the 2D quad stabilizing with its goal rows (h = 2),
    # and CartPole stabilization (K6 has no goal rows).
    "quad2d": (lambda dist: tq.make_quadrotor(tq.QuadrotorConfig(**dict(
        STAB2, ctrl_freq=10, pyb_freq=40, episode_len_sec=0.4, disturbances=dist,
        obs_goal_horizon=2, randomized_inertial_prop=False)), device="cpu"),
               tf.FastPlanarQuadPolicyRollout, 6, 2),
    "quad1d": (lambda dist: tq.make_quadrotor(tq.QuadrotorConfig(**dict(
        STAB2, quad_type=1, ctrl_freq=10, pyb_freq=40, episode_len_sec=0.4, disturbances=dist,
        randomized_inertial_prop=False)), device="cpu"),
               tf.FastPlanarQuadPolicyRollout, 2, 1),
    "cartpole": (lambda dist: tc.make_cartpole(tc.CartPoleConfig(
        ctrl_freq=10, pyb_freq=10, episode_len_sec=0.4, task="stabilization", cost="rl_reward",
        randomized_init=True, normalized_rl_action_space=True, disturbances=dist), device="cpu"),
                 tfc.FastCartPolePolicyRollout, 4, 1),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_obs_noise_on_policy_terminal_and_bootstrap_obs(family):
    """K8 and K6 with observation white noise: the policy's obs, the stored
    terminal obs (fresh draws, truncated steps only) and the bootstrap obs
    (observe with a generator) carry N(0, 0.05) noise on the state rows; the
    env state and the goal rows stay clean."""
    make_env, engine, nx, nu = FAMILIES[family]
    std = 0.05
    (fp_n, rows0, rows_n, d_n), (fp_c, _, rows_c, d_c) = _noise_pair(make_env, engine, nu)
    assert fp_n.params["obs_noise_std"] == std
    assert torch.equal(rows_n.view(torch.int32), rows_c.view(torch.int32))
    assert torch.equal(d_n["rew"], d_c["rew"])
    pol = (d_n["obs"] - d_c["obs"])[..., :nx]
    assert 0.5 * std < float(pol.std()) < 2.0 * std
    trunc = d_n["trunc"] > 0
    assert int(trunc.sum()) >= B
    diff = (d_n["term_obs"] - d_c["term_obs"])[trunc][:, :nx]
    assert 0.5 * std < float(diff.std()) < 2.0 * std
    assert not d_n["term_obs"][~trunc].any()
    assert torch.equal(d_n["obs"][..., nx:], d_c["obs"][..., nx:])
    assert torch.equal(d_n["term_obs"][..., nx:], d_c["term_obs"][..., nx:])
    gen = torch.Generator().manual_seed(7)
    dob = (fp_n.observe(rows_n, generator=gen) - fp_n.observe(rows_n))[:, :nx]
    assert 0.5 * std < float(dob.std()) < 2.0 * std
    state = gen.get_state()
    assert torch.equal(fp_c.observe(rows_c, generator=gen), fp_c.observe(rows_c))
    assert torch.equal(gen.get_state(), state)


def test_k6_noise_free_records_unchanged():
    """K6 without observation noise keeps its state-observation records:
    the plain rows and records of CartPole stabilization equal those of the
    same config before the noise branch (the record's terminal obs is the
    post-step state times trunc), and PPO trains with the noise on."""
    make_env, engine, _, _ = FAMILIES["cartpole"]
    env = make_env(None)
    fp = engine(env, B, 8, device="cpu")
    assert tfc.FP.obs_ext(fp.params, 4) is None
    ac = ActorCritic(4, 1, 64, "tanh", generator=torch.Generator().manual_seed(0))
    rows0 = fp.reset(seed=0)
    rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    d = fp.unpack_traj(traj)
    torch.testing.assert_close(d["obs"][0], rows0[:4].T, rtol=0, atol=0)
    trunc = d["trunc"] > 0
    assert trunc.any() and not d["term_obs"][~trunc].any()
    ppo = TPPO(make_env(OBS_NOISE), seed=0, use_fast_rollout=True, use_fast_update=True,
               rollout_batch_size=64, rollout_steps=8, opt_epochs=2, mini_batch_size=256)
    assert ppo._fp.params["obs_noise_std"] == 0.05
    _, m = ppo._train_step(ppo.state)
    for k in ("policy_loss", "value_loss", "approx_kl"):
        assert torch.isfinite(m[k]), k
