"""K3's observation branches (``parallel/fast_policy.py`` with
``parallel/fast_env.py::obs_noise_rows`` and ``goal_ext_rows``): the
goal-horizon observation rows and the observation white noise, in the plain
version against the JAX package (its K3 in Pallas interpret mode, its
networks and its general engine), and PPO's train step on a small config
4-GH (config 4 with two goal-horizon blocks, obs 36) against the JAX
package's update on the same batch.

Tolerances: goal rows rtol 1e-5 / atol 1e-6 against the env's goal table
(tests/test_fast_policy.py:229-236); noise-free rows and records rtol 2e-4 /
atol 2e-5 against the JAX kernel (tests/test_fast_env.py:85); the noise in
distribution only (its std within 0.5-2x the configured one), since the
port's Philox draws are not the TPU's; params after a train step rtol 2e-4
/ atol 3e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.baseline import cfg4
from safe_control_gym_torch.controllers.ppo import PPO as TPPO
from safe_control_gym_torch.controllers.ppo import ActorCritic
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import fast_policy as tp
from safe_control_gym_torch.parallel.fast_update import kernel_scope
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel.fast_policy import FastPolicyRollout as JFastPolicyRollout
from safe_control_gym_tpu.parallel.vector import make_vec_env as j_make_vec_env

B, T, SEED = 128, 4, 3
TRACK = dict(
    quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=2, task="traj_tracking",
    task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
               "trajectory_position_offset": [0, 0], "trajectory_scale": 1.0,
               "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
    cost="rl_reward", normalized_rl_action_space=True)
STAB = dict(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=2, task="stabilization",
            task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
            cost="rl_reward", normalized_rl_action_space=True)
OBS_NOISE = {"observation": ({"disturbance_func": "white_noise", "std": 0.05},)}


def _envs(**cfg):
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def _policy(jenv, obs_dim, logstd=None, seed=1):
    """The JAX PPO of ``jenv`` with numpy-seeded noise on the actor (its
    output gain is 0.01), and the port's ActorCritic holding the same
    weights."""
    jppo = JPPO(jenv, seed=0, rollout_batch_size=16, rollout_steps=4)
    jac = jax.device_get(jppo.state.ac)
    rng = np.random.default_rng(seed)
    jac = jac.replace(
        actor_params=jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  jac.actor_params),
        logstd=np.asarray([-0.5, -0.7, -0.3, -0.6] if logstd is None else [logstd] * 4,
                          np.float32))
    ac = ActorCritic(obs_dim, 4, 64, "tanh")
    convert.load_actor_critic(ac, jac.actor_params, jac.critic_params, jac.logstd)
    return jppo, jac, ac


@pytest.fixture(scope="module")
def horizon3():
    """JAX's test_goal_horizon_obs_in_kernel config (h = 3, obs 48)."""
    jenv, tenv = _envs(**TRACK, obs_goal_horizon=3)
    jppo, jac, ac = _policy(jenv, 48)
    fp = tp.FastPolicyRollout(tenv, B, T, device="cpu")
    rows0 = fp.reset(seed=0)
    rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    return dict(jenv=jenv, tenv=tenv, jppo=jppo, jac=jac, fp=fp, rows=rows, traj=traj,
                d=fp.unpack_traj(traj))


def test_goal_horizon_obs_in_kernel(horizon3):
    """The recorded obs carry the next h reference states of the env's goal
    table, the value and log-prob are the JAX networks' on the extended
    obs, and observe() extends the post-rollout state for the bootstrap."""
    fp, d, jenv = horizon3["fp"], horizon3["d"], horizon3["jenv"]
    assert jenv.spaces.obs_dim == fp.obs_dim == 48 and fp.traj_rows == 105
    assert horizon3["traj"].shape == (T, 105, B)
    assert d["obs"].shape == (T, B, 48) and d["term_obs"].shape == (T, B, 48)
    xg = np.asarray(jenv.x_goal, np.float32)
    for t in range(T):
        for i in range(3):
            np.testing.assert_allclose(d["obs"][t, :, 12 * (1 + i):12 * (2 + i)].numpy(),
                                       np.broadcast_to(xg[min(t + 1 + i, len(xg) - 1)], (B, 12)),
                                       rtol=1e-5, atol=1e-6)
    jppo, jac = horizon3["jppo"], horizon3["jac"]
    obs, act = jnp.asarray(d["obs"].numpy()), jnp.asarray(d["act"].numpy())
    np.testing.assert_allclose(d["v"].numpy(), np.asarray(jppo._value(jac, obs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(d["logp"].numpy(), np.asarray(jppo._dist(jac, obs).log_prob(act)),
                               rtol=2e-3, atol=2e-3)
    full = fp.observe(horizon3["rows"]).numpy()
    assert full.shape == (B, 48)
    np.testing.assert_array_equal(full[:, :12], fp.states(horizon3["rows"]).numpy())
    np.testing.assert_allclose(full[:, 12:24], np.broadcast_to(xg[T + 1], (B, 12)),
                               rtol=1e-5, atol=1e-6)


def test_goal_horizon_records_match_jax_kernel():
    """The plain K3 against the JAX package's K3 (interpret mode) from the
    same rows, at h = 3 with some envs two steps from the time limit, so
    that truncations store terminal observations with goal rows: logstd =
    -20 makes both packages' actions their means, whatever their random
    bits.  Rows and records at the suite's tolerances; the log-prob holds
    the other package's Gaussian draws and is left out."""
    jenv, tenv = _envs(**TRACK, obs_goal_horizon=3)
    jppo, jac, ac = _policy(jenv, 48, logstd=-20.0)
    jfp = JFastPolicyRollout(jenv, B, T, sub=1, interpret=True)
    jrows = np.asarray(jfp.reset(0)).copy()
    jrows[16, 0, ::4] = jfp.params["max_steps"] - 2
    jw = jfp.pack_weights(jac.actor_params, jac.critic_params, jac.logstd)
    jout, jtraj = jfp.run(jnp.asarray(jrows), jw, seed=SEED)
    jd = {k: np.asarray(v) for k, v in jfp.unpack_traj(jtraj).items()}

    fp = tp.FastPolicyRollout(tenv, B, T, device="cpu")
    rows0 = torch.from_numpy(jrows.reshape(27, B).copy())
    rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
    d = fp.unpack_traj(traj)
    assert d["trunc"].sum() == B // 4 and jd["trunc"].sum() == B // 4
    for k in ("obs", "act", "rew", "done", "trunc", "v", "term_obs"):
        np.testing.assert_allclose(d[k].numpy(), jd[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert np.abs(d["term_obs"].numpy()[d["trunc"].numpy() > 0][:, 12:]).sum() > 0
    assert torch.isfinite(d["logp"]).all()
    np.testing.assert_allclose(rows.numpy(), np.asarray(jout).reshape(27, B), rtol=2e-4,
                               atol=2e-5)


def test_goal_horizon_stab_variant():
    """Stabilization appends the static goal once (obs 24), in the record
    and in observe()."""
    jenv, tenv = _envs(**STAB, obs_goal_horizon=2)
    assert jenv.spaces.obs_dim == tenv.spaces.obs_dim == 24
    _, _, ac = _policy(jenv, 24)
    fp = tp.FastPolicyRollout(tenv, B, 2, device="cpu")
    assert fp.obs_dim == 24
    rows, traj = fp.run(fp.reset(seed=0), fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=1)
    d = fp.unpack_traj(traj)
    xg = np.asarray(jenv.x_goal, np.float32)
    np.testing.assert_allclose(d["obs"][:, :, 12:].numpy(), np.broadcast_to(xg, (2, B, 12)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fp.observe(rows)[:, 12:].numpy(), np.broadcast_to(xg, (B, 12)),
                               rtol=1e-6, atol=1e-7)


def _noise_pair(horizon):
    """JAX's test_obs_noise_on_terminal_and_bootstrap_obs config (4-step
    episodes) with and without observation noise of std 0.05, zero weights
    and logstd = -20: the actions are 0 whatever the observation, so the
    two runs step the same states (the policy's draws are call site 0's,
    the same in both)."""
    out = []
    for dist in (OBS_NOISE, None):
        cfg = dict(TRACK, ctrl_freq=4, pyb_freq=16, episode_len_sec=1, disturbances=dist,
                   obs_goal_horizon=horizon)
        env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
        fp = tp.FastPolicyRollout(env, B, 8, device="cpu")
        ac = ActorCritic(fp.obs_dim, 4, 64, "tanh")
        with torch.no_grad():
            for prm in ac.parameters():
                prm.zero_()
            ac.logstd.fill_(-20.0)
        rows0 = fp.reset(seed=0)
        rows, traj = fp.run(rows0, fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=SEED)
        out.append((fp, rows0, rows, fp.unpack_traj(traj)))
    return out


@pytest.mark.parametrize("horizon", [0, 2])
def test_obs_noise_on_terminal_and_bootstrap_obs(horizon):
    """The policy's obs, the stored terminal obs (fresh draws, truncated
    steps only) and the bootstrap obs (observe with the controller's
    generator) carry N(0, 0.05) noise on the state rows; the env state and
    the goal rows stay clean."""
    std = 0.05
    (fp_n, rows0, rows_n, d_n), (fp_c, _, rows_c, d_c) = _noise_pair(horizon)
    assert torch.equal(rows_n.view(torch.int32), rows_c.view(torch.int32))  # the state is clean
    assert torch.equal(d_n["rew"], d_c["rew"]) and torch.equal(d_n["done"], d_c["done"])
    pol = (d_n["obs"] - d_c["obs"])[..., :12]
    assert 0.5 * std < float(pol.std()) < 2.0 * std
    torch.testing.assert_close(d_c["obs"][0, :, :12], fp_c.states(rows0), rtol=0, atol=0)
    trunc = d_n["trunc"] > 0
    assert int(trunc.sum()) >= B
    diff = (d_n["term_obs"] - d_c["term_obs"])[trunc][:, :12]
    assert float(diff.abs().max()) > 1e-4
    assert 0.5 * std < float(diff.std()) < 2.0 * std
    # Fresh draws: the terminal noise is not the policy obs' of the step.
    assert not torch.equal(diff, pol[trunc])
    assert not d_n["term_obs"][~trunc].any()
    if horizon:
        assert torch.equal(d_n["obs"][..., 12:], d_c["obs"][..., 12:])
        assert torch.equal(d_n["term_obs"][..., 12:], d_c["term_obs"][..., 12:])
        assert d_n["term_obs"][trunc][:, 12:].abs().sum() > 0
    gen = torch.Generator().manual_seed(7)
    dob = (fp_n.observe(rows_n, generator=gen) - fp_n.observe(rows_n))[:, :12]
    assert 0.5 * std < float(dob.std()) < 2.0 * std
    # Without noise configured the generator is neither used nor advanced.
    state = gen.get_state()
    assert torch.equal(fp_c.observe(rows_c, generator=gen), fp_c.observe(rows_c))
    assert torch.equal(gen.get_state(), state)


def test_fault_a_goal_rows_follow_the_env():
    """Fault (a) of the reference: the JAX kernels clip goal-horizon
    indices at max_steps - 1 (fast_policy.py:118), the env at its goal
    table's last row (quadrotor.py:539); with episode_len_sec * ctrl_freq =
    120.6 the table has 121 rows and max_steps is 120.  The port's goal rows
    (the policy's obs and the terminal obs of the truncated step) equal the
    port's and the JAX package's general engines, and differ from the JAX
    kernel's at the last steps."""
    cfg = dict(TRACK, episode_len_sec=2.01, obs_goal_horizon=3)
    jenv, tenv = _envs(**cfg)
    _, jac, ac = _policy(jenv, 48, logstd=-20.0)
    jfp = JFastPolicyRollout(jenv, B, 1, sub=1, interpret=True)
    assert jfp.params["max_steps"] == 120 and np.asarray(jenv.x_goal).shape[0] == 121
    steps = np.arange(B) % 5 + 115  # 115..119; 119 truncates
    jrows = np.asarray(jfp.reset(0)).copy()
    jrows[16, 0] = steps
    _, jtraj = jfp.run(jnp.asarray(jrows),
                       jfp.pack_weights(jac.actor_params, jac.critic_params, jac.logstd), seed=1)
    jobs = np.asarray(jfp.unpack_traj(jtraj)["obs"])[0]
    fp = tp.FastPolicyRollout(tenv, B, 1, device="cpu")
    _, traj = fp.run(torch.from_numpy(jrows.reshape(27, B).copy()),
                     fp.pack_weights(ac.actor, ac.critic, ac.logstd), seed=1)
    d = fp.unpack_traj(traj)

    # The general engines' observations at ctrl_step s (a step from s - 1)
    # and, for the truncated step, the new state's (a step from s).
    def general(offset):
        vec, jvec = make_vec_env(tenv, B), j_make_vec_env(jenv, B)
        st, _, _ = vec.reset(seed=0)
        st = st.replace(ctrl_step=torch.tensor(steps + offset - 1, dtype=torch.int32))
        tobs = vec.step_no_reset(st, torch.zeros(B, 4))[1].numpy()
        jst, _, _ = jax.jit(jvec.reset)(jax.random.key(0))
        jst = jst.replace(ctrl_step=jnp.asarray(steps + offset - 1, jnp.int32))
        return tobs, np.asarray(jax.jit(jvec.step_no_reset)(jst, jnp.zeros((B, 4)))[1])

    tobs, jgen = general(0)
    got = d["obs"][0, :, 12:].numpy()
    np.testing.assert_allclose(got, tobs[:, 12:], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jgen[:, 12:], rtol=1e-5, atol=1e-6)
    late = steps >= 117  # the env's rows reach index 120, past the kernel's 119
    assert np.abs(jobs[late, 12:] - got[late]).max() > 1e-3
    np.testing.assert_allclose(jobs[~late, 12:], got[~late], rtol=1e-5, atol=1e-6)
    trunc = d["trunc"][0].numpy() > 0
    np.testing.assert_array_equal(trunc, steps == 119)
    tobs1, jgen1 = general(1)
    np.testing.assert_allclose(d["term_obs"][0, trunc, 12:].numpy(), tobs1[trunc, 12:],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d["term_obs"][0, trunc, 12:].numpy(), jgen1[trunc, 12:],
                               rtol=1e-5, atol=1e-6)


# -- PPO on config 4-GH -------------------------------------------------------

PPO_KW = dict(rollout_batch_size=64, rollout_steps=8, opt_epochs=2, mini_batch_size=256,
              reshuffle_each_epoch=False)
# A small config 4-GH: BASELINE config 4 (safe_control_gym_torch/baseline.py)
# with the normalized action space and two goal-horizon blocks (obs 36).
CFG4_GH = dict(
    quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=6, task="traj_tracking",
    task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
               "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
               "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
    cost="rl_reward", randomized_inertial_prop=True, randomized_init=True,
    constraints=({"constraint_form": "default_constraint", "constrained_variable": "state"},
                 {"constraint_form": "default_constraint", "constrained_variable": "input"}),
    disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.005,
                                "duration": 10, "decay_rate": 0.8},)},
    done_on_out_of_bound=True, normalized_rl_action_space=True, obs_goal_horizon=2)


def test_cfg4_gh_is_config4_with_goal_rows():
    want = dataclasses.asdict(cfg4(normalized_rl_action_space=True, obs_goal_horizon=2))
    assert {k: want[k] for k in CFG4_GH} == CFG4_GH


def _closure(jppo):
    step = jppo._make_train_step()
    return dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))


def test_k4_scope_takes_obs_36():
    """K4 takes config 4-GH's update at the rl_train shapes (obs 36, 4
    actions, hidden 64, minibatches of 131072), so the train step on the
    card runs K3's observation instance and K4."""
    assert kernel_scope(36, 4, 64, "tanh", 131072, False)
    assert not kernel_scope(129, 4, 64, "tanh", 131072, False)


@pytest.mark.parametrize("fast_update", [True, False], ids=["k4-plain", "autograd"])
def test_ppo_train_step_matches_jax_on_config4_gh(fast_update):
    """One train step of the port's PPO(use_fast_rollout=True) on a small
    config 4-GH without noise, weights copied from the JAX PPO: the port
    collects with its plain K3; the JAX package's GAE and update then run
    on the port's own collection, the port's update on the JAX update's
    permutation, and both packages' parameters agree after the step at rtol
    2e-4 / atol 3e-6."""
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(**CFG4_GH))
    tenv = tq.make_quadrotor(tq.QuadrotorConfig(**CFG4_GH), device="cpu")
    jppo = JPPO(jenv, seed=0, **PPO_KW)
    ppo = TPPO(tenv, seed=0, use_fast_rollout=True, use_fast_update=fast_update, **PPO_KW)
    assert ppo.obs_dim == ppo._fp.obs_dim == 36 and (ppo._fu is not None) == fast_update
    jac = jax.device_get(jppo.state.ac)
    convert.load_actor_critic(ppo.state.ac, jac.actor_params, jac.critic_params, jac.logstd)
    ac0 = {k: v.detach().clone() for k, v in ppo.state.ac.named_parameters()}

    n = PPO_KW["rollout_batch_size"] * PPO_KW["rollout_steps"]
    keys = jax.random.split(jppo.state.key, PPO_KW["opt_epochs"] + 2)
    perm = torch.tensor(np.asarray(jax.random.permutation(keys[-1], n // 256)))
    seen = {}
    collect, update = ppo.collect_fast, ppo.update
    ppo.collect_fast = lambda s: seen.setdefault("roll", collect(s))
    ppo.update = lambda s, b: update(s, seen.setdefault("batch", b), perm=perm)
    state, m = ppo._train_step(ppo.state)
    roll, batch = seen["roll"], seen["batch"]
    assert roll["obs"].shape == (8, 64, 36)

    fns = _closure(jppo)
    jroll = {k: jnp.asarray(v.numpy()) for k, v in roll.items()}
    last = jppo._value(jppo.state.ac, jnp.asarray(state.obs.numpy()))
    rets, advs = fns["gae"](jroll, last)
    advs = (advs - advs.mean()) / (advs.std() + 1e-6)
    np.testing.assert_allclose(batch["ret"].numpy(), np.asarray(rets), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(batch["adv"].numpy(), np.asarray(advs), rtol=1e-5, atol=1e-5)
    jbatch = {k: jroll[k] for k in ("obs", "act", "v", "logp")}
    jstate, jm = fns["update"](jppo.state, {**jbatch, "ret": rets, "adv": advs})
    want = ActorCritic(36, 4, 64, "tanh")
    convert.load_actor_critic(want, *jax.device_get((jstate.ac.actor_params,
                                                     jstate.ac.critic_params, jstate.ac.logstd)))
    want = dict(want.named_parameters())
    for k, prm in state.ac.named_parameters():
        torch.testing.assert_close(prm.detach(), want[k].detach(), rtol=2e-4, atol=3e-6, msg=k)
    moved = (state.ac.actor.layers[1].weight.detach() - ac0["actor.layers.1.weight"]).abs().max()
    assert float(moved) > 1e-4  # the step moved the params
    for k in ("policy_loss", "value_loss", "approx_kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)


def test_ppo_train_step_with_obs_noise():
    """With the observation noise on, PPO(use_fast_rollout=True) trains on
    config 4-GH through the plain K3 and K4's plain version: finite losses,
    and the initial and bootstrap obs carry the noise (the controller's
    generator) on the state rows, not on the goal rows."""
    cfg = dict(CFG4_GH, disturbances={**CFG4_GH["disturbances"], **OBS_NOISE})
    env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
    ppo = TPPO(env, seed=0, use_fast_rollout=True, use_fast_update=True, **PPO_KW)
    assert ppo._fu is not None and ppo._fp.params["obs_noise_std"] == 0.05
    state = ppo.state
    assert state.obs.shape == (64, 36)
    for _ in range(2):
        noise = state.obs[:, :12] - ppo._fp.states(state.env_state)
        assert 0.025 < float(noise.std()) < 0.1
        torch.testing.assert_close(state.obs[:, 12:], ppo._fp.observe(state.env_state)[:, 12:],
                                   rtol=0, atol=0)
        state, m = ppo._train_step(state)
        for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl"):
            assert torch.isfinite(m[k]), k


# -- the observation instances' launch plans and their CUDA sources ----------

def test_obs_instance_plans():
    """The observation instances' launch plans: K3 at its group with the
    observation row in front of the hidden layers of each group; K6 and K8
    at 8 lanes an env at every B (the one group they are built for), one
    lane refused; the observation capped at 128 rows."""
    from safe_control_gym_torch.parallel import fast_cartpole as FC

    for h in (1, 64, 100, 128):
        for d in (4, 12, 36, 128):
            g, block, _, smem = tp.launch_plan(4096, h, obs_dim=d)
            assert smem == block // g * tp.group_row(h, d) * 4 <= 232448
            assert tp.group_row(h, d) == tp.group_row(h) + 32 * -(-d // 32)
            for B in (1000, 4096, 65536):
                g8, b8, grid, smem8 = FC.policy_launch_plan(B, h, obs_dim=d)
                assert (g8, b8, grid, smem8) == (8, 256, -(-B // 32), 32 * tp.group_row(h, d) * 4)
    assert FC.policy_launch_plan(65536, 64)[0] == 1  # the state instance's plan is unchanged
    for bad in (dict(obs_dim=129), dict(obs_dim=12, group=1)):
        with pytest.raises(ValueError):
            FC.policy_launch_plan(4096, 64, **bad)
    with pytest.raises(ValueError):
        tp.launch_plan(4096, 64, obs_dim=129)


def test_obs_instances_mirror_cuda_source():
    """The host mirrors of csrc/obs_ext.cuh: the ObsExt fields, the
    observation row, the observation cap, the terminal observation's first
    Philox block; and the three observation entry points with their
    signatures."""
    import ctypes
    import re
    from pathlib import Path

    from safe_control_gym_torch import kernels
    from safe_control_gym_torch.ops import philox
    from safe_control_gym_torch.parallel import fast_env as tf
    from safe_control_gym_torch.parallel import fast_update as tfu

    csrc = Path(tp.__file__).parents[1] / "csrc"
    src = (csrc / "obs_ext.cuh").read_text()
    body = re.search(r"struct ObsExt \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(int|float) (\w+);", body)
    assert fields == [("int" if c is ctypes.c_int else "float", n)
                      for n, c in tp.ObsExtParams._fields_]
    assert int(re.search(r"MLP_MAX_OBS = (\d+);", src).group(1)) == tf.MAX_OBS == tfu.MAX_OBS
    row = re.search(r"obs_row\(int d\) \{ return ([^;]+);", src).group(1)
    for d in range(1, 129):
        assert eval(row.replace("/", "//"), {"d": d}) + tp.group_row(64) == tp.group_row(64, d)
    blk = re.search(r"OBS_TERM_BLOCK = (\d+);", (csrc / "philox.cuh").read_text()).group(1)
    assert int(blk) == philox.OBS_TERM_BLOCK
    sig = kernels._SIGNATURES
    for name in ("quad3d_policy_rollout", "cartpole_policy_rollout", "quad_planar_policy_rollout"):
        # params, the ObsExt, then the state instance's arguments after its params
        assert sig[f"{name}_obs"] == sig[name][:1] * 2 + sig[name][1:]
        assert f'extern "C" int {name}_obs(' in (csrc / f"{name}.cu").read_text()
    assert 'extern "C" int obs_ext_params_size()' in (csrc / "quad3d_policy_rollout.cu").read_text()


@pytest.mark.parametrize("family", ["k3", "k8-2d-track", "k6"])
def test_obs_instances_match_plain_on_card(family):
    """The observation instances against their plain versions on the card,
    25 steps through resets and truncations, at the ragged B = 1000 and
    H = 64: rows and record at rtol 2e-4 / atol 2e-5, done and truncation
    exact (chip_smoke.py::phase_obs_ext runs the same at more shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from safe_control_gym_torch.envs import cartpole as tc
    from safe_control_gym_torch.parallel import fast_cartpole as FC
    from safe_control_gym_torch.parallel import fast_quad_planar as PQ

    dev = torch.device("cuda")
    if family == "k3":
        env = tq.make_quadrotor(tq.QuadrotorConfig(**dict(
            CFG4_GH, episode_len_sec=0.2, disturbances={**CFG4_GH["disturbances"], **OBS_NOISE})),
            device=dev)
        fp, kernel, plain, nu = tp.FastPolicyRollout(env, 1000, 25, device=dev), \
            tp.policy_rollout, tp.policy_rollout_plain, 4
    elif family == "k6":
        env = tc.make_cartpole(tc.CartPoleConfig(
            ctrl_freq=50, pyb_freq=50, episode_len_sec=0.2, task="stabilization",
            cost="rl_reward", randomized_init=True, normalized_rl_action_space=True,
            disturbances=OBS_NOISE), device=dev)
        fp, kernel, plain, nu = FC.FastCartPolePolicyRollout(env, 1000, 25, device=dev), \
            FC.cartpole_policy_rollout, FC.cartpole_policy_rollout_plain, 1
    else:
        env = tq.make_quadrotor(tq.QuadrotorConfig(
            quad_type=2, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.2, task="traj_tracking",
            task_info={"trajectory_type": "circle", "trajectory_plane": "xz"}, cost="rl_reward",
            randomized_init=True, normalized_rl_action_space=True, obs_goal_horizon=2,
            disturbances=OBS_NOISE), device=dev)
        fp, kernel, plain, nu = PQ.FastPlanarQuadPolicyRollout(env, 1000, 25, device=dev), \
            PQ.planar_policy_rollout, PQ.planar_policy_rollout_plain, 2
    ac = ActorCritic(fp.obs_dim, nu, 64, "tanh", generator=torch.Generator().manual_seed(0)).to(dev)
    rows0 = fp.reset(seed=0)
    w = fp.pack_weights(ac.actor, ac.critic, ac.logstd)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    before = kernel.obs_launches
    rows, traj = kernel(fp.params, rows0, w, seed)
    rows_p, traj_p = plain(fp.params, rows0, w, seed)
    torch.cuda.synchronize()
    assert kernel.obs_launches == before + 1
    D = fp.obs_dim
    assert torch.equal(traj[:, D + nu + 1:D + nu + 3], traj_p[:, D + nu + 1:D + nu + 3])
    assert traj[:, D + nu + 2].sum() > 0
    torch.testing.assert_close(rows, rows_p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(traj, traj_p, rtol=2e-4, atol=2e-5)
