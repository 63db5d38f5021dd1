"""The port's PPO (``controllers/ppo.py``) against the JAX package's on the
same weights and batches: GAE, the minibatch update through both of the
port's gradient paths (``torch.autograd`` and K4's plain version) on the 3D
quadrotor, CartPole and the 2D quadrotor, whole train steps on every
engine (K3, K6 and K8 in their plain versions), and the evaluation loop.

The JAX functions are reached without editing the JAX package, through the
closure cells of ``PPO._make_train_step()``.  Tolerances: params rtol 3e-4
/ atol 3e-6 and metrics rtol 2e-3 after three epochs of Adam, the JAX
suite's own for its two update paths (``tests/test_fast_update.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.ppo import PPO as TPPO
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import fast_cartpole, fast_policy, fast_quad_planar
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jctr

B, T, EPOCHS, MB = 64, 16, 3, 256
CFG = dict(
    quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.25,
    task="traj_tracking",
    task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
               "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
               "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
    cost="rl_reward", randomized_inertial_prop=True, randomized_init=True,
    constraints=({"constraint_form": "default_constraint", "constrained_variable": "state"},
                 {"constraint_form": "default_constraint", "constrained_variable": "input"}),
    disturbances={"dynamics": ({"disturbance_func": "impulse", "magnitude": 0.005,
                                "duration": 10, "decay_rate": 0.8},)},
    done_on_out_of_bound=True, normalized_rl_action_space=True,
)
PPO_KW = dict(rollout_batch_size=B, rollout_steps=T, opt_epochs=EPOCHS, mini_batch_size=MB,
              reshuffle_each_epoch=False)
# The reference's canonical RL tasks (benchmarks/rl_convergence.py:34-54):
# CartPole stabilization and quad-2D stabilization, normalized action space;
# short episodes so that a train step crosses resets.
CP_CFG = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=0.3, task="stabilization",
              cost="rl_reward", randomized_init=True, normalized_rl_action_space=True)
Q2_CFG = dict(quad_type=2, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.25, task="stabilization",
              cost="rl_reward", randomized_init=True, normalized_rl_action_space=True)
FAMILIES = {
    "cartpole": (lambda: jc.make_cartpole(jc.CartPoleConfig(**CP_CFG)),
                 lambda: tc.make_cartpole(tc.CartPoleConfig(**CP_CFG), device="cpu"), 4),
    "quad2d": (lambda: jq.make_quadrotor(jq.QuadrotorConfig(**Q2_CFG)),
               lambda: tq.make_quadrotor(tq.QuadrotorConfig(**Q2_CFG), device="cpu"), 6),
}


def _closure(jppo, **cfg):
    """The JAX train step's inner functions for ``cfg`` changes."""
    jppo.cfg = dataclasses.replace(jppo.cfg, **cfg)
    step = jppo._make_train_step()
    return dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))


@pytest.fixture(scope="module")
def jax_side():
    jppo = JPPO(jq.make_quadrotor(jq.QuadrotorConfig(**CFG)), seed=0, **PPO_KW)
    return jppo, jppo.cfg


@pytest.fixture(scope="module")
def tenv():
    return tq.make_quadrotor(tq.QuadrotorConfig(**CFG), device="cpu")


def _port_ppo(tenv, jppo, **kw):
    ppo = TPPO(tenv, seed=0, **{**PPO_KW, **kw})
    ac = jax.device_get(jppo.state.ac)
    convert.load_actor_critic(ppo.state.ac, ac.actor_params, ac.critic_params, ac.logstd)
    return ppo


def _roll(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    done = rng.random((T, B)) < 0.1
    return dict(rew=np.abs(f(T, B)), mask=(1.0 - done).astype(np.float32), v=f(T, B),
                terminal_v=np.where(rng.random((T, B)) < 0.05, f(T, B), 0.0).astype(np.float32))


@pytest.mark.parametrize("use_gae", [False, True])
def test_gae_matches_jax(jax_side, tenv, use_gae):
    jppo, cfg0 = jax_side
    jgae = _closure(jppo, use_gae=use_gae)["gae"]
    jppo.cfg = cfg0
    ppo = TPPO(tenv, seed=0, **PPO_KW, use_gae=use_gae)
    roll, last = _roll(), np.random.default_rng(9).normal(size=B).astype(np.float32)
    jr, ja = jgae({k: jnp.asarray(v) for k, v in roll.items()}, jnp.asarray(last))
    tr, ta = ppo.gae({k: torch.from_numpy(v) for k, v in roll.items()}, torch.from_numpy(last))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)


def _batch(jppo, seed=1, obs_dim=12):
    """A batch near the current policy: the KL gate stays open."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ac = jppo.state.ac
    obs = 0.5 * f(T, B, obs_dim)
    dist = jppo._dist(ac, jnp.asarray(obs))
    act = np.asarray(dist.sample(jax.random.key(seed)))
    logp = np.asarray(dist.log_prob(jnp.asarray(act))) + 0.01 * f(T, B)
    v = np.asarray(jppo._value(ac, jnp.asarray(obs))) + 0.1 * f(T, B)
    adv = f(T, B)
    return dict(obs=obs, act=act, v=v, logp=logp, ret=v + adv, adv=(adv - adv.mean()) / adv.std())


@pytest.mark.parametrize("fast_update,reshuffle", [(False, False), (True, False), (False, True)],
                         ids=["autograd", "k4-plain", "autograd-reshuffle"])
def test_update_matches_jax(jax_side, tenv, fast_update, reshuffle):
    """Three epochs from the same weights, batch and JAX's permutations
    against the JAX package's XLA update."""
    jppo, cfg0 = jax_side
    jupdate = _closure(jppo, reshuffle_each_epoch=reshuffle)["update"]
    jppo.cfg = cfg0
    batch = _batch(jppo)
    jstate, jm = jupdate(jppo.state, {k: jnp.asarray(v) for k, v in batch.items()})

    keys = jax.random.split(jppo.state.key, EPOCHS + 2)
    if reshuffle:
        perm = np.stack([np.asarray(jax.random.permutation(k, B * T)) for k in keys[1:-1]])
    else:
        perm = np.asarray(jax.random.permutation(keys[-1], B * T // 256))
    ppo = _port_ppo(tenv, jppo, use_fast_update=fast_update, reshuffle_each_epoch=reshuffle)
    assert (ppo._fu is not None) == fast_update
    tm = ppo.update(ppo.state, {k: torch.tensor(v) for k, v in batch.items()},
                    perm=torch.tensor(perm))

    ja, jc, jl = jax.device_get((jstate.ac.actor_params, jstate.ac.critic_params, jstate.ac.logstd))
    ta, tc, tl = convert.actor_critic_params(ppo.state.ac)
    for got, want in ((ta, ja), (tc, jc)):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x, y, rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(tl, jl, rtol=3e-4, atol=3e-6)
    # The update moved the params (Adam's first step is lr-sized).
    a0 = jax.device_get(jppo.state.ac.actor_params)["params"]["Dense_1"]["kernel"]
    assert np.abs(ta["params"]["Dense_1"]["kernel"] - a0).max() > 1e-4
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fast_update", [False, True], ids=["autograd", "k4-plain"])
def test_update_matches_jax_at_hidden_128(tenv, fast_update):
    """The 3-epoch update at hidden width 128, which K4 now takes, from the
    same weights, batch and permutation as the JAX package's XLA update."""
    jppo = JPPO(jq.make_quadrotor(jq.QuadrotorConfig(**CFG)), seed=0, hidden_dim=128, **PPO_KW)
    jupdate = _closure(jppo, reshuffle_each_epoch=False)["update"]
    batch = _batch(jppo)
    jstate, jm = jupdate(jppo.state, {k: jnp.asarray(v) for k, v in batch.items()})
    perm = np.asarray(jax.random.permutation(jax.random.split(jppo.state.key, EPOCHS + 2)[-1],
                                             B * T // 256))
    ppo = _port_ppo(tenv, jppo, hidden_dim=128, use_fast_update=fast_update)
    assert (ppo._fu is not None) == fast_update
    tm = ppo.update(ppo.state, {k: torch.tensor(v) for k, v in batch.items()},
                    perm=torch.tensor(perm))
    ja, jcr, jl = jax.device_get((jstate.ac.actor_params, jstate.ac.critic_params,
                                  jstate.ac.logstd))
    ta, tcr, tl = convert.actor_critic_params(ppo.state.ac)
    for got, want in ((ta, ja), (tcr, jcr)):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x, y, rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(tl, jl, rtol=3e-4, atol=3e-6)
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("hidden", [128, 129])
def test_fast_rollout_hidden_width_limit(tenv, hidden):
    """The policy kernels take hidden widths up to 128, as the JAX package
    asserts (fast_policy.py:227): a train step at 128 runs (plain K3 and
    K4); 129 raises."""
    if hidden > 128:
        with pytest.raises(ValueError):
            TPPO(tenv, seed=0, use_fast_rollout=True, hidden_dim=hidden, **PPO_KW)
        return
    ppo = TPPO(tenv, seed=0, use_fast_rollout=True, use_fast_update=True, hidden_dim=hidden,
               **{**PPO_KW, "opt_epochs": 1})
    state, m = ppo._train_step(ppo.state)
    assert state.total_steps == B * T and all(np.isfinite(float(v)) for v in m.values()), m


def test_kl_gate_zeroes_actor_grads_but_adam_steps(tenv, jax_side):
    """With the gate shut (target_kl tiny, KL of this batch far above it),
    the actor's Adam still counts the step; with zero moments the actor
    does not move, and the critic does."""
    jppo, _ = jax_side
    ppo = _port_ppo(tenv, jppo, target_kl=1e-9, opt_epochs=1)
    batch = _batch(jppo)
    batch["logp"] = batch["logp"] + 1.0  # approx_kl = 1 > 1.5e-9
    before = [p.detach().clone() for p in ppo.state.ac.actor_params()]
    c_before = [p.detach().clone() for p in ppo.state.ac.critic.parameters()]
    m = ppo.update(ppo.state, {k: torch.tensor(v) for k, v in batch.items()})
    assert float(m["approx_kl"]) > 0.5
    assert ppo.state.actor_opt.count == B * T // MB
    assert all(torch.equal(a, b) for a, b in zip(before, ppo.state.ac.actor_params()))
    assert not all(torch.equal(a, b) for a, b in zip(c_before, ppo.state.ac.critic.parameters()))


@pytest.mark.parametrize("fast_rollout", [True, False], ids=["k3-plain", "general-engine"])
def test_train_step_on_each_engine(tenv, fast_rollout):
    ppo = TPPO(tenv, seed=0, use_fast_rollout=fast_rollout, use_fast_update=True, **PPO_KW)
    assert (ppo._fp is not None) == fast_rollout
    state, m = ppo._train_step(ppo.state)
    assert state.total_steps == B * T
    assert all(np.isfinite(float(v)) for v in m.values()), m
    # The env state moved on by T steps.
    rows = state.env_state if fast_rollout else None
    if rows is not None:
        assert rows.shape == (27, B) and bool(torch.isfinite(rows[:25]).all())
    assert state.obs.shape == (B, 12)


def test_learn_train_many_and_checkpoint(tenv, tmp_path):
    ppo = TPPO(tenv, seed=0, use_fast_rollout=True, **{**PPO_KW, "opt_epochs": 1})
    m = ppo.learn(max_env_steps=3 * B * T)
    assert ppo.state.total_steps == 3 * B * T and set(m) == {
        "policy_loss", "value_loss", "entropy_loss", "approx_kl"}
    state, m2 = ppo.train_many(2)(ppo.state)
    assert state.total_steps == 5 * B * T and all(np.isfinite(v) for v in map(float, m2.values()))
    logged = []
    ppo.learn(max_env_steps=B * T, log_fn=lambda s, mm: logged.append(s))
    assert logged == [6 * B * T]
    obs = np.zeros((2, 12), np.float32)
    act = ppo.select_action(obs)
    np.testing.assert_array_equal(act, ppo.state.ac.actor(torch.from_numpy(obs)).detach().numpy())
    path = tmp_path / "ppo.pt"
    ppo.save(path)
    w = ppo.state.ac.logstd.detach().clone()
    with torch.no_grad():
        ppo.state.ac.logstd.zero_()
    ppo.load(path)
    assert torch.equal(ppo.state.ac.logstd.detach(), w)
    assert ppo.state.total_steps == 6 * B * T


def test_run_matches_jax(jax_side, tenv):
    """The batched evaluation loop from the same weights and env seeds:
    per-step obs, actions, rewards and mse at the suite's state tolerance,
    done flags and episode lengths exact (the episodes end at the time
    limit, and done envs are frozen)."""
    jppo, _ = jax_side
    n = 8
    jres = jax.device_get(jppo.run(num_episodes=n, max_steps=20, seed=4))
    seeds = np.asarray(jax.vmap(jctr.env_seed_from_key)(jax.random.split(jax.random.key(4), n)))
    tres = _port_ppo(tenv, jppo).run(num_episodes=n, max_steps=20, env_seeds=torch.tensor(seeds))
    for k in ("obs", "action", "reward", "mse", "ep_returns"):
        np.testing.assert_allclose(tres[k], np.asarray(jres[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(tres["done"], np.asarray(jres["done"]))
    np.testing.assert_array_equal(tres["ep_lengths"], np.asarray(jres["ep_lengths"]))
    assert tres["done"][-1].all() and (tres["reward"][-1] == 0).all()


def test_options_the_port_refuses(tenv):
    # The two update rewrites exclude each other (ppo.py:263 of the JAX
    # package asserts it).
    with pytest.raises(ValueError):
        TPPO(tenv, use_fast_update=True, fused_update=True, **PPO_KW)
    with pytest.raises(ValueError):
        TPPO(tenv, use_fast_rollout=True, norm_obs=True, **PPO_KW)
    with pytest.raises(ValueError):
        TPPO(tenv, use_fast_update=True, use_clipped_value=True, **PPO_KW)
    with pytest.raises(ValueError):  # K4 stops at hidden width 256
        TPPO(tenv, use_fast_update=True, hidden_dim=257, **PPO_KW)
    # "auto" means K4 only on a CUDA device.
    assert TPPO(tenv, **PPO_KW)._fu is None


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jmake, tmake, obs_dim = FAMILIES[request.param]
    jppo = JPPO(jmake(), seed=0, **PPO_KW)
    return request.param, jppo, jppo.cfg, tmake(), obs_dim


@pytest.mark.parametrize("fast_update", [False, True], ids=["autograd", "k4-plain"])
def test_update_matches_jax_on_family(family, fast_update):
    """The 3-epoch update on CartPole (nx 4, nu 1) and the 2D quadrotor
    (nx 6, nu 2) from the same weights, batch and permutation as the JAX
    package's XLA update, through both gradient paths."""
    name, jppo, cfg0, tenv, obs_dim = family
    jupdate = _closure(jppo, reshuffle_each_epoch=False)["update"]
    jppo.cfg = cfg0
    batch = _batch(jppo, obs_dim=obs_dim)
    jstate, jm = jupdate(jppo.state, {k: jnp.asarray(v) for k, v in batch.items()})
    perm = np.asarray(jax.random.permutation(jax.random.split(jppo.state.key, EPOCHS + 2)[-1],
                                             B * T // 256))
    ppo = _port_ppo(tenv, jppo, use_fast_update=fast_update)
    assert (ppo._fu is not None) == fast_update and ppo.obs_dim == obs_dim
    tm = ppo.update(ppo.state, {k: torch.tensor(v) for k, v in batch.items()},
                    perm=torch.tensor(perm))
    ja, jcr, jl = jax.device_get((jstate.ac.actor_params, jstate.ac.critic_params,
                                  jstate.ac.logstd))
    ta, tcr, tl = convert.actor_critic_params(ppo.state.ac)
    for got, want in ((ta, ja), (tcr, jcr)):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x, y, rtol=3e-4, atol=3e-6, err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=3e-4, atol=3e-6)
    a0 = jax.device_get(jppo.state.ac.actor_params)["params"]["Dense_1"]["kernel"]
    assert np.abs(ta["params"]["Dense_1"]["kernel"] - a0).max() > 1e-4
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("make,engine,obs_dim", [
    (lambda: tc.make_cartpole(tc.CartPoleConfig(**CP_CFG), device="cpu"),
     fast_cartpole.FastCartPolePolicyRollout, 4),
    (lambda: tq.make_quadrotor(tq.QuadrotorConfig(**Q2_CFG), device="cpu"),
     fast_quad_planar.FastPlanarQuadPolicyRollout, 6),
    (lambda: tq.make_quadrotor(tq.QuadrotorConfig(**{**Q2_CFG, "quad_type": 1}), device="cpu"),
     fast_quad_planar.FastPlanarQuadPolicyRollout, 2),
    (lambda: tq.make_quadrotor(tq.QuadrotorConfig(**CFG), device="cpu"),
     fast_policy.FastPolicyRollout, 12),
], ids=["cartpole-k6", "quad2d-k8", "quad1d-k8", "quad3d-k3"])
def test_fast_rollout_engine_by_family(make, engine, obs_dim):
    """use_fast_rollout picks the policy engine of the env's family; a train
    step through it (plain version) and K4's plain version runs with finite
    metrics across episode resets."""
    ppo = TPPO(make(), seed=0, use_fast_rollout=True, use_fast_update=True, **PPO_KW)
    assert type(ppo._fp) is engine and ppo._fu.F == obs_dim + ppo.act_dim + 4
    state, m = ppo._train_step(ppo.state)
    assert state.total_steps == B * T
    assert all(np.isfinite(float(v)) for v in m.values()), m
    assert state.obs.shape == (B, obs_dim) and state.env_state.shape == (ppo._fp.n_rows, B)
    assert bool(torch.isfinite(state.env_state).all()) or obs_dim == 12


def test_run_matches_jax_on_cartpole():
    """The batched evaluation loop on CartPole from the same weights and env
    seeds: per-step obs, actions, rewards and mse at the suite's state
    tolerance, done flags and episode lengths exact (15-step episodes)."""
    jppo = JPPO(jc.make_cartpole(jc.CartPoleConfig(**CP_CFG)), seed=0, **PPO_KW)
    n = 8
    jres = jax.device_get(jppo.run(num_episodes=n, max_steps=20, seed=4))
    seeds = np.asarray(jax.vmap(jctr.env_seed_from_key)(jax.random.split(jax.random.key(4), n)))
    tenv = tc.make_cartpole(tc.CartPoleConfig(**CP_CFG), device="cpu")
    tres = _port_ppo(tenv, jppo).run(num_episodes=n, max_steps=20, env_seeds=torch.tensor(seeds))
    for k in ("obs", "action", "reward", "mse", "ep_returns"):
        np.testing.assert_allclose(tres[k], np.asarray(jres[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(tres["done"], np.asarray(jres["done"]))
    np.testing.assert_array_equal(tres["ep_lengths"], np.asarray(jres["ep_lengths"]))
    assert tres["done"][-1].all() and (tres["reward"][-1] == 0).all()
