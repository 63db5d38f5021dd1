"""The port's batched CartPole env (``envs/cartpole.py``) against ``jax.vmap``
of the JAX package's, on BASELINE configs 1 and 2 without step noise and on
variants that reach the other branches (quadratic cost and goal capture,
impulse on the cart, randomized inertia, normalized action, square
tracking with goal-horizon observations, the time limit), and through
auto-resets on both packages' vector envs.  States at rtol 2e-4 / atol
2e-5 (the JAX suite's), reset draws and done flags exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.parallel import rollout as tro
from safe_control_gym_torch.parallel.vector import make_vec_env as t_make_vec_env
from safe_control_gym_torch.utils.convert import cartpole_state_from_numpy
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.parallel import make_vec_env as j_make_vec_env
from safe_control_gym_tpu.parallel.rollout import EpisodeStats as JStats
from safe_control_gym_tpu.parallel.rollout import RolloutCarry as JCarry
from safe_control_gym_tpu.parallel.rollout import rollout as j_rollout

B = 128
BOX = ({"constraint_form": "default_constraint", "constrained_variable": "state"},
       {"constraint_form": "default_constraint", "constrained_variable": "input"})
# BASELINE config 1 (CartPole stabilization) and config 2 (tracking with box
# constraints; its action white noise is held in distribution only, in
# tests/test_torch_fast_cartpole.py).
CFG1 = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=10, task="stabilization",
            cost="rl_reward", randomized_init=True)
CFG2 = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=10, task="traj_tracking",
            randomized_init=True, constraints=BOX, done_on_out_of_bound=True)
IMPULSE = {"dynamics": ({"disturbance_func": "impulse", "magnitude": 1.5, "duration": 6,
                         "decay_rate": 0.8},)}

_VARIANTS = {
    "config1": CFG1,
    "config2_noise_free": CFG2,
    "quadratic_goal_impulse_inertia": dict(
        CFG1, cost="quadratic", randomized_inertial_prop=True, q_weight=[1.0, 0.1, 1.0, 0.1],
        r_weight=[0.05], task_info={"stabilization_goal": [0.02],
                                    "stabilization_goal_tolerance": 0.5},
        disturbances=IMPULSE),
    "normalized_square_goal_horizon": dict(
        CFG2, normalized_rl_action_space=True, obs_goal_horizon=2,
        task_info={"trajectory_type": "square", "trajectory_plane": "xz",
                   "trajectory_scale": 0.3}),
    "time_limit_pyb100": dict(CFG2, pyb_freq=100, episode_len_sec=0.06),
}


def _envs(cfg):
    return (jc.make_cartpole(jc.CartPoleConfig(**cfg)),
            tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"))


def _actions(normalized, steps, seed=0):
    """Forces across the action box; a few envs push past it (clip and the
    input constraint), a few push hard enough to fall over."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if normalized else tc.ACTION_THRESHOLD
    a = rng.uniform(-0.3, 0.3, (steps, B, 1)) * scale
    a[:, :4] = 1.5 * scale
    a[:, 4:8] = -scale
    return a.astype(np.float32)


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_reset_and_steps_match_jax(variant):
    cfg = _VARIANTS[variant]
    jenv, tenv = _envs(cfg)
    js, jo, jinfo = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    ts, to, tinfo = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=2e-7)
    for k in ("pole_length", "pole_mass", "cart_mass"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=1e-6)
    if "disturbances" in cfg:
        np.testing.assert_array_equal(ts.dist_offsets["dynamics"].numpy(),
                                      np.asarray(js.dist_sched["dynamics"]["offsets"]))
    if cfg.get("constraints"):
        np.testing.assert_allclose(tinfo["constraint_values_state"].numpy(),
                                   np.asarray(jinfo["constraint_values_state"]), atol=2e-7)

    jstep = jax.jit(jax.vmap(jenv.step))
    dones = 0
    for a in _actions(cfg.get("normalized_rl_action_space", False), 35):
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a))
        ts, to, tr, td, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in ("TimeLimit.truncated", "goal_reached", "out_of_bound"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
        np.testing.assert_allclose(ti["mse"].numpy(), np.asarray(ji["mse"]), rtol=2e-4, atol=2e-5)
        if cfg.get("constraints"):
            np.testing.assert_array_equal(ti["constraint_violation"].numpy(),
                                          np.asarray(ji["constraint_violation"]))
        dones += int(td.sum())
    assert dones > 0  # out of bound, goal capture or time limit in every variant


def test_rollout_through_resets_matches_jax():
    """Both packages' vector envs and rollouts for 25 steps of 6-step
    episodes with impulse and randomized inertia: done flags exactly, states
    and rewards at the suite's tolerance through three auto-resets."""
    cfg = dict(CFG2, episode_len_sec=0.12, randomized_inertial_prop=True,
               done_on_out_of_bound=False, disturbances=IMPULSE)
    jenv, tenv = _envs(cfg)
    jvec = j_make_vec_env(jenv, B)
    js, jo, _ = jax.jit(jvec.reset)(jax.random.key(1))
    jact = jnp.full((B, 1), 0.5, jnp.float32)
    jcarry, jtraj = jax.jit(lambda c: j_rollout(jvec, lambda ps, o: (jact, ps), c, 25))(
        JCarry(js, jo, (), JStats.create(B)))

    tvec = t_make_vec_env(tenv, B)
    ts, to, _ = tvec.reset(env_seeds=torch.tensor(np.asarray(js.env_seed)))
    tact = torch.full((B, 1), 0.5)
    tcarry, ttraj = tro.rollout(tvec, lambda ps, o: (tact, ps),
                                tro.RolloutCarry(ts, to, (), tro.EpisodeStats.create(B)), 25)
    np.testing.assert_array_equal(ttraj["done"].numpy(), np.asarray(jtraj["done"]))
    assert np.asarray(jtraj["done"]).sum() == 4 * B
    for k in ("obs", "reward", "terminal_observation"):
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    es = jcarry.env_state
    np.testing.assert_array_equal(tcarry.env_state.episode_idx.numpy(), np.asarray(es.episode_idx))
    np.testing.assert_allclose(tcarry.env_state.pole_length.numpy(), np.asarray(es.pole_length),
                               rtol=1e-6)
    np.testing.assert_array_equal(tcarry.env_state.dist_offsets["dynamics"].numpy(),
                                  np.asarray(es.dist_sched["dynamics"]["offsets"]))
    np.testing.assert_allclose(tcarry.stats.sum_return.numpy(), np.asarray(jcarry.stats.sum_return),
                               rtol=2e-4, atol=1e-5)


def test_convert_carries_jax_state():
    jenv, tenv = _envs(dict(CFG1, disturbances=IMPULSE))
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(5), B))
    fields = jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                        if k != "key"})
    conv = cartpole_state_from_numpy(fields, "cpu")
    own, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    for name in ("ctrl_step", "env_seed", "episode_idx"):
        assert torch.equal(getattr(conv, name), getattr(own, name)), name
    assert torch.equal(conv.dist_offsets["dynamics"], own.dist_offsets["dynamics"])
    torch.testing.assert_close(conv.x, own.x, rtol=1e-6, atol=2e-7)
    torch.testing.assert_close(conv.pole_mass, own.pole_mass, rtol=1e-6, atol=0)
    a = torch.full((B, 1), 0.3)
    s1, _, r1, d1, _ = tenv.step(conv, a)
    s2, _, r2, d2, _ = tenv.step(own, a)
    torch.testing.assert_close(s1.x, s2.x, rtol=2e-4, atol=2e-5)
    assert torch.equal(d1, d2)


def test_non_finite_state_freezes_and_ends_the_episode():
    """A blown-up step (a pole mass of zero divides by zero) keeps the last
    finite state, zeroes the reward and ends the episode, as the JAX env."""
    jenv, tenv = _envs(CFG1)
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(2), 8))
    bad = np.ones(8, np.float32)
    bad[:3] = 0.0
    js = js.replace(pole_length=jnp.asarray(bad * np.asarray(js.pole_length)))
    ts, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    ts = ts.replace(pole_length=torch.tensor(np.asarray(js.pole_length)))
    a = np.full((8, 1), 0.5, np.float32)
    js2, _, jr, jd, _ = jax.vmap(jenv.step)(js, jnp.asarray(a))
    ts2, _, tr, td, _ = tenv.step(ts, torch.from_numpy(a))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[:3].all() and not td[3:].any() and (tr[:3] == 0).all()
    np.testing.assert_array_equal(ts2.x[:3].numpy(), ts.x[:3].numpy())
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(adversary_disturbance="dynamics"),
    dict(disturbances={"dynamics": ({"disturbance_func": "white_noise", "std": 0.1},)}),
    dict(disturbances={"action": ({"disturbance_func": "periodic"},)}),
    dict(constraints=({"constraint_form": "linear_constraint", "constrained_variable": "state",
                       "A": [[1.0, 0.0, 1.0, 0.0]], "b": [1.0]},)),
])
def test_unported_configs_raise(kw):
    """The configs the port refused until it ported their modules (the
    adversary channel, white noise on the dynamics channel, a periodic
    action disturbance, a linear state constraint) now build in both
    packages and step from the same state under the same action (and the
    same adversary force): the states at the suite's tolerances, done
    flags exact, constraint values at the tolerances.  The white noise and
    the periodic phase are the packages' own draws (held in distribution in
    tests/test_torch_env_surface.py): there the states agree to within the
    noise's reach over one step (5 x 1 N over the lightest total mass)."""
    jenv, tenv = _envs({**CFG1, **kw})
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(1), B))
    fields = jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                        if k != "key"})
    ts = cartpole_state_from_numpy(fields, "cpu")
    rng = np.random.default_rng(2)
    a = rng.uniform(-2, 2, (B, 1)).astype(np.float32)
    if kw.get("adversary_disturbance"):
        adv = rng.uniform(-1.5, 1.5, (B, 1)).astype(np.float32)
        js = jax.vmap(jenv.extras["set_adversary_control"])(js, jnp.asarray(adv))
        ts = tenv.extras["set_adversary_control"](ts, torch.from_numpy(adv))
        np.testing.assert_allclose(ts.adv_force.numpy(), np.asarray(js.adv_force), rtol=1e-6)
    js1, _, jr, jd, ji = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(a))
    ts1, _, tr, td, ti = tenv.step(ts, torch.from_numpy(a))
    if kw.get("disturbances"):
        reach = 5 * 1.0 / 1.0 / CFG1["ctrl_freq"]
        assert np.abs(ts1.x.numpy() - np.asarray(js1.x)).max() < 2 * reach
        assert np.abs(ts1.x.numpy() - np.asarray(js1.x)).max() > 1e-6
        return
    np.testing.assert_allclose(ts1.x.numpy(), np.asarray(js1.x), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if "constraint_values" in ji:
        np.testing.assert_allclose(ti["constraint_values"].numpy(),
                                   np.asarray(ji["constraint_values"]), rtol=2e-4, atol=2e-5)
    assert not ts1.adv_force.any() and not np.asarray(js1.adv_force).any()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.make_cartpole(tc.CartPoleConfig(**CFG1))
