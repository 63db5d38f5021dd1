"""PPO's leftovers in the port against the JAX package: the fused 2H-wide
update (``fused_update``), the evaluation loop's post-analysis
(``run(analysis=True)``) and ``utils/plotting.py``.

Tolerances: the fused update against the JAX package's fused update after
three epochs of Adam, params rtol 3e-4 / atol 3e-6 and metrics rtol 2e-3
(``tests/test_torch_ppo.py``'s, the JAX suite's for its two update paths);
the port's fused update against its separate-network update, rtol 2e-4 /
atol 1e-6 (``tests/test_rl.py:193``, the gradient tolerance); the fused
weights exactly; the post-analysis at the state tolerance, rtol 2e-4 /
atol 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.lqr import LQR as TLQR
from safe_control_gym_torch.controllers.ppo import PPO as TPPO
from safe_control_gym_torch.controllers.ppo import fused_net
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.utils import convert
from safe_control_gym_torch.utils import plotting as tp
from safe_control_gym_tpu.controllers.lqr import LQR as JLQR
from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jctr
from safe_control_gym_tpu.utils import plotting as jp

RTOL, ATOL = 2e-4, 2e-5
B, T, EPOCHS, MB = 64, 16, 3, 256
# Config 4's figure-8 with the normalized action space, short episodes.
CFG = dict(
    quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.25, task="traj_tracking",
    task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
               "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
               "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
    cost="rl_reward", randomized_inertial_prop=True, randomized_init=True,
    normalized_rl_action_space=True,
)
PPO_KW = dict(rollout_batch_size=B, rollout_steps=T, opt_epochs=EPOCHS, mini_batch_size=MB,
              reshuffle_each_epoch=False)


@pytest.fixture(scope="module")
def jax_side():
    return JPPO(jq.make_quadrotor(jq.QuadrotorConfig(**CFG)), seed=0, **PPO_KW)


@pytest.fixture(scope="module")
def tenv():
    return tq.make_quadrotor(tq.QuadrotorConfig(**CFG), device="cpu")


def _port_ppo(tenv, jppo, **kw):
    ppo = TPPO(tenv, seed=0, **{**PPO_KW, **kw})
    ac = jax.device_get(jppo.state.ac)
    convert.load_actor_critic(ppo.state.ac, ac.actor_params, ac.critic_params, ac.logstd)
    return ppo


def _batch(jppo, seed=1):
    """A batch near the current policy, so that the KL gate stays open."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ac = jppo.state.ac
    obs = 0.5 * f(T, B, 12)
    dist = jppo._dist(ac, jnp.asarray(obs))
    act = np.asarray(dist.sample(jax.random.key(seed)))
    logp = np.asarray(dist.log_prob(jnp.asarray(act))) + 0.01 * f(T, B)
    v = np.asarray(jppo._value(ac, jnp.asarray(obs))) + 0.1 * f(T, B)
    adv = f(T, B)
    return dict(obs=obs, act=act, v=v, logp=logp, ret=v + adv, adv=(adv - adv.mean()) / adv.std())


def _jax_update(jppo, **cfg):
    """The JAX train step's ``update`` with ``cfg`` changed (its closure)."""
    cfg0 = jppo.cfg
    jppo.cfg = dataclasses.replace(cfg0, **cfg)
    try:
        step = jppo._make_train_step()
    finally:
        jppo.cfg = cfg0
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    return cells["update"]


def _params(ppo):
    a, c, logstd = convert.actor_critic_params(ppo.state.ac)
    return jax.tree.leaves(a) + jax.tree.leaves(c) + [logstd]


def test_fused_weights_match_the_converter(jax_side, tenv):
    """The port's fused network, built from the parameters, is the JAX
    package's construction from the flax params, entry for entry."""
    ppo = _port_ppo(tenv, jax_side, fused_update=True)
    ac = jax.device_get(jax_side.state.ac)
    want = convert.fused_weights(ac.actor_params, ac.critic_params)
    got = fused_net(ppo.state.ac)
    H = ppo.cfg.hidden_dim
    assert [tuple(w.shape) for w, _ in got] == [(2 * H, 12), (2 * H, 2 * H), (5, 2 * H)]
    for (w, b), (w_ref, b_ref) in zip(got, want):
        np.testing.assert_array_equal(w.detach().numpy(), w_ref)
        np.testing.assert_array_equal(b.detach().numpy(), b_ref)
    assert not got[1][0][:H, H:].any() and not got[2][0][:4, H:].any()


def test_fused_update_matches_jax(jax_side, tenv):
    """Three epochs of the fused update from the same weights, batch and
    permutation as the JAX package's fused update."""
    jppo = jax_side
    batch = _batch(jppo)
    jstate, jm = _jax_update(jppo, fused_update=True)(
        jppo.state, {k: jnp.asarray(v) for k, v in batch.items()})
    perm = np.asarray(jax.random.permutation(jax.random.split(jppo.state.key, EPOCHS + 2)[-1],
                                             B * T // 256))
    ppo = _port_ppo(tenv, jppo, fused_update=True)
    assert ppo._fu is None
    tm = ppo.update(ppo.state, {k: torch.tensor(v) for k, v in batch.items()},
                    perm=torch.tensor(perm))
    ja, jcr, jl = jax.device_get((jstate.ac.actor_params, jstate.ac.critic_params,
                                  jstate.ac.logstd))
    want = jax.tree.leaves(ja) + jax.tree.leaves(jcr) + [jl]
    for got, ref in zip(_params(ppo), want):
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-6)
    a0 = jax.device_get(jppo.state.ac.actor_params)["params"]["Dense_1"]["kernel"]
    assert np.abs(_params(ppo)[3] - a0).max() > 1e-4  # Dense_1's kernel moved
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)


def test_fused_update_matches_separate(tenv):
    """Three whole train steps (collection, GAE, update) with the fused and
    with the separate-network update from one seed (tests/test_rl.py:193)."""
    outs = {}
    for fused in (False, True):
        ppo = TPPO(tenv, seed=0, fused_update=fused, **PPO_KW)
        state = ppo.state
        for _ in range(3):
            state, m = ppo._train_step(state)
        assert all(np.isfinite(float(v)) for v in m.values())
        outs[fused] = _params(ppo)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-6)


def test_fused_update_with_clipped_value_matches_separate(tenv, jax_side):
    batch = {k: torch.tensor(v) for k, v in _batch(jax_side, seed=2).items()}
    outs = {}
    for fused in (False, True):
        ppo = _port_ppo(tenv, jax_side, fused_update=fused, use_clipped_value=True)
        ppo.update(ppo.state, batch, perm=torch.arange(B * T // 256))
        outs[fused] = _params(ppo)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-6)


def test_fused_update_and_k4_exclude_each_other(tenv):
    with pytest.raises(ValueError):
        TPPO(tenv, fused_update=True, use_fast_update=True, **PPO_KW)
    # "auto" leaves K4 off under fused_update (ppo.py:245 of the JAX package).
    assert TPPO(tenv, fused_update=True, use_fast_update="auto", **PPO_KW)._fu is None


def _env_seeds(seed, n):
    return torch.tensor(np.asarray(jax.vmap(jctr.env_seed_from_key)(
        jax.random.split(jax.random.key(seed), n))))


def _check_analysis(tres, jres):
    ta, ja = tres["analysis"], jres["analysis"]
    assert set(ta) == set(ja) == {"state_rmse", "state_rmse_scalar"}
    np.testing.assert_allclose(ta["state_rmse"], np.asarray(ja["state_rmse"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ta["state_rmse_scalar"], ja["state_rmse_scalar"], rtol=RTOL,
                               atol=ATOL)


def test_run_analysis_matches_jax_on_tracking(jax_side, tenv):
    """PPO's evaluation with the post-analysis of env 0 against the goal
    table (angle errors wrapped), from the same weights and env seeds."""
    n = 4
    jres = jax_side.run(num_episodes=n, max_steps=20, seed=5, analysis=True)
    tres = _port_ppo(tenv, jax_side).run(num_episodes=n, max_steps=20,
                                          env_seeds=_env_seeds(5, n), analysis=True)
    assert tres["analysis"]["state_rmse"].shape == (12,)
    _check_analysis(tres, jres)


def test_run_analysis_matches_jax_on_stabilization():
    """LQR on CartPole stabilization (a goal state, not a table) through the
    shared evaluation loop, from the same env seeds."""
    cfg = dict(task="stabilization", cost="quadratic", randomized_init=True, episode_len_sec=2)
    jenv = jc.make_cartpole(jc.CartPoleConfig(**cfg))
    tenv = tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu")
    n = 4
    jres = JLQR(jenv, q_lqr=[1.0], r_lqr=[0.1]).run(num_episodes=n, seed=2, analysis=True)
    tres = TLQR(tenv, q_lqr=[1.0], r_lqr=[0.1]).run(num_episodes=n, env_seeds=_env_seeds(2, n),
                                                      analysis=True)
    assert tres["analysis"]["state_rmse"].shape == (4,)
    _check_analysis(tres, jres)


def test_post_analysis_matches_jax(tmp_path):
    """Random stacks with the 3D quadrotor's labels (phi, theta and psi
    wrapped, their rates not), and without labels; ``plot=True`` saves the
    state and input figures."""
    rng = np.random.default_rng(0)
    goal = rng.standard_normal((50, 12)).astype(np.float32)
    states = (goal + rng.uniform(-4, 4, (50, 12))).astype(np.float32)
    inputs = rng.standard_normal((48, 4)).astype(np.float32)
    env = tq.make_quadrotor(tq.QuadrotorConfig(quad_type=3), device="cpu")
    jenv = jq.make_quadrotor(jq.QuadrotorConfig(quad_type=3))
    got = tp.post_analysis(goal, states, inputs, env=env)
    want = jp.post_analysis(goal, states, inputs, env=jenv)
    np.testing.assert_allclose(got["state_rmse"], want["state_rmse"], rtol=RTOL, atol=ATOL)
    assert got["state_rmse_scalar"] == pytest.approx(want["state_rmse_scalar"], rel=RTOL)
    raw = tp.post_analysis(goal, states, inputs)
    assert raw["state_rmse"][7] > got["state_rmse"][7]  # theta unwrapped
    np.testing.assert_allclose(raw["state_rmse"][10], got["state_rmse"][10])  # q not wrapped
    tp.post_analysis(goal, states, inputs, env=env, plot=True, save_plot=True,
                     plot_dir=str(tmp_path), ite_counter=3)
    assert (tmp_path / "state_ite3.png").exists() and (tmp_path / "input_ite3.png").exists()


def test_log_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    runs = []
    for i in range(3):
        d = tmp_path / f"seed{i}" / "logs"
        d.mkdir(parents=True)
        steps = np.sort(rng.choice(1000, 40, replace=False)).astype(float)
        vals = rng.standard_normal(40)
        (d / "stat_ep_return.log").write_text(
            "".join(f"{s} {v}\n" for s, v in zip(steps, vals)) + "bad\n")
        runs.append(str(tmp_path / f"seed{i}"))
    for d in runs:
        got, want = tp.load_from_logs(d), jp.load_from_logs(d)
        assert set(got) == set(want) == {"stat_ep_return"}
        for g, w in zip(got["stat_ep_return"], want["stat_ep_return"]):
            np.testing.assert_array_equal(g, w)
    assert tp.load_from_logs(str(tmp_path / "missing")) == {}
    xs, ys = tp.load_from_logs(runs[0])["stat_ep_return"]
    for window in (5, 100):
        np.testing.assert_array_equal(tp.window_func(xs, ys, window)[1],
                                      jp.window_func(xs, ys, window)[1])
    series = [tp.load_from_logs(d)["stat_ep_return"] for d in runs]
    for g, w in zip(tp.interpolate_runs(series, 50), jp.interpolate_runs(series, 50)):
        np.testing.assert_array_equal(g, w)
    got = tp.plot_from_logs(runs, "stat/ep_return", out_path=str(tmp_path / "curve.png"))
    want = jp.plot_from_logs(runs, "stat/ep_return")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tmp_path / "curve.png").exists()
    with pytest.raises(ValueError):
        tp.plot_from_logs(runs, "no_such_metric")
