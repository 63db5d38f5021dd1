"""The port's gym-style adapter (``envs/gym_adapter.py``) and episode
statistics wrapper (``parallel/episode_stats.py``) against the JAX
package's (tests/test_gym_adapter.py is the JAX adapter's own test): the
reference's imperative single-env API, numpy in and numpy out, and the
host-side episode records of a vector env.

The two adapters derive their episodes' env seeds differently (the JAX
package from threefry keys), so they are held to each other from the same
state: the port's adapter takes the JAX adapter's state through
utils/convert, and both step with the same actions (observations at rtol
2e-4 / atol 2e-5, done flags exact).  The episode records are held from
the same env seeds, on configs without step noise (returns at rtol 1e-4,
lengths exact)."""

import jax
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import gym_adapter as tga
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel.episode_stats import RecordEpisodeStatistics
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils.convert import cartpole_state_from_numpy, quad_state_from_numpy
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import gym_adapter as jga
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel import make_vec_env as j_make_vec_env
from safe_control_gym_tpu.parallel.episode_stats import \
    RecordEpisodeStatistics as JRecordEpisodeStatistics

CART = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=0.2, task="stabilization",
            randomized_init=True)
QUAD = dict(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=1, task="stabilization",
            task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
            cost="rl_reward", normalized_rl_action_space=True)


def _fields(state):
    return jax.tree.map(lambda a: np.asarray(a)[None],
                        {k: getattr(state, k) for k in state.__dataclass_fields__ if k != "key"})


def test_box_matches_jax():
    """Box: the same samples as the JAX package's for the same seed (both
    numpy), inside the box (infinite bounds sampled in [-1, 1]), contains,
    shape and repr."""
    low, high = np.array([-1.0, -np.inf, 0.0]), np.array([2.0, np.inf, 0.5])
    t, j = tga.Box(low, high, np.random.default_rng(4)), jga.Box(low, high,
                                                                  np.random.default_rng(4))
    for _ in range(5):
        s = t.sample()
        np.testing.assert_array_equal(s, j.sample())
        assert t.contains(s) and s.dtype == np.float32
    t.seed(9)
    j.seed(9)
    np.testing.assert_array_equal(t.sample(), j.sample())
    assert not t.contains(np.array([3.0, 0.0, 0.0])) and not t.contains(np.zeros(2))
    assert repr(t) == repr(j) == "Box(3,)"


def test_reference_control_loop_runs():
    """A verbatim reference-style loop: reset -> step until done, numpy in
    and out, TimeLimit.truncated at the horizon (stabilization ends there)."""
    env = tga.make_gym_env(tc.CartPoleConfig(**CART), seed=7, device="cpu")
    obs, info = env.reset()
    assert isinstance(obs, np.ndarray) and obs.shape == (4,)
    done, steps = False, 0
    while not done:
        obs, rew, done, info = env.step(env.action_space.sample())
        assert isinstance(rew, float) and isinstance(done, bool) and obs.shape == (4,)
        steps += 1
        assert steps <= env.CTRL_STEPS
    assert steps == env.CTRL_STEPS and bool(info["TimeLimit.truncated"])
    assert env.CTRL_TIMESTEP == 1 / 50 and env.EPISODE_LEN_SEC == 0.2
    env.close()
    assert env.state is None
    with pytest.raises(RuntimeError):
        env.step(np.zeros(1))


def test_adapter_is_the_batched_env_of_one():
    """The adapter's trajectory is that of driving the batched env by hand
    with its episode's env seed (the port's seed stream)."""
    cfg = tc.CartPoleConfig(**CART, randomized_inertial_prop=True)
    env = tga.make_gym_env(cfg, seed=3, device="cpu")
    fn = tc.make_cartpole(cfg, device="cpu")
    obs_a, _ = env.reset()
    from safe_control_gym_torch.ops import ctr_prng

    state, obs_b, _ = fn.reset(ctr_prng.env_seeds_from_seed(3, 1))
    np.testing.assert_array_equal(obs_a, obs_b[0].numpy())
    act = np.asarray([0.7], np.float32)
    for _ in range(5):
        obs_a, rew_a, done_a, _ = env.step(act)
        state, obs_b, rew_b, done_b, _ = fn.step(state, torch.tensor([[0.7]]))
        np.testing.assert_array_equal(obs_a, obs_b[0].numpy())
        assert rew_a == float(rew_b[0]) and done_a == bool(done_b[0])


def test_episode_stream_and_reseed():
    """Successive resets draw new randomization; seed() replays the stream;
    reseed_on_reset replays the seed's draws every episode
    (benchmark_env.py:210-215)."""
    env = tga.make_gym_env(tc.CartPoleConfig(**CART), seed=11, device="cpu")
    o1, _ = env.reset()
    o2, _ = env.reset()
    assert not np.allclose(o1, o2)
    env.seed(11)
    np.testing.assert_array_equal(env.reset()[0], o1)
    env_r = tga.make_gym_env(tc.CartPoleConfig(**CART), seed=11, reseed_on_reset=True,
                             device="cpu")
    np.testing.assert_array_equal(env_r.reset()[0], env_r.reset()[0])


@pytest.mark.parametrize("family", ["cartpole", "quadrotor"])
def test_adapter_matches_jax_adapter_from_the_same_state(family):
    """From the JAX adapter's state (carried by utils/convert), both
    adapters step with the same actions: observations at the suite's
    tolerances, rewards at rtol 2e-4, done and truncation flags exact, over
    a whole episode."""
    if family == "cartpole":
        jenv = jga.GymEnv(jc.make_cartpole(jc.CartPoleConfig(**CART)), seed=5)
        tenv = tga.GymEnv(tc.make_cartpole(tc.CartPoleConfig(**CART), device="cpu"), seed=5)
        convert = cartpole_state_from_numpy
    else:
        jenv = jga.GymEnv(jq.make_quadrotor(jq.QuadrotorConfig(**QUAD, use_pallas=False)), seed=5)
        tenv = tga.GymEnv(tq.make_quadrotor(tq.QuadrotorConfig(**QUAD), device="cpu"), seed=5)
        convert = quad_state_from_numpy
    jobs, _ = jenv.reset()
    tenv.reset()
    tenv._state = convert(_fields(jenv.state), "cpu")
    assert tenv.observation_space.shape == jenv.observation_space.shape
    rng = np.random.default_rng(0)
    done = False
    while not done:
        a = rng.uniform(-1, 1, jenv.action_space.shape).astype(np.float32)
        jo, jr, jd, ji = jenv.step(a)
        to, tr, td, ti = tenv.step(a)
        np.testing.assert_allclose(to, jo, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tr, jr, rtol=2e-4, atol=1e-6)
        assert td == jd and bool(ti["TimeLimit.truncated"]) == bool(ji["TimeLimit.truncated"])
        done = td


def test_render_is_not_ported_yet():
    """The name is older than ``render``'s port: it pinned the raise that
    ``render`` made until ``utils/rendering`` was wired to it.  Now render
    draws a frame after reset and raises before it (the JAX adapter's
    contract); tests/test_torch_viewer.py holds the frames to the JAX
    adapter's."""
    env = tga.make_gym_env(tc.CartPoleConfig(**CART), device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        env.render()
    env.reset()
    frame = env.render()
    assert frame.shape[-1] == 3 and frame.dtype == np.uint8 and (frame < 250).any()


def test_make_gym_env_configs():
    """None builds the default CartPole with the overrides, a quadrotor
    config builds the quadrotor, anything else raises TypeError."""
    env = tga.make_gym_env(None, device="cpu", episode_len_sec=0.1)
    assert env.fn_env.config.episode_len_sec == 0.1 and env.CTRL_STEPS == 5
    q = tga.make_gym_env(tq.QuadrotorConfig(**QUAD), device="cpu", episode_len_sec=0.5)
    assert q.reset()[0].shape == (12,) and q.CTRL_STEPS == 30
    with pytest.raises(TypeError):
        tga.make_gym_env(object(), device="cpu")


def test_episode_statistics_match_jax():
    """RecordEpisodeStatistics over both packages' vector envs from the same
    env seeds, 30 steps of 10-step episodes with constraint violations
    tracked (accumulate) and the mse (queue): the queued returns, lengths
    and tracker values, the running lengths and the mean statistics
    agree (returns and mse at rtol 1e-4, counts exact)."""
    box = ({"constraint_form": "bounded_constraint", "constrained_variable": "state",
            "lower_bounds": [-0.05] * 4, "upper_bounds": [0.05] * 4},)
    cfg = dict(CART, constraints=box)
    n = 16
    jvec = JRecordEpisodeStatistics(j_make_vec_env(jc.make_cartpole(jc.CartPoleConfig(**cfg)), n),
                                    deque_size=64)
    tvec = RecordEpisodeStatistics(make_vec_env(tc.make_cartpole(tc.CartPoleConfig(**cfg),
                                                                 device="cpu"), n),
                                   deque_size=64)
    for rec in (jvec, tvec):
        rec.add_tracker("constraint_violation", 0, mode="accumulate")
        rec.add_tracker("mse", 0, mode="queue")
    js, _, _ = jvec.reset(jax.random.key(2))
    ts, _, _ = tvec.reset(env_seeds=torch.tensor(np.asarray(js.env_seed)))
    rng = np.random.default_rng(1)
    for _ in range(30):
        a = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        js, _, _, jd, ji = jvec.step(js, a)
        ts, _, _, td, ti = tvec.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti["episode"]["l"], ji["episode"]["l"])
    for k in ("episode_return", "mse"):
        np.testing.assert_allclose(list(tvec.queued_stats[k]), list(jvec.queued_stats[k]),
                                   rtol=1e-4)
    for k in ("episode_length", "constraint_violation"):
        assert list(tvec.queued_stats[k]) == list(jvec.queued_stats[k])
    assert len(tvec.queued_stats["episode_return"]) == 48
    tm, jm = tvec.mean_stats(), jvec.mean_stats()
    assert tm.keys() == jm.keys()
    np.testing.assert_allclose([tm[k] for k in tm], [jm[k] for k in tm], rtol=1e-4)
    with pytest.raises(ValueError):
        tvec.add_tracker("x", mode="sum")
