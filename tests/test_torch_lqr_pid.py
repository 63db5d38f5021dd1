"""The port's LQR and PID controllers against the JAX package's.

- LQR's gain (stabilization) and gain table (tracking, one Riccati solve a
  waypoint) on CartPole stabilization, the 2D quadrotor and a short 3D
  figure-8, from the same env configs;
- closed-loop episodes stepped against the JAX package's, step by step,
  from the same initial state;
- the four bars of ``tests/test_controllers.py:30-117`` (LQR on CartPole
  and the 2D quad, PID on the 3D quad and the 2D hover) reached by the port;
- ``run_tracking`` against the JAX package's on the same env seeds;
- ``pid_control`` on random inputs against the JAX package's (``vmap``ed),
  and batched against per-env.

Tolerances: gains relative to the largest entry, 1e-5 on CartPole and 2e-3
on the quadrotors (the float32 Riccati solutions of ``tests/
test_torch_linalg.py``); closed-loop states the JAX suite's state
tolerance, rtol 2e-4 / atol 2e-5, and done flags exact; ``pid_control``
rtol 2e-4 on the RPMs (gains of 7e4 on the attitude error turn a last-place
difference of a rotation into ~1e-7 of an RPM) and the state tolerance on
the PID state and errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.lqr import LQR as TLQR
from safe_control_gym_torch.controllers.pid import PID as TPID
from safe_control_gym_torch.controllers.pid import PIDState as TPIDState
from safe_control_gym_torch.controllers.pid import pid_control as t_pid_control
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_tpu.controllers.lqr import LQR as JLQR
from safe_control_gym_tpu.controllers.pid import PID as JPID
from safe_control_gym_tpu.controllers.pid import PIDState as JPIDState
from safe_control_gym_tpu.controllers.pid import pid_control as j_pid_control
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import ctr_prng as jctr

RTOL, ATOL = 2e-4, 2e-5

# tests/test_controllers.py:30-117.
LQR_CARTPOLE = dict(task="stabilization", cost="quadratic", randomized_init=True,
                    episode_len_sec=5)
LQR_QUAD2D = dict(quad_type=2, task="stabilization", cost="quadratic",
                  task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.01},
                  randomized_init=False, init_state={"init_x": 0.2, "init_z": 0.7},
                  episode_len_sec=4, ctrl_freq=50, pyb_freq=50)
PID_QUAD3D = dict(quad_type=3, task="stabilization", cost="rl_reward",
                  task_info={"stabilization_goal": [0.3, -0.2, 1.0],
                             "stabilization_goal_tolerance": 0.05},
                  randomized_init=False, init_state={"init_z": 0.5}, episode_len_sec=4,
                  ctrl_freq=50, pyb_freq=100)
PID_QUAD2D = dict(quad_type=2, task="stabilization",
                  task_info={"stabilization_goal": [0.0, 1.0],
                             "stabilization_goal_tolerance": 0.05},
                  randomized_init=False, init_state={"init_z": 0.8}, episode_len_sec=3,
                  ctrl_freq=50, pyb_freq=100)
# A short 3D figure-8 (config 4's trajectory, 0.5 s: 30 waypoints).
FIGURE8 = dict(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.5,
               task="traj_tracking",
               task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
                          "trajectory_position_offset": [0.0, 0.0], "trajectory_scale": 1.0,
                          "num_cycles": 1, "proj_point": [0, 0, 0.5],
                          "proj_normal": [0, 1, 1]},
               cost="quadratic")


def envs(kind, cfg):
    if kind == "cartpole":
        return (jc.make_cartpole(jc.CartPoleConfig(**cfg)),
                tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"))
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind,cfg,discrete,tol", [
    ("cartpole", LQR_CARTPOLE, True, 1e-5),
    ("cartpole", LQR_CARTPOLE, False, 1e-5),
    ("quad", LQR_QUAD2D, True, 2e-3),
    ("quad", LQR_QUAD2D, False, 2e-3),
    ("quad", FIGURE8, True, 2e-3),
], ids=["cartpole", "cartpole-continuous", "quad2d", "quad2d-continuous", "quad3d-figure8"])
def test_lqr_gains_match_jax(kind, cfg, discrete, tol):
    jenv, tenv = envs(kind, cfg)
    jl = JLQR(jenv, q_lqr=[1.0], r_lqr=[0.1], discrete_dynamics=discrete)
    tl = TLQR(tenv, q_lqr=[1.0], r_lqr=[0.1], discrete_dynamics=discrete)
    want = np.asarray(jl.gain)
    assert tuple(tl.gain.shape) == want.shape and tl.gain.dtype == torch.float32
    if want.ndim == 3:  # the tracking table: one gain a waypoint
        assert want.shape[0] == np.asarray(jenv.x_goal).shape[0] == 30
    assert rel(tl.gain.numpy(), want) < tol


def _episode(jenv, tenv, jctrl, tctrl, steps, seed=0):
    """Both controllers in closed loop on their package's env from the same
    initial state (the JAX reset's env seed), ``select_action`` on the host
    each step; returns both packages' state and done stacks."""
    key = jax.random.key(seed)
    js, jo, _ = jax.jit(jenv.reset)(key)
    jstep = jax.jit(jenv.step)
    vec = make_vec_env(tenv, 1, auto_reset=False)
    ts, to, _ = vec.reset(env_seeds=torch.tensor([int(jctr.env_seed_from_key(key))]))
    jctrl.reset()
    tctrl.reset()
    out = {"jx": [], "tx": [], "jd": [], "td": []}
    for _ in range(steps):
        js, jo, _, jd, _ = jstep(js, jnp.asarray(jctrl.select_action(np.asarray(jo))))
        act = torch.as_tensor(tctrl.select_action(to[0].numpy()))[None]
        ts, to, _, td, _ = vec.step_no_reset(ts, act)
        out["jx"].append(np.asarray(js.x))
        out["tx"].append(ts.x[0].numpy().copy())
        out["jd"].append(bool(jd))
        out["td"].append(bool(td[0]))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("ctrl", ["lqr-quad2d", "pid-quad2d"])
def test_closed_loop_episode_matches_jax(ctrl):
    """A whole closed-loop episode (LQR: 200 steps, PID hover: 150), state
    by state.  The LQR runs on the JAX package's gain: the float32 Riccati
    solutions of the two packages differ by 1e-4 of the gain's scale on the
    2D quad (held by ``test_lqr_gains_match_jax``), which moves the closed
    loop's states by more than the state tolerance within a few steps."""
    if ctrl == "lqr-quad2d":
        jenv, tenv = envs("quad", LQR_QUAD2D)
        jctrl, tctrl = JLQR(jenv, q_lqr=[1.0], r_lqr=[0.1]), TLQR(tenv, q_lqr=[1.0], r_lqr=[0.1])
        tctrl.gain = torch.from_numpy(np.array(jctrl.gain))
    else:
        jenv, tenv = envs("quad", PID_QUAD2D)
        jctrl, tctrl = JPID(jenv), TPID(tenv)
    out = _episode(jenv, tenv, jctrl, tctrl, tenv.max_episode_steps)
    np.testing.assert_array_equal(out["td"], out["jd"])
    np.testing.assert_allclose(out["tx"], out["jx"], rtol=RTOL, atol=ATOL)
    assert np.abs(out["tx"][-1] - out["tx"][0]).max() > 0.05  # the drone moved


def test_pid_quad3d_along_the_jax_episode():
    """The 3D PID's actions on every state of the JAX package's closed-loop
    episode (200 steps), and the first 10 steps of the port's own closed
    loop.  Further the 3D closed loop cannot be held state by state: with
    the motors at their PWM bounds the loop amplifies a last-place
    difference about twofold a step (1e-11 at step 4, O(1) by step 50 on
    this config), while both packages still end within the bar of
    ``test_bar_pid_tracks_quad3d``."""
    jenv, tenv = envs("quad", PID_QUAD3D)
    jpid, tpid = JPID(jenv), TPID(tenv)
    js, jo, _ = jax.jit(jenv.reset)(jax.random.key(0))
    jstep = jax.jit(jenv.step)
    for _ in range(tenv.max_episode_steps):
        act = jpid.select_action(np.asarray(jo))
        np.testing.assert_allclose(tpid.select_action(np.asarray(jo)), act, rtol=RTOL)
        js, jo, _, _, _ = jstep(js, jnp.asarray(act))
    out = _episode(jenv, tenv, JPID(jenv), TPID(tenv), 10)
    np.testing.assert_allclose(out["tx"], out["jx"], rtol=RTOL, atol=ATOL)


def _run_episode(env, ctrl, seed=0):
    """``tests/test_controllers.py::_run_episode`` on the port: one env on
    the host until done or the time limit; the states visited."""
    vec = make_vec_env(env, 1, auto_reset=False)
    state, obs, _ = vec.reset(seed=seed)
    ctrl.reset()
    xs = []
    for _ in range(env.max_episode_steps):
        act = torch.as_tensor(ctrl.select_action(obs[0].numpy()))[None]
        state, obs, _, done, _ = vec.step_no_reset(state, act)
        xs.append(state.x[0].numpy().copy())
        if bool(done[0]):
            break
    return np.stack(xs)


def test_bar_lqr_stabilizes_cartpole():
    env = tc.make_cartpole(tc.CartPoleConfig(**LQR_CARTPOLE), device="cpu")
    for seed in range(3):
        xs = _run_episode(env, TLQR(env, q_lqr=[1.0], r_lqr=[0.1]), seed=seed)
        assert np.abs(xs[-1]).max() < 0.05, f"final state {xs[-1]}"
    # From a start off the goal's tolerance, too.
    env = tc.make_cartpole(tc.CartPoleConfig(**{**LQR_CARTPOLE, "randomized_init": False,
                                                "init_state": {"init_theta": 0.2,
                                                               "init_x": -0.3}}), device="cpu")
    xs = _run_episode(env, TLQR(env, q_lqr=[1.0], r_lqr=[0.1]))
    assert len(xs) > 10 and np.abs(xs[-1]).max() < 0.05, f"final state {xs[-1]}"


def test_bar_lqr_stabilizes_quad2d():
    env = tq.make_quadrotor(tq.QuadrotorConfig(**LQR_QUAD2D), device="cpu")
    xs = _run_episode(env, TLQR(env, q_lqr=[1.0], r_lqr=[0.1]))
    err = np.abs(xs[-1] - env.x_goal)
    assert err[0] < 0.05 and err[2] < 0.05, f"final err {err}"


def test_bar_pid_tracks_quad3d():
    env = tq.make_quadrotor(tq.QuadrotorConfig(**PID_QUAD3D), device="cpu")
    xs = _run_episode(env, TPID(env))
    final_pos = xs[-1][[0, 2, 4]]
    assert np.linalg.norm(final_pos - np.array([0.3, -0.2, 1.0])) < 0.1, final_pos


def test_bar_pid_hover_quad2d():
    env = tq.make_quadrotor(tq.QuadrotorConfig(**PID_QUAD2D), device="cpu")
    xs = _run_episode(env, TPID(env))
    assert abs(xs[-1][2] - 1.0) < 0.05, f"z = {xs[-1][2]}"


def test_pid_on_the_1d_quad_sums_the_motors():
    """The 1D quad takes the four motors' summed force (pid.py:186-187)."""
    env = tq.make_quadrotor(tq.QuadrotorConfig(quad_type=1, task="stabilization",
                                               randomized_init=False), device="cpu")
    pid = TPID(env)
    a = pid.select_action(np.array([0.5, 0.0], np.float32))
    pid.reset()
    x = torch.tensor([[0.5, 0.0]])
    forces = pid.act(x, 0, TPIDState.create((1,)))[0]
    assert a.shape == (1,) and forces.shape == (1, 1)
    np.testing.assert_allclose(a, forces[0].numpy(), rtol=1e-6)


def test_run_tracking_matches_jax():
    """A whole short figure-8 from the same env seeds and the JAX package's
    gain table (as in ``test_closed_loop_episode_matches_jax``): per-episode
    returns and tracking RMSE."""
    jenv, tenv = envs("quad", FIGURE8)
    n = 4
    jlqr, tlqr = JLQR(jenv, q_lqr=[1.0], r_lqr=[0.1]), TLQR(tenv, q_lqr=[1.0], r_lqr=[0.1])
    tlqr.gain = torch.from_numpy(np.array(jlqr.gain))
    jres = jlqr.run_tracking(num_episodes=n, seed=3)
    seeds = np.asarray(jax.vmap(jctr.env_seed_from_key)(jax.random.split(jax.random.key(3), n)))
    tres = tlqr.run_tracking(num_episodes=n, env_seeds=torch.tensor(seeds))
    for k in ("ep_returns", "rmse"):
        assert tres[k].shape == (n,)
        np.testing.assert_allclose(tres[k], np.asarray(jres[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def _pid_inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(
        state=(f(B, 3, scale=0.1), f(B, 3, scale=0.1), f(B, 3, scale=0.2)),
        cur_pos=f(B, 3, scale=0.5) + np.float32([0, 0, 1]), cur_rpy=f(B, 3, scale=0.2),
        cur_vel=f(B, 3, scale=0.3), target_pos=f(B, 3, scale=0.5) + np.float32([0, 0, 1]),
        target_rpy=f(B, 3, scale=0.3), target_vel=f(B, 3, scale=0.2),
        target_rpy_rates=f(B, 3, scale=0.1))


def _port_pid(inp, idx=slice(None)):
    s = TPIDState(*(torch.from_numpy(a[idx]) for a in inp["state"]))
    kw = {k: torch.from_numpy(v[idx]) for k, v in inp.items() if k != "state"}
    return t_pid_control(s, 0.02, **kw)


def test_pid_control_matches_jax_on_random_inputs():
    B = 64
    inp = _pid_inputs(B)
    jfn = jax.vmap(lambda s, kw: j_pid_control(s, 0.02, **kw))
    jrpm, jstate, jpos_e, jyaw_e = jfn(JPIDState(*map(jnp.asarray, inp["state"])),
                                       {k: jnp.asarray(v) for k, v in inp.items() if k != "state"})
    rpm, state, pos_e, yaw_e = _port_pid(inp)
    assert rpm.shape == (B, 4)
    np.testing.assert_allclose(rpm.numpy(), np.asarray(jrpm), rtol=RTOL)
    for got, want in ((state.integral_pos_e, jstate.integral_pos_e),
                      (state.integral_rpy_e, jstate.integral_rpy_e),
                      (state.last_rpy, jstate.last_rpy), (pos_e, jpos_e), (yaw_e, jyaw_e)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # Inputs that drive the clamps: the PWM bounds and the integrators'.
    assert (rpm.numpy() < 4070.3 + 0.2685 * 20000.0 + 1).any() or (rpm.numpy() > 21000).any()


def test_pid_control_batched_equals_per_env():
    inp = _pid_inputs(16, seed=1)
    rpm, state, _, yaw_e = _port_pid(inp)
    for i in (0, 7, 15):
        r1, s1, _, y1 = _port_pid(inp, i)
        np.testing.assert_allclose(rpm[i].numpy(), r1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(state.integral_rpy_e[i].numpy(), s1.integral_rpy_e.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(yaw_e[i].numpy(), y1.numpy(), rtol=1e-6, atol=1e-7)


def test_pid_act_batched_equals_select_action():
    """The batched ``act`` over four drones gives each the action that the
    one-env ``select_action`` gives it."""
    env = tq.make_quadrotor(tq.QuadrotorConfig(**PID_QUAD3D), device="cpu")
    pid = TPID(env)
    obs = torch.from_numpy(_pid_inputs(4)["cur_pos"].repeat(4, 1)[:, :12].copy())
    batched, _ = pid.act(obs, 0, TPIDState.create((4,)))
    for i in range(4):
        pid.reset()
        np.testing.assert_allclose(pid.select_action(obs[i].numpy()), batched[i].numpy(),
                                   rtol=1e-6)
