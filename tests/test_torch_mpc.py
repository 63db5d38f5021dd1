"""The port's MPC and LinearMPC against the JAX package's, solve by solve.

Each comparison starts both packages' solvers from the same
``(x0, ref, us_init, mu0)`` in float32 (the JAX solve ``vmap``ped over the
problems, the port's one batch); where ``terminal_lqr_cost`` is on, the
port takes JAX's ``P_term`` (the two float32 Riccati solutions differ, and
the port's solves in float64).  Closed loops are not compared step by step:
float32 decisions (the line search's argmin, the accept test) flip on
last-place differences and a loop then drifts; the bars of
``tests/test_mpc.py`` are reached instead (marked slow, as there).

Tolerances, from the float32 solves: costs rtol COST_RTOL; inputs within
US_REL of the largest input, multipliers within MU_REL of the largest
multiplier.  A converged unconstrained or soft solve sits where the cost is
flat to float32, and accept decisions between equal costs there move the
inputs by up to ~5e-4 of their scale (the AL solves agree to ~1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.linear_mpc import LinearMPC as TLinearMPC
from safe_control_gym_torch.controllers.mpc import MPC as TMPC
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_tpu.controllers.linear_mpc import LinearMPC as JLinearMPC
from safe_control_gym_tpu.controllers.mpc import MPC as JMPC
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import quadrotor as jq

COST_RTOL, US_REL, MU_REL = 5e-6, 1e-3, 2e-3

BOX = ({"constraint_form": "default_constraint", "constrained_variable": "input"},
       {"constraint_form": "default_constraint", "constrained_variable": "state"})
TIGHT = ({"constraint_form": "bounded_constraint", "constrained_variable": "input",
          "lower_bounds": [-2.0], "upper_bounds": [2.0]},)
# tests/test_mpc.py:29-44 and :57-73.
CARTPOLE = dict(task="stabilization", cost="quadratic", randomized_init=False,
                init_state={"init_theta": 0.2, "init_x": -0.3}, episode_len_sec=4)
# tests/test_mpc.py:79-96.
QUAD2D = dict(quad_type=2, task="stabilization", cost="quadratic",
              task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.01},
              randomized_init=False, init_state={"init_x": 0.3, "init_z": 0.6},
              episode_len_sec=3, ctrl_freq=50, pyb_freq=50)


def cartpoles(constraints=None, **kw):
    cfg = dict(CARTPOLE, constraints=constraints, **kw)
    return (jc.make_cartpole(jc.CartPoleConfig(**cfg)),
            tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"))


def quads(**kw):
    cfg = dict(QUAD2D, **kw)
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


# The 3D PID config of tests/test_controllers.py:82-99 with a quadratic cost.
QUAD3D = dict(quad_type=3, task="stabilization", cost="quadratic",
              task_info={"stabilization_goal": [0.3, -0.2, 1.0],
                         "stabilization_goal_tolerance": 0.05},
              randomized_init=False, init_state={"init_z": 0.5}, episode_len_sec=4,
              ctrl_freq=50, pyb_freq=100)
# The port's own P_term against JAX's DARE solved in float64: within P_REL of
# P's largest entry (the port's float32 P holds the float64 solution to
# ~3e-8; JAX's float32 SDA is off by up to 4.5e-5 on the 2D quad).
P_REL = 1e-6


def controllers(cls_j, cls_t, envs, **kw):
    jm, tm = cls_j(envs[0], **kw), cls_t(envs[1], **kw)
    tm.P_term = torch.as_tensor(np.asarray(jm.P_term))
    return jm, tm


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def solve_both(jm, tm, x0, us0, mu0, ref):
    ju, jcost, jmu = jax.vmap(lambda a, b, c: jm._solve(a, jnp.asarray(ref), b, c))(
        jnp.asarray(x0), jnp.asarray(us0), jnp.asarray(mu0))
    tu, tcost, tmu = tm._solve(torch.as_tensor(x0), torch.as_tensor(ref), torch.as_tensor(us0),
                               torch.as_tensor(mu0))
    return (np.asarray(ju), np.asarray(jcost), np.asarray(jmu)), (tu.numpy(), tcost.numpy(),
                                                                   tmu.numpy())


def check(want, got):
    (ju, jcost, jmu), (tu, tcost, tmu) = want, got
    assert tu.shape == ju.shape and tcost.shape == jcost.shape and tmu.shape == jmu.shape
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    assert rel(tu, ju) < US_REL
    if np.abs(jmu).max() > 0:
        assert rel(tmu, jmu) < MU_REL
    else:
        np.testing.assert_array_equal(tmu, jmu)


def inputs(jm, seed, B=8):
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(B, 4)) * [0.5, 0.3, 0.15, 0.3]).astype(np.float32)
    us0 = (rng.normal(size=(B, jm.T, 1)) * 2).astype(np.float32)
    nc = jm._mu_zeros().shape[-1]
    mu0 = (np.abs(rng.normal(size=(B, jm.T, nc))) * (seed > 0)).astype(np.float32)
    return x0, us0, mu0


@pytest.mark.parametrize("branch,constraints,soft", [
    ("unconstrained", None, False),
    ("soft", BOX, True),
    ("al", BOX, False),
    ("al-tight", TIGHT, False),
    ("soft-tight", TIGHT, True),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_mpc_solve_matches_jax(branch, constraints, soft, seed):
    """One solve of each branch of ``_make_solver`` on CartPole (horizon 10,
    2 AL x 3 inner iterations, the LQR terminal cost), from random inputs
    and, with seed 1, random positive multipliers."""
    jm, tm = controllers(JMPC, TMPC, cartpoles(constraints), horizon=10, q_mpc=[1.0],
                         r_mpc=[0.1], al_iters=2, inner_iters=3, terminal_lqr_cost=True,
                         soft_constraints=soft)
    x0, us0, mu0 = inputs(jm, seed)
    want, got = solve_both(jm, tm, x0, us0, mu0, np.asarray(jm.get_references(0)))
    check(want, got)
    if branch.startswith("al"):
        assert np.abs(want[2]).max() > 0  # the multipliers moved


def test_solve_batch_matches_jax():
    """tests/test_mpc.py:99-108: 16 envs, horizon 20, no constraints."""
    cfg = dict(task="stabilization", cost="quadratic", randomized_init=False)
    jm = JMPC(jc.make_cartpole(jc.CartPoleConfig(**cfg)), horizon=20, q_mpc=[1.0], r_mpc=[0.1],
              al_iters=1, inner_iters=4)
    tm = TMPC(tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"), horizon=20, q_mpc=[1.0],
              r_mpc=[0.1], al_iters=1, inner_iters=4)
    x0s = (np.random.default_rng(0).normal(size=(16, 4)) * 0.1).astype(np.float32)
    ju, jcost = map(np.asarray, jm.solve_batch(jnp.asarray(x0s)))
    tu, tcost = tm.solve_batch(torch.as_tensor(x0s))
    assert tuple(tu.shape) == (16, 20, 1) and np.all(np.isfinite(tcost.numpy()))
    np.testing.assert_allclose(tcost.numpy(), jcost, rtol=COST_RTOL)
    assert rel(tu.numpy(), ju) < US_REL
    # _policy is the first input of solve_batch.
    np.testing.assert_array_equal(tm._policy(torch.as_tensor(x0s)).numpy(), tu[:, 0].numpy())


def test_warm_start_shift_matches_jax():
    """select_action twice: the first solve from the equilibrium inputs and
    zero multipliers, the second from the shifted previous solution and
    multipliers (mpc.py:303-310).  The port's second solve starts from
    JAX's first solution, so that the shift is held, not the first solve's
    rounding; the applied inputs are clipped to the input box."""
    jm, tm = controllers(JMPC, TMPC, cartpoles(BOX), horizon=10, q_mpc=[1.0], r_mpc=[0.1],
                         al_iters=2, inner_iters=3, terminal_lqr_cost=True)
    obs = np.array([0.4, -0.2, 0.15, 0.1], np.float32)
    ja, ta = jm.select_action(obs), tm.select_action(obs)
    assert ta.shape == (1,) and abs(float(ta[0] - ja[0])) <= US_REL * np.abs(np.asarray(jm._prev_us)).max()
    tm._prev_us = torch.as_tensor(np.asarray(jm._prev_us))[None]
    tm._prev_mu = torch.as_tensor(np.asarray(jm._prev_mu))[None]
    obs2 = obs * 0.9
    ja2, ta2 = jm.select_action(obs2), tm.select_action(obs2)
    want = (np.asarray(jm._prev_us), None, np.asarray(jm._prev_mu))
    assert rel(tm._prev_us[0].numpy(), want[0]) < US_REL
    assert rel(tm._prev_mu[0].numpy(), want[2]) < MU_REL
    assert abs(float(ta2[0] - ja2[0])) <= US_REL * np.abs(want[0]).max()
    assert tm.traj_step == jm.traj_step == 2
    tm.reset()
    assert tm._prev_us is None and tm.traj_step == 0


def test_references_match_jax():
    """get_references on a tracking task: the horizon's slice of the goal
    trajectory with the last goal repeated past its end (mpc.py:327-345)."""
    cfg = dict(task="traj_tracking", cost="quadratic", episode_len_sec=1,
               task_info={"trajectory_type": "circle", "num_cycles": 1,
                          "trajectory_plane": "zx", "trajectory_position_offset": [0, 0],
                          "trajectory_scale": 0.2})
    je = jc.make_cartpole(jc.CartPoleConfig(**cfg))
    te = tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu")
    jm, tm = JMPC(je, horizon=8), TMPC(te, horizon=8)
    n = np.asarray(je.x_goal).shape[0]
    for step in (0, 5, n - 3, n + 4):
        np.testing.assert_array_equal(tm.get_references(step).numpy(),
                                      np.asarray(jm.get_references(step)))


@pytest.mark.parametrize("env", ["cartpole", "quad2d", "quad3d"])
def test_terminal_lqr_cost_matches_jax_in_float64(env):
    """``terminal_lqr_cost``: the port's own ``P_term`` (the DARE of its
    float32 linearization at the goal, solved in float64) against JAX's
    ``solve_discrete_are`` of JAX's float32 linearization, in float64 under
    ``jax.enable_x64``."""
    from safe_control_gym_tpu.ops.integrators import discretize_linear_system
    from safe_control_gym_tpu.ops.linalg import solve_discrete_are

    envs = {"cartpole": cartpoles, "quad2d": quads,
            "quad3d": lambda: quads(**QUAD3D)}[env]()
    jm = JMPC(envs[0], horizon=10, terminal_lqr_cost=True)
    tm = TMPC(envs[1], horizon=10, terminal_lqr_cost=True)
    Ad, Bd = discretize_linear_system(*jm.model.df_func(jm.traj[0], jm.u_eq), jm.dt)
    with jax.enable_x64():
        want = np.asarray(solve_discrete_are(
            *(jnp.asarray(np.asarray(t), jnp.float64) for t in (Ad, Bd, jm.Q, jm.R))))
    assert tm.P_term.dtype == torch.float32
    assert rel(tm.P_term.numpy(), want) < P_REL


def test_run_records_each_solve():
    """The sequential run: one warm-started solve a step, its wall time,
    and the analysis (the state RMSE)."""
    _, te = cartpoles(BOX)
    tm = TMPC(te, horizon=10, q_mpc=[1.0], r_mpc=[0.1], al_iters=1, inner_iters=2)
    out = tm.run(num_episodes=1, max_steps=4, analysis=True)
    assert out["obs"].shape == (4, 4) and out["action"].shape == (4, 1)
    assert out["t_wall"].shape == (4,) and np.all(out["t_wall"] > 0)
    assert np.all(np.abs(out["action"]) <= 10.0)
    assert out["analysis"]["state_rmse"].shape == (4,)


def test_linear_mpc_matches_jax():
    """LinearMPC on the 2D quad: the exact hover discretization (float64,
    cast to float32) and one solve."""
    envs = quads()
    jm, tm = controllers(JLinearMPC, TLinearMPC, envs, horizon=20, q_mpc=[1.0], r_mpc=[0.1],
                         al_iters=1, inner_iters=4, terminal_lqr_cost=True)
    # Two float32 ulps: the two float64 matrix exponentials round apart.
    np.testing.assert_allclose(tm._Ad.numpy(), np.asarray(jm._Ad), rtol=2.4e-7, atol=1e-12)
    np.testing.assert_allclose(tm._Bd.numpy(), np.asarray(jm._Bd), rtol=2.4e-7, atol=1e-12)
    assert tm._Ad.dtype == torch.float32
    rng = np.random.default_rng(5)
    x0 = (rng.normal(size=(4, 6)) * 0.2 + [0, 0, 1, 0, 0, 0]).astype(np.float32)
    us0 = np.tile(np.asarray(jm.u_eq)[None, None], (4, 20, 1)).astype(np.float32)
    mu0 = np.zeros((4, 20, 1), np.float32)
    want, got = solve_both(jm, tm, x0, us0, mu0, np.asarray(jm.get_references(0)))
    check(want, got)


# The closed-loop bars of tests/test_mpc.py (slow there too: 150 solves of a
# 40-step horizon on the CPU).
def closed_loop(env, ctrl, steps):
    from safe_control_gym_torch.parallel.vector import make_vec_env

    vec = make_vec_env(env, 1, auto_reset=False)
    state, obs, _ = vec.reset(env_seeds=torch.tensor([0], dtype=torch.int32))
    ctrl.reset()
    actions = []
    for _ in range(steps):
        a = ctrl.select_action(obs[0].numpy())
        actions.append(a)
        state, obs, _, _, _ = vec.step_no_reset(state, torch.as_tensor(a)[None])
    return state.x[0].numpy(), np.stack(actions)


@pytest.mark.slow
def test_mpc_stabilizes_cartpole_with_constraints():
    _, te = cartpoles(BOX)
    mpc = TMPC(te, horizon=40, q_mpc=[1.0], r_mpc=[0.1], al_iters=2, inner_iters=5,
               terminal_lqr_cost=True)
    x, actions = closed_loop(te, mpc, 150)
    assert abs(x[2]) < 0.05 and abs(x[0]) < 0.5, x
    assert np.abs(actions).max() <= 10.0 + 1e-4


@pytest.mark.slow
def test_mpc_respects_tight_input_constraint():
    _, te = cartpoles(TIGHT, init_state={"init_theta": 0.15})
    mpc = TMPC(te, horizon=40, q_mpc=[1.0], r_mpc=[0.1], al_iters=3, inner_iters=5,
               terminal_lqr_cost=True)
    x, actions = closed_loop(te, mpc, 120)
    assert np.abs(actions).max() <= 2.0 + 0.05, np.abs(actions).max()
    assert abs(x[2]) < 0.1, x


@pytest.mark.slow
def test_linear_mpc_quad2d():
    _, te = quads()
    lmpc = TLinearMPC(te, horizon=20, q_mpc=[1.0], r_mpc=[0.1], al_iters=1, inner_iters=4,
                      terminal_lqr_cost=True)
    x, _ = closed_loop(te, lmpc, 150)
    assert abs(x[0]) < 0.05 and abs(x[2] - 1.0) < 0.05, x
