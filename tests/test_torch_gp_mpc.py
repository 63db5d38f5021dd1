"""The port's GP regression (``ops/gp.py``) and GP-MPC
(``controllers/gp_mpc.py``) against the JAX package's.

Adam over 40-200 steps turns last-place gradient differences into
lr-sized steps, so a whole fit is held by the JAX suite's bar
(``tests/test_rl.py:132-144``) and the pieces one by one: ``_nll`` and its
gradient (rtol 1e-5), one Adam step of ``gp_fit`` (its parameters, alpha
rtol 1e-5, and its Cholesky factor of an 80x80 Gram matrix, atol 1e-5),
``gp_predict`` from JAX's ``GPState``
(carried by ``utils/convert.py``; mean atol 1e-4 on alphas of ~1e2, variance
atol 1e-6).  ``jax.random.choice`` cannot be reproduced, so Lloyd's
iterations start from JAX's chosen centroids (atol 1e-6).  GP-MPC takes
JAX's fitted ``GPState`` and prior gain ``K_prior`` (the port's solves its
Riccati equation in float64): ``probabilistic_margins`` on the mixed-row
config of ``tests/test_gp_mpc.py:15-110`` at that test's tolerance (rtol
2e-3 / atol 1e-6), and one solve: its costs at ``tests/test_torch_mpc.py``'s
COST_RTOL, its inputs within GP_US_REL of the largest (the GP mean, a sum
of ~30 terms of alpha ~1e2, differs by ~2.5e-5 between the packages from
the same state, and that moves the solved inputs by up to ~2.6e-3 of their
scale), its multipliers at MU_REL.
The exploration draws of ``learn()`` agree in distribution only; its bar:
the GP-corrected one-step prediction beats the prior's by half."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.gp_mpc import GPMPC as TGPMPC
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import gp as TG
from safe_control_gym_torch.utils.convert import gp_state_from_numpy
from safe_control_gym_tpu.controllers.gp_mpc import GPMPC as JGPMPC
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import gp as JG
from safe_control_gym_tpu.ops.linalg import dlqr_gain

COST_RTOL, MU_REL = 5e-6, 2e-3  # tests/test_torch_mpc.py's
GP_US_REL = 5e-3
# The port's float32 K_prior holds the float64 solution to ~9e-9 of its
# largest entry; JAX's float32 SDA is off by ~8e-3 on the 2D quad.
K_REL = 1e-6


def sincos(n=80, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    return X, np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], -1).astype(np.float32)


def test_nll_and_gradient_match_jax():
    X, Y = sincos()
    rng = np.random.default_rng(1)
    for _ in range(3):
        th = (rng.normal(size=4) * 0.5).astype(np.float32)
        w, wg = jax.value_and_grad(JG._nll)(jnp.asarray(th), jnp.asarray(X), jnp.asarray(Y[:, 0]))
        t = torch.as_tensor(th).requires_grad_(True)
        loss = TG._nll(t, torch.as_tensor(X), torch.as_tensor(Y[:, 0]))
        loss.backward()
        np.testing.assert_allclose(float(loss), float(w), rtol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), rtol=1e-5, atol=1e-6)
    # Over the output dims at once: each dim's own NLL.
    th2 = (rng.normal(size=(2, 4)) * 0.5).astype(np.float32)
    both = TG._nll(torch.as_tensor(th2), torch.as_tensor(X), torch.as_tensor(Y.T.copy()))
    for i in range(2):
        np.testing.assert_allclose(float(both[i]), float(JG._nll(
            jnp.asarray(th2[i]), jnp.asarray(X), jnp.asarray(Y[:, i]))), rtol=1e-5)


def test_one_adam_step_matches_jax():
    X, Y = sincos()
    want = jax.tree.map(np.asarray, JG.gp_fit(jnp.asarray(X), jnp.asarray(Y), iters=1))
    got = TG.gp_fit(torch.as_tensor(X), torch.as_tensor(Y), iters=1)
    for g, w in zip(got.params, want.params):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.L.numpy(), want.L, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.alpha.numpy(), want.alpha, rtol=1e-4, atol=1e-4)


def test_predict_from_jax_state_and_fit_bar():
    X, Y = sincos()
    Xq = np.random.default_rng(2).uniform(-1.5, 1.5, size=(30, 2)).astype(np.float32)
    js = JG.gp_fit(jnp.asarray(X), jnp.asarray(Y), iters=150)
    wm, wv = map(np.asarray, JG.gp_predict(js, jnp.asarray(Xq)))
    state = gp_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    m, v = TG.gp_predict(state, torch.as_tensor(Xq))
    np.testing.assert_allclose(m.numpy(), wm, rtol=0, atol=1e-4)
    np.testing.assert_allclose(v.numpy(), wv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(TG.gp_mean(state, torch.as_tensor(Xq)).numpy(), wm, rtol=0,
                               atol=1e-4)
    # The JAX suite's bar (tests/test_rl.py:132-144) on the port's own fit.
    ts = TG.gp_fit(torch.as_tensor(X), torch.as_tensor(Y), iters=150)
    mean, var = TG.gp_predict(ts, torch.as_tensor(Xq))
    want = np.stack([np.sin(Xq[:, 0]), np.cos(Xq[:, 1])], -1)
    assert np.abs(mean.numpy() - want).max() < 0.15
    assert bool((var > 0).all())


def test_lloyd_from_jax_centroids():
    x = np.random.default_rng(3).normal(size=(120, 5)).astype(np.float32)
    key = jax.random.key(1)
    want = np.asarray(JG.kmeans(key, jnp.asarray(x), 12))
    idx = np.asarray(jax.random.choice(key, 120, (12,), replace=False))
    got = TG.lloyd(torch.as_tensor(x), torch.as_tensor(x[idx]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    c = TG.kmeans(torch.Generator().manual_seed(0), torch.as_tensor(x), 12)
    assert c.shape == (12, 5) and bool(torch.isfinite(c).all())


NX, NU = 6, 2
P_QUAD = np.diag([1.0, 0.2, 1.0, 0.2, 0.5, 0.1])
MIXED = [
    {"constraint_form": "quadratic_constraint", "constrained_variable": "state",
     "P": P_QUAD.tolist(), "b": 25.0},
    {"constraint_form": "default_constraint", "constrained_variable": "input"},
    {"constraint_form": "symmetric_constraint", "constrained_variable": "state",
     "bound": [2.0, 2.0], "active_dims": [0, 2]},
    {"constraint_form": "linear_constraint", "constrained_variable": "state",
     "A": np.eye(NX).tolist(), "b": (np.ones(NX) * 3.0).tolist()},
]
QUAD2D = dict(quad_type=2, task="stabilization", cost="quadratic",
              task_info={"stabilization_goal": [0, 1], "stabilization_goal_tolerance": 0.01},
              randomized_init=False, init_state={"init_z": 0.9}, episode_len_sec=2,
              ctrl_freq=25, pyb_freq=50)


@pytest.fixture(scope="module")
def mixed():
    """Both packages' GP-MPC on the mixed-row config; the port's carries
    JAX's fitted GPs, prior gain and terminal cost."""
    cfg = dict(QUAD2D, constraints=MIXED)
    kw = dict(horizon=8, q_mpc=[1.0], r_mpc=[0.1], num_samples=60, num_inducing=30,
              gp_iters=40, al_iters=1, inner_iters=3)
    jg = JGPMPC(jq.make_quadrotor(jq.QuadrotorConfig(**cfg)), **kw)
    tg = TGPMPC(tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"), **kw)
    jg.learn()
    assert tg.learn()["train_points"] <= 30
    tg.gp_state = gp_state_from_numpy(jax.tree.map(np.asarray, jg.gp_state), "cpu")
    tg.K_prior = torch.as_tensor(np.asarray(dlqr_gain(jg._Ad, jg._Bd, jg.Q, jg.R)[0]))
    tg.P_term = torch.as_tensor(np.asarray(jg.P_term))
    tg._solve = tg._make_gp_solver()
    tg._margins = None
    return jg, tg


def test_prior_gain_matches_jax_in_float64():
    """The port's own ``K_prior`` (the LQR gain of its float32 hover
    linearization, solved in float64) against JAX's ``dlqr_gain`` of JAX's
    float32 linearization, in float64 under ``jax.enable_x64``: within
    K_REL of the gain's largest entry."""
    cfg = dict(QUAD2D, constraints=MIXED)
    kw = dict(horizon=8, q_mpc=[1.0], r_mpc=[0.1])
    jg = JGPMPC(jq.make_quadrotor(jq.QuadrotorConfig(**cfg)), **kw)
    tg = TGPMPC(tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"), **kw)
    with jax.enable_x64():
        want = np.asarray(dlqr_gain(
            *(jnp.asarray(np.asarray(t), jnp.float64) for t in (jg._Ad, jg._Bd, jg.Q, jg.R)))[0])
    got = tg.K_prior.numpy()
    assert tg.K_prior.dtype == torch.float32
    assert np.abs(got - want).max() < K_REL * np.abs(want).max()


def test_margins_mixed_rows_match_jax(mixed):
    jg, tg = mixed
    x0 = np.zeros(NX, np.float32)
    x0[2] = 0.9
    us = np.tile(np.asarray(jg._u_eq2)[None], (jg.T, 1)) * 1.05
    want = np.asarray(jg.probabilistic_margins(x0, us))
    got = tg.probabilistic_margins(x0, us).numpy()
    assert got.shape == (tg.T, tg._cc.num_constraints)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)
    # The row mapping of tests/test_gp_mpc.py:95-108: the quadratic row
    # (output row 0) carries its gradient margin, the input rows none, and
    # the symmetric rows grow along the horizon from an untightened x0.
    assert got[1:, 0].min() > 0
    np.testing.assert_allclose(got[:, 1:1 + 2 * NU], 0.0, atol=1e-9)
    sym = got[:, 1 + 2 * NU]
    assert sym[0] == 0.0 and np.all(np.diff(sym) > -1e-9) and sym[-1] > sym[1] * 1.5


def test_gp_solve_matches_jax(mixed):
    jg, tg = mixed
    rng = np.random.default_rng(4)
    x0 = (rng.normal(size=(4, NX)) * 0.1 + [0, 0, 0.9, 0, 0, 0]).astype(np.float32)
    us0 = np.tile(np.asarray(jg._u_eq2)[None, None], (4, jg.T, 1)).astype(np.float32)
    mu0 = np.zeros((4, jg.T, tg._cc.num_constraints), np.float32)
    ref = np.asarray(jg.get_references(0))
    ju, jcost, jmu = map(np.asarray, jax.vmap(lambda a, b, c: jg._solve(a, jnp.asarray(ref), b, c))(
        jnp.asarray(x0), jnp.asarray(us0), jnp.asarray(mu0)))
    tu, tcost, tmu = (t.numpy() for t in tg._solve(*map(torch.as_tensor, (x0, ref, us0, mu0))))
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    assert np.abs(tu - ju).max() < GP_US_REL * np.abs(ju).max()
    assert np.abs(tmu - jmu).max() <= MU_REL * max(np.abs(jmu).max(), 1e-30)
    # The GP-corrected dynamics themselves.
    u = torch.as_tensor(us0[:, 0])
    want = np.asarray(jax.vmap(lambda x, v: jg._fd_gp(jg.gp_state, x, v))(
        jnp.asarray(x0), jnp.asarray(us0[:, 0])))
    np.testing.assert_allclose(tg._fd_gp(tg.gp_state, torch.as_tensor(x0), u).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_learn_beats_the_prior():
    """tests/test_gp_mpc.py:113-160's residual bar on the port: the env's
    true mass (0.041) is not the prior's (0.03454)."""
    cfg = dict(QUAD2D, inertial_prop={"M": 0.041, "Iyy": 1.4e-5})
    env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu")
    gpmpc = TGPMPC(env, horizon=10, q_mpc=[1.0], r_mpc=[0.1], num_samples=150,
                   num_inducing=40, gp_iters=80, al_iters=1, inner_iters=4,
                   terminal_lqr_cost=True)
    assert gpmpc.learn()["train_points"] > 10
    gen = torch.Generator().manual_seed(9)
    state, _, _ = env.reset(torch.tensor([9], dtype=torch.int32))
    lo, hi = (torch.as_tensor(a, dtype=torch.float32) for a in (env.spaces.action_low,
                                                                 env.spaces.action_high))
    prior_err = gp_err = 0.0
    x_prev = state.x[0]
    for _ in range(40):
        u = torch.clamp(gpmpc._u_eq2 * (1.0 + 0.1 * torch.randn(2, generator=gen)), lo, hi)
        state, _, _, done, _ = env.step(state, u[None])
        x_next = state.x[0]
        prior_err += float(((gpmpc._fd_prior(x_prev, u) - x_next) ** 2).sum())
        gp_err += float(((gpmpc._fd_gp(gpmpc.gp_state, x_prev, u) - x_next) ** 2).sum())
        x_prev = x_next
        if bool(done[0]):
            break
    assert gp_err < prior_err * 0.5, (gp_err, prior_err)
    a = gpmpc.select_action(state.x[0].numpy())
    assert a.shape == (2,) and np.all(np.isfinite(a))
