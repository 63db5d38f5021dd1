"""The port's ADMM QP (``ops/qp.py``) and CBF-QP filter
(``controllers/cbf.py``) against the JAX package's.

- ``solve_qp`` on random feasible QPs: batched against one at a time
  (1e-5: a batched product rounds apart from a single one, and 200 ADMM
  iterations carry it), and against JAX's (float32, QP_ATOL), within
  QP_FEAS of feasibility;
- ``CBF_QP`` on CartPole (``tests/test_rl.py:114-170``) with JAX's residual
  MLP weights (``utils/convert.py::load_mlp``): ``barrier`` and
  ``lie_derivative_coeffs`` (1e-6), ``certify`` soft and hard, with and
  without the learned model, on a batch of states (QP_ATOL), ``is_cbf``
  (the same verdict and infeasible set), one residual epoch from the same
  data (parameters rtol 1e-5 / atol 1e-7: one Adam step of lr 1e-3 from
  gradients that agree to float32 rounding), and the bars of
  ``tests/test_rl.py``: the filter pulls an unsafe command back near the
  boundary, ``learn`` returns a finite loss."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import vmap

from safe_control_gym_torch.controllers.cbf import CBF_QP as TCBF
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.ops.qp import qp_primal_residual, solve_qp
from safe_control_gym_torch.utils.convert import load_mlp
from safe_control_gym_tpu.controllers.cbf import CBF_QP as JCBF
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.ops import qp as jqp

QP_ATOL, QP_FEAS = 1e-4, 1e-3


def random_qps(B, n, m, seed=0):
    """Feasible QPs: a random point inside [l, ub] of A u."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    Au = (A @ rng.normal(size=(B, n, 1)))[..., 0]
    l, ub = Au - rng.uniform(0.1, 1.0, (B, m)), Au + rng.uniform(0.1, 1.0, (B, m))
    return [a.astype(np.float32) for a in (P, q, A, l, ub)]


def test_solve_qp_batched_and_against_jax():
    P, q, A, l, ub = random_qps(16, 4, 6)
    u, z, y = solve_qp(*map(torch.as_tensor, (P, q, A, l, ub)))
    assert u.shape == (16, 4) and z.shape == y.shape == (16, 6)
    for b in range(16):
        ub_, zb, yb = solve_qp(*(torch.as_tensor(a[b]) for a in (P, q, A, l, ub)))
        np.testing.assert_allclose(ub_.numpy(), u[b].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(yb.numpy(), y[b].numpy(), rtol=0, atol=1e-5)
    want = jax.vmap(jqp.solve_qp)(*map(jnp.asarray, (P, q, A, l, ub)))
    for got, w in zip((u, z, y), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=QP_ATOL)
    res = qp_primal_residual(u, *map(torch.as_tensor, (A, l, ub)))
    want_res = jax.vmap(jqp.qp_primal_residual)(jnp.asarray(np.asarray(u.numpy())),
                                                *map(jnp.asarray, (A, l, ub)))
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), rtol=0, atol=1e-6)
    assert float(res.max()) < QP_FEAS


def cbfs(**kw):
    cfg = dict(normalized_rl_action_space=False, **kw.pop("cfg", {}))
    j = JCBF(jc.make_cartpole(jc.CartPoleConfig(**cfg)), **kw)
    t = TCBF(tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"), **kw)
    load_mlp(t.mlp, jax.tree.map(np.asarray, j.mlp_params))
    return j, t


def states(B=64, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, 4)) * [1.5, 1.0, 0.2, 0.5]).astype(np.float32),
            (rng.normal(size=(B, 1)) * 5).astype(np.float32))


BARRIER_4D = dict(barrier_dims=(0, 1, 2, 3), barrier_bounds=(1.0, 2.0, 0.3, 1.0),
                  cfg=dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=2))


@pytest.mark.parametrize("kw", [dict(), BARRIER_4D], ids=["2d", "4d"])
def test_barrier_and_lie_derivative_match_jax(kw):
    j, t = cbfs(slope=0.5, **kw)
    X, _ = states()
    np.testing.assert_allclose(t.barrier(torch.as_tensor(X)).numpy(),
                               np.asarray(jax.vmap(j.barrier)(jnp.asarray(X))), rtol=1e-6,
                               atol=1e-7)
    c0, c1 = vmap(t.lie_derivative_coeffs)(torch.as_tensor(X))
    w0, w1 = jax.vmap(j.lie_derivative_coeffs)(jnp.asarray(X))
    np.testing.assert_allclose(c0.numpy(), np.asarray(w0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), np.asarray(w1), rtol=1e-6, atol=1e-6)
    ok, bad = t.is_cbf(num_points=5 if kw else 10)
    w_ok, w_bad = j.is_cbf(num_points=5 if kw else 10)
    assert ok == w_ok and isinstance(ok, bool)
    np.testing.assert_array_equal(bad, w_bad)


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
@pytest.mark.parametrize("learned", [True, False], ids=["learned", "nominal"])
def test_certify_matches_jax(soft, learned):
    j, t = cbfs(slope=0.5, soft_constrained=soft)
    X, Ud = states(seed=1)
    params = j.mlp_params if learned else jax.tree.map(jnp.zeros_like, j.mlp_params)
    wu, ws = jax.vmap(lambda x, u: j._certify(params, x, u))(jnp.asarray(X), jnp.asarray(Ud))
    with torch.no_grad():
        u, s = t.certify(torch.as_tensor(X), torch.as_tensor(Ud), use_learned_model=learned)
    assert u.shape == (64, 1) and s.shape == (64,)
    np.testing.assert_allclose(u.numpy(), np.asarray(wu), rtol=0, atol=QP_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0, atol=QP_ATOL)
    # certify_action: one state, the same QP.
    a, ok = t.certify_action(X[3], Ud[3], use_learned_model=learned)
    wa, wok = j.certify_action(X[3], Ud[3], use_learned_model=learned)
    np.testing.assert_allclose(a, wa, rtol=0, atol=QP_ATOL)
    assert ok == wok


def test_residual_epoch_matches_jax():
    """One full-batch Adam step of the residual model on the same data."""
    j, t = cbfs(slope=0.5)
    rng = np.random.default_rng(2)
    X, U = states(256, seed=2)
    Y = rng.normal(size=256).astype(np.float32)
    nu = 1

    def loss_fn(p):
        ab = j.mlp.apply(p, jnp.asarray(X))
        pred = (ab[:, :nu] * jnp.asarray(U)).sum(-1) + ab[:, nu]
        return ((pred - jnp.asarray(Y)) ** 2).mean()

    w_loss, grads = jax.value_and_grad(loss_fn)(j.mlp_params)
    upd, _ = j.opt.update(grads, j.opt_state, j.mlp_params)
    w_params = jax.tree.map(np.asarray, optax.apply_updates(j.mlp_params, upd))
    loss = t.train_epoch(*map(torch.as_tensor, (X, U, Y)))
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    for i, layer in enumerate(t.mlp.layers):
        d = w_params["params"][f"Dense_{i}"]
        np.testing.assert_allclose(layer.weight.detach().numpy(), d["kernel"].T, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(layer.bias.detach().numpy(), d["bias"], rtol=1e-5, atol=1e-7)


def test_cbf_bars():
    """tests/test_rl.py:114-130 on the port."""
    _, t = cbfs(slope=0.5, soft_constrained=True)
    u, _ = t.certify_action(np.array([0.1, 0.1, 0.05, 0.0], np.float32),
                            np.array([3.0], np.float32), use_learned_model=False)
    assert np.isfinite(u).all() and abs(u[0]) <= 10.0 + 1e-3
    ub_, _ = t.certify_action(np.array([2.3, 1.8, 0.0, 0.0], np.float32),
                              np.array([10.0], np.float32), use_learned_model=False)
    assert ub_[0] < 10.0 - 1e-3  # pulled back from the unsafe command
    res = t.learn(max_samples=100, epochs=10)
    assert np.isfinite(res["residual_loss"])
    assert t.select_action(np.zeros(4, np.float32), {"unsafe_action": np.array([1.0])}).shape == (1,)
