"""The port's Riccati solvers and LQR gains (``ops/linalg.py``) against the
JAX package's in float32 and against scipy in float64, on the linearized
CartPole, 2D quadrotor and 3D quadrotor (the systems LQR solves) and a
random stable system; batched solves against looped ones.

Tolerances, relative to the largest entry of the reference:
- float64 against scipy: 1e-10 (both solvers converge to rounding);
- float32 against the JAX package: 1e-5 on the CartPole, 1e-4 on the
  random system (both packages 1e-5 from scipy, on either side of it, after
  40 float32 Newton steps); 5e-3 for P and 1e-3 for K on the quadrotors, whose
  Riccati solutions span several decades (thrusts of ~0.1 N against unit
  state weights): there JAX's own float32 SDA is 1.3e-3 away from scipy,
  and the port's is no further from scipy than 2x JAX's distance;
- batched against looped: 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl
import torch

from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import integrators as ti
from safe_control_gym_torch.ops import linalg as tl
from safe_control_gym_tpu.ops import linalg as jl


def _linearized(env):
    m = env.symbolic
    A, B = m.df_func(torch.tensor(np.asarray(env.x_goal, np.float32)),
                     torch.tensor(np.asarray(env.u_goal, np.float32)))
    return A.double().numpy(), B.double().numpy(), m.dt


def _random_system(seed=0, n=5, m=2):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal((n, n)), rng.standard_normal((n, m)), 0.05


SYSTEMS = {
    "random": (lambda: _random_system(), 1e-4, 1e-4),
    "cartpole": (lambda: _linearized(tc.make_cartpole(tc.CartPoleConfig(), device="cpu")),
                 1e-5, 1e-5),
    "quad2d": (lambda: _linearized(tq.make_quadrotor(tq.QuadrotorConfig(quad_type=2),
                                                     device="cpu")), 5e-3, 1e-3),
    "quad3d": (lambda: _linearized(tq.make_quadrotor(tq.QuadrotorConfig(quad_type=3),
                                                     device="cpu")), 5e-3, 1e-3),
}


@pytest.fixture(scope="module", params=list(SYSTEMS))
def system(request):
    make, tol_p, tol_k = SYSTEMS[request.param]
    A, B, dt = make()
    n, m = B.shape
    Q, R = np.eye(n), 0.1 * np.eye(m)
    Ad, Bd = (x.numpy() for x in ti.discretize_linear_system(torch.tensor(A), torch.tensor(B), dt))
    return dict(cont=(A, B, Q, R), disc=(Ad, Bd, Q, R), tol_p=tol_p, tol_k=tol_k)


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def f32(mats):
    return [np.asarray(x, np.float32) for x in mats]


def port(fn, mats):
    out = fn(*[torch.tensor(x) for x in mats])
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


def jax_(fn, mats):
    out = fn(*map(jnp.asarray, mats))
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_riccati_matches_scipy_in_float64(system, kind):
    mats = system["disc" if kind == "discrete" else "cont"]
    fn, ref = ((tl.solve_discrete_are, sl.solve_discrete_are) if kind == "discrete" else
               (tl.solve_continuous_are, sl.solve_continuous_are))
    P = port(fn, mats)
    assert P.dtype == np.float64
    assert rel(P, ref(*mats)) < 1e-10


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_riccati_matches_jax_in_float32(system, kind):
    mats = system["disc" if kind == "discrete" else "cont"]
    tfn, jfn, ref = ((tl.solve_discrete_are, jl.solve_discrete_are, sl.solve_discrete_are)
                     if kind == "discrete" else
                     (tl.solve_continuous_are, jl.solve_continuous_are, sl.solve_continuous_are))
    P, Pj, Ps = port(tfn, f32(mats)), jax_(jfn, f32(mats)), ref(*mats)
    assert P.dtype == np.float32 and np.isfinite(P).all()
    assert rel(P, Pj) < system["tol_p"]
    assert rel(P, Ps) <= max(2 * rel(Pj, Ps), 1e-5)


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_lqr_gains_match_jax_and_scipy(system, kind):
    mats = system["disc" if kind == "discrete" else "cont"]
    tfn, jfn = (tl.dlqr_gain, jl.dlqr_gain) if kind == "discrete" else (tl.clqr_gain, jl.clqr_gain)
    (K, P), (Kj, _) = port(tfn, f32(mats)), jax_(jfn, f32(mats))
    assert K.shape == Kj.shape == mats[1].T.shape
    assert rel(K, Kj) < system["tol_k"]
    # float64: the gain of scipy's Riccati solution.
    A, B, Q, R = mats
    K64 = port(tfn, mats)[0]
    if kind == "discrete":
        Ps = sl.solve_discrete_are(*mats)
        Ks = np.linalg.solve(R + B.T @ Ps @ B, B.T @ Ps @ A)
    else:
        Ks = np.linalg.solve(R, B.T @ sl.solve_continuous_are(*mats))
    assert rel(K64, Ks) < 1e-10


def test_batched_equals_looped():
    """Leading batch dims: three systems in one batch, Q and R broadcast,
    each as it is solved alone."""
    systems = [_random_system(s) for s in range(3)]
    A = torch.tensor(np.stack([s[0] for s in systems]))
    B = torch.tensor(np.stack([s[1] for s in systems]))
    Q, R = torch.eye(5, dtype=torch.float64), 0.1 * torch.eye(2, dtype=torch.float64)
    for fn in (tl.solve_discrete_are, tl.solve_continuous_are):
        Pb = fn(A, B, Q, R)
        for i in range(3):
            assert rel(Pb[i].numpy(), fn(A[i], B[i], Q, R).numpy()) < 1e-6
    for fn in (tl.dlqr_gain, tl.clqr_gain):
        Kb, Pb = fn(A, B, Q, R)
        for i in range(3):
            K, P = fn(A[i], B[i], Q, R)
            assert rel(Kb[i].numpy(), K.numpy()) < 1e-6 and rel(Pb[i].numpy(), P.numpy()) < 1e-6


def test_care_float32_where_jax_overflows():
    """The 3D quadrotor's 24x24 Hamiltonian at Q = 100 I: its determinant
    (e^93.6) leaves the float32 range, and the JAX package's scaling by
    ``det`` turns the solution non-finite; the port's scaling by
    ``slogdet`` stays within 1e-5 of scipy."""
    A, B, _ = SYSTEMS["quad3d"][0]()
    mats = (A, B, 100.0 * np.eye(12), 0.1 * np.eye(4))
    assert not np.isfinite(jax_(jl.solve_continuous_are, f32(mats))).all()
    P = port(tl.solve_continuous_are, f32(mats))
    assert np.isfinite(P).all() and rel(P, sl.solve_continuous_are(*mats)) < 1e-5


def test_cost_weight_matrix_matches_jax():
    for w, dim in (([2.0], 3), ([1.0, 2.0, 3.0], 3), (0.5, 2)):
        np.testing.assert_array_equal(tl.get_cost_weight_matrix(w, dim),
                                      jl.get_cost_weight_matrix(w, dim))
    with pytest.raises(ValueError):
        tl.get_cost_weight_matrix([1.0, 2.0], 3)
