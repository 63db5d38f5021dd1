"""The port's model-based base against the JAX package's on the same NumPy
inputs: the rest of ``ops/rotations.py``, ``ops/integrators.py``'s
``substeps``, ``discretize`` and ``discretize_linear_system`` (both
branches), and ``env.symbolic`` (``models/dynamics_model.py``) of CartPole
and of the 1D, 2D and 3D quadrotors: ``fc``, its Jacobians, the RK4 step
and its Jacobians, the quadratic loss and the batched forms.

Tolerance: the JAX suite's state tolerance, rtol 2e-4 / atol 2e-5
(``tests/test_fast_env.py:85``): float32 on both sides, the Jacobians by
forward-mode AD in both; the differences are the last places of sin, cos,
tan and of the matrix exponential."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.models.dynamics_model import DynamicsModel
from safe_control_gym_torch.ops import integrators as ti
from safe_control_gym_torch.ops import rotations as tr
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import integrators as ji
from safe_control_gym_tpu.ops import rotations as jr

RTOL, ATOL = 2e-4, 2e-5
T = torch.from_numpy


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z"])
def test_single_axis_rotations_match_jax(name):
    a = np.random.default_rng(0).uniform(-3.0, 3.0, (4, 16)).astype(np.float32)
    close(getattr(tr, name)(T(a)).numpy(), getattr(jr, name)(jnp.asarray(a)))


def test_euler_jacobian_and_unit_vector_match_jax():
    rng = np.random.default_rng(1)
    phi, theta = rng.uniform(-1.2, 1.2, (2, 64)).astype(np.float32)
    close(tr.euler_jacobian(T(phi), T(theta)).numpy(), jr.euler_jacobian(phi, theta))
    v = rng.standard_normal((32, 3)).astype(np.float32)
    for axis, eps in ((-1, 0.0), (0, 1e-3)):
        close(tr.unit_vector(T(v), axis=axis, eps=eps).numpy(), jr.unit_vector(v, axis=axis,
                                                                             eps=eps))


# The env of each family on both packages, with a state and input near its
# operating point.
FAMILIES = {
    "cartpole": (lambda: jc.make_cartpole(jc.CartPoleConfig()),
                 lambda: tc.make_cartpole(tc.CartPoleConfig(), device="cpu")),
    "quad1d": (lambda: jq.make_quadrotor(jq.QuadrotorConfig(quad_type=1)),
               lambda: tq.make_quadrotor(tq.QuadrotorConfig(quad_type=1), device="cpu")),
    "quad2d": (lambda: jq.make_quadrotor(jq.QuadrotorConfig(quad_type=2)),
               lambda: tq.make_quadrotor(tq.QuadrotorConfig(quad_type=2), device="cpu")),
    "quad3d": (lambda: jq.make_quadrotor(jq.QuadrotorConfig(quad_type=3)),
               lambda: tq.make_quadrotor(tq.QuadrotorConfig(quad_type=3), device="cpu")),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jmake, tmake = FAMILIES[request.param]
    jenv, tenv = jmake(), tmake()
    m = tenv.symbolic
    rng = np.random.default_rng(2)
    u0 = np.asarray(tenv.u_goal, np.float32)
    xs = (rng.standard_normal((8, m.nx)) * 0.3).astype(np.float32)
    us = (u0 * (1.0 + 0.2 * rng.uniform(-1, 1, (8, m.nu))) + 0.1 * (u0 == 0)
          * rng.standard_normal((8, m.nu))).astype(np.float32)
    return request.param, jenv.symbolic, m, xs, us


def test_symbolic_shape_and_timing(family):
    name, jm, tm, _, _ = family
    assert isinstance(tm, DynamicsModel)
    assert (tm.nx, tm.nu, tm.ny) == (jm.nx, jm.nu, jm.ny)
    assert tm.dt == pytest.approx(jm.dt)


def test_symbolic_fc_and_jacobians_match_jax(family):
    _, jm, tm, xs, us = family
    j_df, j_fdl, j_dg = jax.jit(jm.df_func), jax.jit(jm.fd_linear_func), jax.jit(jm.dg_func)
    for x, u in zip(xs[:2], us[:2]):
        close(tm.fc_func(T(x), T(u)).numpy(), jm.fc_func(x, u))
        for got, want in zip(tm.df_func(T(x), T(u)), j_df(x, u)):
            assert got.dtype == torch.float32
            close(got.numpy(), want)
        for got, want in zip(tm.fd_linear_func(T(x), T(u)), j_fdl(x, u)):
            close(got.numpy(), want)
        for got, want in zip(tm.dg_func(T(x), T(u)), j_dg(x, u)):
            close(got.numpy(), want)
        close(tm.fd_func(T(x), T(u), dt=0.01).numpy(), jm.fd_func(x, u, dt=0.01))
    x_eq, u_eq = 0.5 * xs[0], us[0]
    close(tm.fc_linear(T(xs[0]), T(us[0]), T(x_eq), T(u_eq)).numpy(),
          jm.fc_linear(xs[0], us[0], x_eq, u_eq))


def test_symbolic_batched_forms_match_jax(family):
    _, jm, tm, xs, us = family
    for got, want in zip(tm.batch_linearize(T(xs), T(us)), jax.jit(jm.batch_linearize)(xs, us)):
        assert got.shape == want.shape
        close(got.numpy(), want)
    close(tm.batch_fd(T(xs), T(us)).numpy(), jax.jit(jm.batch_fd)(xs, us))
    # The batched forms are the per-state ones stacked.
    A0, B0 = tm.df_func(T(xs[3]), T(us[3]))
    A, B = tm.batch_linearize(T(xs), T(us))
    np.testing.assert_allclose(A[3].numpy(), A0.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(B[3].numpy(), B0.numpy(), rtol=1e-6, atol=1e-7)


def test_symbolic_loss_matches_jax(family):
    _, jm, tm, xs, us = family
    nx, nu = tm.nx, tm.nu
    rng = np.random.default_rng(3)
    Q = np.diag(rng.uniform(0.5, 2.0, nx)).astype(np.float32)
    R = np.diag(rng.uniform(0.05, 0.5, nu)).astype(np.float32)
    args = (xs[0], us[0], xs[1], us[1], Q, R)
    got = tm.loss(*map(T, args))
    want = jm.loss(*map(jnp.asarray, args))
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k])


@pytest.mark.parametrize("n", [3, 12], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_substeps_and_discretize_match_jax(family, method, n):
    """The JAX package unrolls up to 8 substeps and scans past them; the
    port loops."""
    _, jm, tm, xs, us = family
    jstep = ji.rk4_step if method == "rk4" else ji.euler_step
    tstep = ti.rk4_step if method == "rk4" else ti.euler_step
    close(ti.substeps(tstep, tm.fc_func, T(xs[0]), T(us[0]), 0.002, n).numpy(),
          ji.substeps(jstep, jm.fc_func, jnp.asarray(xs[0]), jnp.asarray(us[0]), 0.002, n))
    fd_t, fd_j = ti.discretize(tm.fc_func, 0.02, method), ji.discretize(jm.fc_func, 0.02, method)
    close(fd_t(T(xs[1]), T(us[1])).numpy(), fd_j(xs[1], us[1]))


def test_discretize_refuses_an_unknown_method():
    with pytest.raises(ValueError):
        ti.discretize(lambda x, u: x, 0.1, "midpoint")


@pytest.mark.parametrize("exact", [False, True], ids=["euler", "matrix-exponential"])
def test_discretize_linear_system_matches_jax(family, exact):
    _, jm, tm, xs, us = family
    A, B = (np.array(m) for m in tm.df_func(T(xs[0]), T(us[0])))
    got = ti.discretize_linear_system(T(A), T(B), tm.dt, exact=exact)
    want = ji.discretize_linear_system(jnp.asarray(A), jnp.asarray(B), jm.dt, exact=exact)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    # Batched: each matrix of a batch as it is alone.
    Ab, Bb = ti.discretize_linear_system(T(np.stack([A, 2 * A])), T(np.stack([B, B])), tm.dt,
                                         exact=exact)
    np.testing.assert_allclose(Ab[0].numpy(), got[0].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(Bb[0].numpy(), got[1].numpy(), rtol=1e-6, atol=1e-7)


def test_exact_discretization_is_the_matrix_exponential():
    """In float64 the exact branch of a double integrator is the closed form
    (Ad = [[1, dt], [0, 1]], Bd = [dt^2 / 2, dt])."""
    A = torch.tensor([[0.0, 1.0], [0.0, 0.0]], dtype=torch.float64)
    B = torch.tensor([[0.0], [1.0]], dtype=torch.float64)
    dt = 0.1
    Ad, Bd = ti.discretize_linear_system(A, B, dt, exact=True)
    np.testing.assert_allclose(Ad.numpy(), [[1.0, dt], [0.0, 1.0]], rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(Bd.numpy(), [[dt * dt / 2], [dt]], rtol=1e-14, atol=1e-15)


def test_symbolic_uses_nominal_parameters():
    """The model runs on the nominal inertia whatever the randomization, and
    the 2D model's thrusts act as motors (T1, T2, 0, 0): a pure thrust
    difference turns the body about y only."""
    cfg = tq.QuadrotorConfig(quad_type=2, inertial_prop={"M": 0.05, "Iyy": 2.0e-5},
                             randomized_inertial_prop=True)
    m = tq.make_quadrotor(cfg, device="cpu").symbolic
    x = torch.zeros(6)
    f = m.fc_func(x, torch.tensor([0.3, 0.3]))
    assert float(f[3]) == pytest.approx(0.6 / 0.05 - 9.8, rel=1e-6)
    f = m.fc_func(x, torch.tensor([0.0, 1.0e-3]))
    assert float(f[1]) == 0.0 and float(f[5]) > 0.0
