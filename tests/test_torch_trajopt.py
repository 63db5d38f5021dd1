"""The port's batched iLQR / AL-iLQR (``ops/trajopt.py``) against the JAX
package's, in float64 in both packages (the JAX side under
``jax.enable_x64``), on a cart-pole with a quadratic tracking cost.

The JAX solver is ``vmap``ped over the problems; the port solves them as
one batch.  Tolerance: every output within 1e-8 of the largest entry of
JAX's (``REL``).

Written down, not loosened: once a problem has converged, every accept test
compares two costs that agree to the last place, and the two packages'
rounding decides some of them differently.  The trajectories, costs and
multipliers still agree at REL (~2e-9 at worst here), but the regularizer
``lamb``, which each decision multiplies or divides by ``lamb_factor``,
then differs by powers of ``lamb_factor`` in those problems (up to 10^4 in
the AL solves here).  So ``lamb`` is held at REL where no accept test is a
tie: the plain iLQR before convergence (``test_ilqr_matches_jax``) and in
every problem still moving (``test_ilqr_lamb_while_moving``), and the AL solves
at three inner iterations (``test_al_ilqr_lamb_before_convergence``); the
converged AL solves hold every other output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian

from safe_control_gym_torch.ops import trajopt as T
from safe_control_gym_tpu.ops import trajopt as J

REL = 1e-8
H, B, NX = 15, 4, 4
DT = 0.05


def cartpole_fd(xp):
    """One explicit-Euler step of a frictionless cart-pole, in ``xp`` (jnp
    or torch)."""
    def fd(x, u):
        v, th, w = x[..., 1], x[..., 2], x[..., 3]
        s, c = xp.sin(th), xp.cos(th)
        temp = (u[..., 0] + 0.05 * w**2 * s) / 1.1
        th_dd = (9.8 * s - c * temp) / (0.5 * (4.0 / 3.0 - 0.1 * c**2 / 1.1))
        x_dd = temp - 0.05 * th_dd * c / 1.1
        return x + DT * xp.stack([v, x_dd, w, th_dd], -1)

    return fd


def problem(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, NX)) * [0.3, 0.2, 0.2, 0.2]
    us0 = rng.normal(size=(B, H, 1)) * 0.5
    ref = rng.normal(size=(H + 1, NX)) * 0.05
    return x0, us0, ref


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-300))


def costs(ref, xp):
    """(stage_cost, term_cost): JAX's indexes ``ref`` by the stage index,
    the port's gets the stage's reference as its stage data."""
    Qw, Rw, Pw = 1.0, 0.1, 10.0
    if xp is jnp:
        refj = jnp.asarray(ref)

        def stage(x, u, k):
            dx = x - refj[k]
            return 0.5 * Qw * dx @ dx + 0.5 * Rw * u @ u
        term_ref = refj[H]
    else:
        def stage(x, u, x_ref):
            dx = x - x_ref
            return 0.5 * Qw * dx @ dx + 0.5 * Rw * u @ u
        term_ref = torch.as_tensor(ref[H])

    def term(x):
        dx = x - term_ref
        return 0.5 * Pw * dx @ dx

    return stage, term


def box(xp, lim=0.6, lo=None):
    """The input box -lo <= u <= lim (lo = lim by default)."""
    lo = lim if lo is None else lo

    def g(x, u):
        return xp.concatenate([u - lim, -u - lo])
    return g


def jax_ilqr(x0, us0, ref, iters):
    with jax.enable_x64():
        stage, term = costs(ref, jnp)
        out = jax.vmap(lambda a, b: J.ilqr_solve(cartpole_fd(jnp), stage, term, a, b,
                                                 iters=iters))(jnp.asarray(x0), jnp.asarray(us0))
        return jax.tree.map(np.asarray, out)


def port_ilqr(x0, us0, ref, iters):
    stage, term = costs(ref, torch)
    return T.ilqr_solve(cartpole_fd(torch), stage, term, torch.as_tensor(x0), torch.as_tensor(us0),
                        iters=iters, stage_data=torch.as_tensor(ref[None, :H]))


ILQR_FIELDS = ("xs", "us", "cost", "lamb")


def test_ilqr_matches_jax():
    x0, us0, ref = problem()
    want, got = jax_ilqr(x0, us0, ref, 4), port_ilqr(x0, us0, ref, 4)
    assert got.xs.shape == (B, H + 1, NX) and got.us.shape == (B, H, 1)
    assert got.xs.dtype == torch.float64
    for name in ILQR_FIELDS:
        assert rel(getattr(got, name).numpy(), getattr(want, name)) < REL, name
    # The solve improved every problem from its initial guess.
    assert np.all(want.lamb < 1.0)


def test_ilqr_at_convergence():
    """Ten iterations, past convergence (the costs stop moving after about
    seven): the trajectories and costs agree at REL.  Every accept test
    after convergence compares two costs equal to the last place, so
    ``lamb`` is not compared here (``test_ilqr_lamb_while_moving`` is)."""
    x0, us0, ref = problem()
    want, got = jax_ilqr(x0, us0, ref, 10), port_ilqr(x0, us0, ref, 10)
    for name in ("xs", "us", "cost"):
        assert rel(getattr(got, name).numpy(), getattr(want, name)) < REL, name


def test_ilqr_lamb_while_moving():
    """Ten iterations from three times ``problem()``'s start, where two
    problems are still moving: in every problem whose cost moved in the last
    three iterations, every output agrees at REL and ``lamb`` exactly.

    Written down, not loosened: in the two converged problems of this start
    a tie decided differently changes ``lamb`` by a power of ten, and the
    inputs of problem 0 then differ from JAX's by 1.2e-8 of the largest
    input, past REL."""
    x0, us0, ref = problem()
    x0 = x0 * 3.0
    want, got = jax_ilqr(x0, us0, ref, 10), port_ilqr(x0, us0, ref, 10)
    before = jax_ilqr(x0, us0, ref, 7)
    moved = np.abs(want.cost - before.cost) > 1e-13 * np.abs(want.cost)
    assert moved.sum() == 2
    for name in ILQR_FIELDS:
        assert rel(getattr(got, name).numpy()[moved], getattr(want, name)[moved]) < REL, name
    np.testing.assert_array_equal(got.lamb.numpy()[moved], want.lamb[moved])


def test_ilqr_batch_equals_one_at_a_time():
    x0, us0, ref = problem(1)
    whole = port_ilqr(x0, us0, ref, 5)
    for b in range(B):
        one = port_ilqr(x0[b:b + 1], us0[b:b + 1], ref, 5)
        for name in ILQR_FIELDS:
            assert rel(getattr(one, name)[0].numpy(), getattr(whole, name)[b].numpy()) < 1e-12


def jax_al(x0, us0, ref, mu0=None, stagewise_bounds=None, lim=0.6, lo=None, **kw):
    with jax.enable_x64():
        stage, term = costs(ref, jnp)
        if stagewise_bounds is None:
            cfn, sw = box(jnp, lim, lo), False
        else:
            bj = jnp.asarray(stagewise_bounds)

            def cfn(x, u, k):
                return jnp.concatenate([u - bj[k], -u - bj[k]])
            sw = True

        def one(a, b, m):
            return J.al_ilqr_solve(cartpole_fd(jnp), stage, term, cfn, a, b, mu0=m,
                                   stagewise=sw, **kw)

        if mu0 is None:
            out = jax.vmap(lambda a, b: one(a, b, None))(jnp.asarray(x0), jnp.asarray(us0))
        else:
            out = jax.vmap(one)(jnp.asarray(x0), jnp.asarray(us0), jnp.asarray(mu0))
        return jax.tree.map(np.asarray, out)


def port_al(x0, us0, ref, mu0=None, stagewise_bounds=None, lim=0.6, lo=None, **kw):
    stage, term = costs(ref, torch)
    refs = torch.as_tensor(ref[None, :H])
    if stagewise_bounds is None:
        cfn, sw, sd = box(torch, lim, lo), False, refs
    else:
        def cfn(x, u, s):
            return torch.cat([u - s[1], -u - s[1]])

        def stage_s(x, u, s, _stage=stage):
            return _stage(x, u, s[0])
        stage, sw = stage_s, True
        sd = (refs, torch.as_tensor(stagewise_bounds[None, :, None]))
    return T.al_ilqr_solve(cartpole_fd(torch), stage, term, cfn, torch.as_tensor(x0),
                           torch.as_tensor(us0), mu0=None if mu0 is None else torch.as_tensor(mu0),
                           stagewise=sw, stage_data=sd, **kw)


def al_case(case, **kw):
    """JAX's and the port's AL solve of one case: ``(want, got)``, each
    ``(ILQRResult, mu)``.  ``tie`` starts on the constraint's boundary (u = 0
    with u <= 0, mu = 0), so that every stage's upper-bound penalty sits at
    its tie at the first linearization."""
    if case == "tie":
        x0, _, ref = problem(4)
        args = (x0, np.zeros((B, H, 1)), ref)
        kw = dict(kw, lim=0.0, lo=5.0, rho_init=5.0)
    else:
        x0, us0, ref = problem(2)
        x0 = x0 * 3.0  # far enough out that the input box binds
        mu0 = np.abs(np.random.default_rng(3).normal(size=(B, H, 2))) if "mu0" in case else None
        bounds = np.linspace(0.9, 0.4, H) if case.startswith("stagewise") else None
        args = (x0, us0, ref, mu0, bounds)
    return jax_al(*args, **kw), port_al(*args, **kw)


@pytest.mark.parametrize("case", ["plain", "mu0", "stagewise", "stagewise-mu0"])
def test_al_ilqr_matches_jax(case):
    (wres, wmu), (gres, gmu) = al_case(case)
    assert gmu.shape == (B, H, 2)
    for name in ("xs", "us", "cost"):
        assert rel(getattr(gres, name).numpy(), getattr(wres, name)) < REL, (case, name)
    assert rel(gmu.numpy(), wmu) < REL
    assert wmu.max() > 0  # some constraint was active


@pytest.mark.parametrize("case", ["plain", "mu0", "stagewise", "stagewise-mu0", "tie"])
def test_al_ilqr_lamb_before_convergence(case):
    """Three inner iterations, before any accept test is a tie: every
    output, ``lamb`` included, agrees at REL."""
    (wres, wmu), (gres, gmu) = al_case(case, inner_iters=3)
    for name in ILQR_FIELDS:
        assert rel(getattr(gres, name).numpy(), getattr(wres, name)) < REL, (case, name)
    assert rel(gmu.numpy(), wmu) < REL


def test_al_without_constraints_is_ilqr():
    x0, us0, ref = problem()
    stage, term = costs(ref, torch)
    res, mu = T.al_ilqr_solve(cartpole_fd(torch), stage, term, None, torch.as_tensor(x0),
                              torch.as_tensor(us0), al_iters=2, inner_iters=2,
                              stage_data=torch.as_tensor(ref[None, :H]))
    assert mu is None
    want = jax_ilqr(x0, us0, ref, 4)
    for name in ILQR_FIELDS:
        assert rel(getattr(res, name).numpy(), getattr(want, name)) < REL, name


def test_al_penalty_splits_the_derivative_at_a_tie():
    """max(0, mu/rho + c) at exactly 0: ``jnp.maximum`` and the port's
    ``torch.maximum`` against a zero tensor split the derivative (the
    penalty's second derivative is rho/4 there); ``clamp`` would give rho."""
    rho = 50.0

    def cfn(x, u, k):
        return u - 0.0
    aug = T.al_stage_cost(lambda x, u, k: 0.0 * (x @ x), cfn, rho)
    x, u = torch.zeros(NX, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
    mu = torch.zeros(1, dtype=torch.float64)
    h_port = hessian(aug, argnums=1)(x, u, (torch.zeros(()), mu))
    with jax.enable_x64():
        def pen(u):
            viol = jnp.maximum(0.0, 0.0 / rho + u)
            return 0.5 * rho * jnp.sum(viol**2)
        h_jax = np.asarray(jax.hessian(pen)(jnp.zeros(1)))
    np.testing.assert_array_equal(h_port.numpy(), h_jax)
    assert float(h_jax[0, 0]) == rho / 4


def test_al_ilqr_from_an_exact_tie_matches_jax():
    """A solve that starts on the constraint's boundary (``al_case``'s
    ``tie``)."""
    (wres, wmu), (gres, gmu) = al_case("tie")
    for name in ("xs", "us", "cost"):
        assert rel(getattr(gres, name).numpy(), getattr(wres, name)) < REL, name
    assert rel(gmu.numpy(), wmu) < REL
