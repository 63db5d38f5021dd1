"""The port's MPCC racing controller against the JAX package's.

- :func:`interp` (the port's ``jnp.interp``) against ``jnp.interp`` on a
  real plan's grid (level 2, the competition's planner settings): at every
  knot, between knots, a float32 step either side of each knot (no
  subnormal: XLA flushes them to zero) and beyond both ends, within 2.5e-7 of each column's largest entry (XLA contracts
  ``f0 + t * df`` into an FMA, the port rounds twice); its derivative in
  theta under ``vmap(jacfwd)`` against ``jax.grad`` at the same points
  (rtol 1e-5 relative to each column's largest slope);
- one cold solve (horizon 10, 1 x 2 iterations) on that plan from a state
  approaching gate 0, off the path, with gate 0 measured (the tight band)
  and the others at the unmeasured band, against the JAX package's
  ``_mpcc_solve``: states, inputs and cost within 2e-3, 2e-3 and 1e-4 of
  their largest entry.  Two planted faults fail those limits: the repulsion
  dropped (no frames, no obstacles) and one constraint row flipped;
- the counterpart of tests/test_competition.py:146-161 (progress along a
  straight segment over 10 solves);
- fault (c): after the frames change, the port's next solves run the cold
  iteration counts where the JAX package runs the warm ones.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_torch.competition import mpcc_controller as tm
from safe_control_gym_torch.competition.controller import Controller
from safe_control_gym_torch.competition.getting_started import _env_config_from_level, _reset_info
from safe_control_gym_torch.competition.planning import pmm_segment
from safe_control_gym_torch.competition.stage_actions import StageActionMPCC
from safe_control_gym_torch.envs.quadrotor import make_quadrotor
from safe_control_gym_torch.ops.ctr_prng import key_env_seed
from safe_control_gym_tpu.competition import mpcc_controller as jm

LEVELS = os.path.join(os.path.dirname(__file__), "..", "safe_control_gym_tpu", "competition",
                      "levels")
H, AL, INNER = 10, 1, 2


@pytest.fixture(scope="module")
def plan():
    """Level 2's flight plan (the port's planner, bit-equal to the JAX
    package's: tests/test_torch_competition_planning.py), its MPCC's
    arguments, and both packages' MPCC controllers on it."""
    with open(os.path.join(LEVELS, "level2.yaml")) as f:
        level = yaml.safe_load(f)["quadrotor_config"]
    env = make_quadrotor(_env_config_from_level(level, 25, 25), device="cpu")
    obs = env.reset(torch.full((1,), key_env_seed(2), dtype=torch.int32))[1][0].numpy()
    ctrl = Controller(obs, _reset_info(env, obs, 25), use_firmware=True, device="cpu")
    stage = next(s for s in ctrl.sequencer.stages if isinstance(s, StageActionMPCC))
    m = stage.mpcc
    kw = dict(gate_thetas=m.gate_thetas, gate_positions=m.gate_positions,
              obstacle_positions=m._obst_xy, gate_frames=m.frames0, theta_dot_max=1.0,
              horizon=H, al_iters=AL, inner_iters=INNER)
    return dict(traj=ctrl.flight_traj,
                port=tm.MPCCController(ctrl.flight_traj, 1 / 25, device="cpu", **kw),
                jax=jm.MPCCController(ctrl.flight_traj, 1 / 25, **kw))


def _points(grid):
    g = grid.astype(np.float32)
    up = np.nextafter(g, np.float32(np.inf))
    down = np.nextafter(g, np.float32(-np.inf))
    mid = (g[:-1] + g[1:]) / 2
    pts = np.concatenate([g, up, down, mid]).astype(np.float32)
    # No subnormals (the step below the knot at 0): XLA on the CPU flushes
    # them to zero, PyTorch does not.
    pts = pts[(pts == 0) | (np.abs(pts) >= np.finfo(np.float32).tiny)]
    return np.concatenate([pts, [-1.0, -1e-3, g[-1] + 1e-3, g[-1] + 2.0]]).astype(np.float32)


def test_interp_matches_jnp_interp_on_the_plan_grid(plan):
    p = plan["port"]
    grid = p.theta_grid
    table = p._tables["path"].numpy()
    xs = _points(grid)
    want = np.stack([np.asarray(jax.vmap(lambda x, c=c: jnp.interp(x, grid, table[:, c]))(xs))
                     for c in range(table.shape[1])], -1)
    got = torch.func.vmap(lambda x: tm.interp(x, torch.from_numpy(grid),
                                              torch.from_numpy(table)))(torch.from_numpy(xs))
    scale = np.abs(table).max(0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-7 * scale.max())
    assert np.all(np.abs(got.numpy() - want) <= 2.5e-7 * scale)
    # Beyond the ends: the end values exactly.
    np.testing.assert_array_equal(got.numpy()[-4:-2], np.stack([table[0]] * 2))
    np.testing.assert_array_equal(got.numpy()[-2:], np.stack([table[-1]] * 2))
    d_want = np.stack([np.asarray(jax.vmap(jax.grad(
        lambda x, c=c: jnp.interp(x, grid, table[:, c])))(xs)) for c in range(table.shape[1])],
        -1)
    d_got = torch.func.vmap(torch.func.jacfwd(
        lambda x: tm.interp(x, torch.from_numpy(grid), torch.from_numpy(table))))(
            torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(d_got, d_want, rtol=0, atol=1e-5 * np.abs(d_want).max(0).max())


def _problem(m):
    """x0 approaching gate 0 off the path, gate 0's frame measured (moved,
    tight band), the other gates unmeasured (nominal, wide band)."""
    theta = float(m.gate_thetas[0]) - 0.35
    p, v = m.reference_at(theta, 0.8)
    obs = np.zeros(12)
    obs[[0, 2, 4]] = p + np.array([0.06, -0.04, 0.05])
    obs[[1, 3, 5]] = v
    obs[6:9] = [0.05, -0.04, 0.02]
    frames = np.array(m.frames0, copy=True)
    frames[0] += [0.05, -0.04, 0.03, 0.0]
    bands = np.full(frames.shape[0], m.rep_band + m.fuzzy_extra, np.float32)
    bands[0] = m.rep_band
    x0 = np.concatenate([obs, np.full(4, m.hover), [theta, 0.8]]).astype(np.float32)
    return x0, frames.astype(np.float32), bands


def _jax_solve(m, x0, frames, bands):
    us0 = np.tile(np.array([0, 0, 0, 0, 1.0], np.float32), (H, 1))
    mu0 = np.zeros((H, tm.N_CONSTRAINTS), np.float32)
    xs, us, cost, _ = jm._mpcc_solve(m._tables, m._scal, jnp.asarray(x0), jnp.asarray(us0),
                                     jnp.asarray(mu0), jnp.asarray(frames), jnp.asarray(bands),
                                     al_iters=AL, inner_iters=INNER)
    return np.asarray(xs), np.asarray(us), float(cost)


def _port_solve(m, x0, frames, bands):
    us0 = torch.zeros((1, H, 5))
    us0[..., 4] = 1.0
    xs, us, cost, _ = tm._mpcc_solve(m._tables, m._scal, torch.from_numpy(x0)[None], us0,
                                     torch.zeros((1, H, tm.N_CONSTRAINTS)),
                                     torch.from_numpy(frames), torch.from_numpy(bands),
                                     al_iters=AL, inner_iters=INNER)
    return xs[0].numpy(), us[0].numpy(), float(cost[0])


LIMITS = (2e-3, 2e-3, 1e-4)  # states, inputs, cost: relative to their largest entry


def _errs(a, b):
    return tuple(float(np.abs(np.asarray(x) - np.asarray(y)).max() / max(np.abs(y).max(), 1e-12))
                 for x, y in zip(a, b))


@pytest.fixture(scope="module")
def solves(plan):
    x0, frames, bands = _problem(plan["jax"])
    return x0, frames, bands, _jax_solve(plan["jax"], x0, frames, bands)


def test_cold_solve_matches_jax(plan, solves):
    x0, frames, bands, want = solves
    got = _port_solve(plan["port"], x0, frames, bands)
    errs = _errs(got, want)
    assert all(np.isfinite(np.asarray(g)).all() for g in got)
    assert all(e <= lim for e, lim in zip(errs, LIMITS)), (errs, LIMITS)


def test_planted_faults_fail_the_limits(plan, solves, monkeypatch):
    x0, frames, bands, want = solves
    m = plan["port"]
    # The repulsion dropped: no frames, no obstacles.
    tables = dict(m._tables, obst_xy=torch.zeros((0, 2)))
    m_norep = type("M", (), {"_tables": tables, "_scal": m._scal})
    errs = _errs(_port_solve(m_norep, x0, np.zeros((0, 4), np.float32),
                             np.zeros(0, np.float32)), want)
    assert any(e > lim for e, lim in zip(errs, LIMITS)), ("repulsion dropped", errs)
    # One constraint row flipped (theta_dot <= max becomes >= max).
    real = tm.al_ilqr_solve
    flip = torch.ones(tm.N_CONSTRAINTS)
    flip[16] = -1.0

    def flipped(fd, stage, term, cfn, *a, **k):
        return real(fd, stage, term, lambda x, u: cfn(x, u) * flip, *a, **k)

    monkeypatch.setattr(tm, "al_ilqr_solve", flipped)
    errs = _errs(_port_solve(m, x0, frames, bands), want)
    assert any(e > lim for e, lim in zip(errs, LIMITS)), ("row flipped", errs)


def test_mpcc_solver_progresses():
    """tests/test_competition.py:146-161 on the port."""
    traj = pmm_segment([0, 0, 1], [0, 0, 0], [3, 0, 1], [0, 0, 0], np.array([-3.0, -3.0, -3.0]),
                       np.array([3.0, 3.0, 3.0]))
    mpcc = tm.MPCCController(traj, dt=0.04, horizon=15, inner_iters=6, device="cpu")
    obs = np.zeros(12)
    obs[4] = 1.0
    theta, theta_dot = 0.0, 0.0
    for _ in range(10):
        x_next, xs, theta, theta_dot = mpcc.solve(obs, theta, theta_dot)
        obs = x_next[:12]
    assert theta > 0.05, f"no progress: theta={theta}"
    assert np.isfinite(x_next).all() and xs.shape == (16, 18)


def test_fault_c_frames_change_restarts_cold_solves(plan, monkeypatch):
    """Eight warm-started solves on the nominal frames, then gate 0's frame
    is measured: the JAX package goes on with the warm 1 x 3 iterations, the
    port restarts with the cold 2 x 6 for the next eight solves."""
    seen = {"port": [], "jax": []}

    def j_stub(tables, scal, x0, us, mu, frames, bands, *, al_iters, inner_iters):
        seen["jax"].append((al_iters, inner_iters))
        return jnp.zeros((us.shape[0] + 1, 18)), us, jnp.zeros(()), mu

    def t_stub(tables, scal, x0, us, mu, frames, bands, *, al_iters, inner_iters):
        seen["port"].append((al_iters, inner_iters))
        return torch.zeros((1, us.shape[1] + 1, 18)), us, torch.zeros(1), mu

    monkeypatch.setattr(jm, "_mpcc_solve", j_stub)
    monkeypatch.setattr(tm, "_mpcc_solve", t_stub)
    kw = dict(gate_frames=plan["port"].frames0, gate_thetas=plan["port"].gate_thetas)
    mj = jm.MPCCController(plan["traj"], 1 / 25, **kw)
    mt = tm.MPCCController(plan["traj"], 1 / 25, device="cpu", **kw)
    frames = np.array(mt.frames0, copy=True)
    moved = frames.copy()
    moved[0, :2] += [0.05, -0.04]
    obs = np.zeros(12)
    for k in range(20):
        f = frames if k < 10 else moved
        for m in (mj, mt):
            m.solve(obs, 0.0, 0.0, frames=f)
    cold, warm = (2, 6), (1, 3)
    assert seen["jax"] == [cold] * 8 + [warm] * 12
    assert seen["port"] == [cold] * 8 + [warm] * 2 + [cold] * 8 + [warm] * 2
    # A change inside the tolerance does not restart the count.
    mt.solve(obs, 0.0, 0.0, frames=moved + 1e-4)
    assert seen["port"][-1] == warm and mt.last_iters == warm
