"""The port's sim2real tools (``competition/sim2real.py``) against the JAX
package's.

The NumPy parts (``load_flight_csv`` in both formats, ``align_trials``,
``average_runs``) are bit-equal.  The batched fit integrates K1's
derivative (its plain version here), the JAX fit ``envs/quadrotor.py::
quad_fc_3d``: the same physics in other operation orders (``zb*T/m``
against ``(zb*T + ext)*minv``, the gyroscopic term through ``jnp.cross``),
so the RMSEs agree to RMSE_RTOL, found on tests/test_sim2real.py's
synthetic flight (mass 0.031, kf 1.12, dt 1/60, 20% thrust noise) cut to
T = 30 over 64 candidates: 5e-6 relative seen, held at 1e-4.  A planted
fault (the thrust scale applied twice) is far outside it."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.competition import sim2real as ts
from safe_control_gym_tpu.competition import sim2real as js
from safe_control_gym_tpu.envs.quadrotor import J_DIAG, quad_fc_3d
from safe_control_gym_tpu.ops.integrators import rk4_step

RMSE_RTOL = 1e-4
N, T, DT = 64, 30, 1 / 60


def fake_trial(t0=0.0, n=100, hz=50.0, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = t0 + np.arange(n) / hz
    state = np.stack([np.sin(t), np.cos(t), t * 0.1], -1)
    return {"t": t, "state": state + noise * rng.standard_normal(state.shape)}


def test_align_and_average_bit_equal():
    trials = [fake_trial(t0=5.0 + 0.01 * i, n=100 - 3 * i, noise=0.01, seed=i) for i in range(4)]
    for hz in (None, 30.0):
        gj, sj = js.align_trials(trials, hz=hz)
        gt, st = ts.align_trials(trials, hz=hz)
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(st, sj)
        aj, at = js.average_runs(trials, hz=hz), ts.average_runs(trials, hz=hz)
        for k in ("t", "state", "std"):
            np.testing.assert_array_equal(at[k], aj[k])


def test_load_flight_csv_both_formats_bit_equal(tmp_path):
    p1 = tmp_path / "avg.csv"
    with open(p1, "w") as f:
        f.write("time,x,y,z,qx,qy,qz,qw\n")
        for i in range(5):
            f.write(f"{i * 0.1},{i * 0.01},0,1,0,0,0,1\n")
    dj, dt = js.load_flight_csv(str(p1)), ts.load_flight_csv(str(p1))
    assert dt["control"] is None and dt["state"].shape == (5, 7)
    np.testing.assert_array_equal(dt["t"], dj["t"])
    np.testing.assert_array_equal(dt["state"], dj["state"])

    from safe_control_gym_tpu.utils.drone_logger import DroneLogger

    log = DroneLogger(logging_freq_hz=50, duration_sec=0.1)
    rng = np.random.default_rng(0)
    for i in range(5):
        log.log(0, i / 50, rng.normal(size=16), rng.normal(size=12))
    log.save_as_csv("trial", str(tmp_path))
    csv = glob.glob(str(tmp_path / "trial_drone0.csv"))[0]
    dj, dt = js.load_flight_csv(csv), ts.load_flight_csv(csv)
    assert dt["state"].shape[1] == 16 and dt["control"].shape[1] == 12
    for k in ("t", "state", "control"):
        np.testing.assert_array_equal(dt[k], dj[k])


@pytest.fixture(scope="module")
def flight():
    """tests/test_sim2real.py's synthetic flight, cut to T steps."""
    true_mass, true_kf = 0.031, 1.12
    x0 = jnp.zeros(12).at[4].set(1.0)
    hover = true_mass * 9.8 / 4 / true_kf
    acts = hover * (1 + 0.2 * jax.random.normal(jax.random.key(0), (T, 4)))

    def body(x, u):
        fc = lambda xx, uu: quad_fc_3d(xx, uu * true_kf, true_mass,  # noqa: E731
                                       jnp.asarray(J_DIAG), jnp.zeros(3))
        x = rk4_step(fc, x, u, DT)
        return x, jnp.stack([x[0], x[2], x[4]])

    _, pos = jax.lax.scan(body, x0, acts)
    return np.array(pos), np.array(acts, np.float32), np.array(x0, np.float32)


def jax_rmse(masses, kf_scales, pos, acts, x0):
    """The JAX fit's vmap(rollout_rmse) (sim2real.py:111-121 of the JAX
    package) on given candidates."""
    j = jnp.asarray(J_DIAG, jnp.float32)

    def rollout_rmse(mass, kf_scale):
        def body(x, u):
            fc = lambda xx, uu: quad_fc_3d(xx, uu * kf_scale, mass, j,  # noqa: E731
                                           jnp.zeros(3, jnp.float32))
            x = rk4_step(fc, x, u, DT)
            return x, jnp.stack([x[0], x[2], x[4]])

        _, p = jax.lax.scan(body, jnp.asarray(x0), jnp.asarray(acts))
        return jnp.sqrt(jnp.mean(jnp.sum((p - jnp.asarray(pos, jnp.float32)) ** 2, axis=-1)))

    return np.asarray(jax.jit(jax.vmap(rollout_rmse))(jnp.asarray(masses), jnp.asarray(kf_scales)))


def jax_candidates(seed=0):
    k_m, k_kf = jax.random.split(jax.random.key(seed))
    return (np.array(jax.random.uniform(k_m, (N,), jnp.float32, 0.025, 0.045)),
            np.array(jax.random.uniform(k_kf, (N,), jnp.float32, 0.7, 1.3)))


def port_rmse(masses, kf_scales, pos, acts, x0):
    return ts.rollout_rmse(torch.from_numpy(masses), torch.from_numpy(kf_scales),
                           torch.from_numpy(pos.astype(np.float32)), torch.from_numpy(acts),
                           torch.from_numpy(x0), DT).numpy()


def test_rollout_rmse_matches_jax_and_picks_the_same_candidate(flight):
    pos, acts, x0 = flight
    masses, kfs = jax_candidates()
    want = jax_rmse(masses, kfs, pos, acts, x0)
    got = port_rmse(masses, kfs, pos, acts, x0)
    np.testing.assert_allclose(got, want, rtol=RMSE_RTOL)
    # The argmin, where the best is clear of the second by more than the
    # tolerance, and the JAX fit's own result on the same candidates.
    order = np.argsort(want)
    assert (want[order[1]] - want[order[0]]) > 2 * RMSE_RTOL * want[order[0]]
    assert int(np.argmin(got)) == int(order[0])
    fit = js.fit_quad3d_params(pos, acts, DT, x0, num_candidates=N, seed=0)
    assert fit["mass"] == float(masses[order[0]]) and fit["kf_scale"] == float(kfs[order[0]])
    np.testing.assert_allclose(float(got[order[0]]), fit["rmse"], rtol=RMSE_RTOL)


def test_a_planted_fault_fails_the_comparison(flight):
    """The thrust scale applied twice moves the RMSEs far outside the
    tolerance: the comparison is not vacuous."""
    pos, acts, x0 = flight
    masses, kfs = jax_candidates()
    want = jax_rmse(masses, kfs, pos, acts, x0)
    faulty = port_rmse(masses, kfs * kfs, pos, acts, x0)
    assert not np.allclose(faulty, want, rtol=RMSE_RTOL, atol=0)
    assert np.abs(faulty / want - 1).max() > 100 * RMSE_RTOL


def test_fit_recovers_the_flight_on_the_cpu(flight):
    """The port's fit (its own candidates, device="cpu") on the cut flight:
    the thrust/mass ratio of the best candidate within 5% of the truth, as
    tests/test_sim2real.py's bar; without ``device`` it wants a card."""
    pos, acts, x0 = flight
    fit = ts.fit_quad3d_params(pos, acts, DT, x0, num_candidates=2048, device="cpu")
    assert fit["candidates"] == 2048 and np.isfinite(fit["rmse"])
    assert abs(fit["kf_scale"] / fit["mass"] - 1.12 / 0.031) / (1.12 / 0.031) < 0.05, fit
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ts.fit_quad3d_params(pos, acts, DT, x0, num_candidates=8)
