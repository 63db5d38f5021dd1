"""The port's integrators, rotations and reference trajectories against the
JAX package's, on the same NumPy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import benchmark as tbm
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import integrators as ti
from safe_control_gym_torch.ops import rotations as tr
from safe_control_gym_tpu.envs import benchmark as jbm
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.ops import integrators as ji
from safe_control_gym_tpu.ops import rotations as jr

DT = 1.0 / 240.0
# Config 4's projection plane (bench.py build()).
PROJ_POINT, PROJ_NORMAL = [0, 0, 0.5], [0, 1, 1]


def _batch(B=256, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, 12)) * 0.2).astype(np.float32)
    f = rng.uniform(0.02, 0.08, (B, 4)).astype(np.float32)
    ext = (rng.standard_normal((B, 3)) * 1e-3).astype(np.float32)
    m = np.full(B, 0.027, np.float32)
    j = np.tile(np.array([1.4e-5, 1.4e-5, 2.17e-5], np.float32), (B, 1))
    return x, f, ext, m, j


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_integrator_step_on_quad_dynamics(method):
    """One integrator step of the 3D rigid body: same op order in both
    packages; differences are float32 rounding of sin/cos/tan (atol as the
    JAX suite's substep tolerance)."""
    x, f, ext, m, j = _batch()
    jstep = ji.rk4_step if method == "rk4" else ji.euler_step
    tstep = ti.rk4_step if method == "rk4" else ti.euler_step
    ref = jstep(lambda xx, uu: jq.quad_fc_3d(xx, uu, jnp.asarray(m), jnp.asarray(j),
                                             jnp.asarray(ext)),
                jnp.asarray(x), jnp.asarray(f), DT)
    T = torch.from_numpy
    out = tstep(lambda xx, uu: tq.quad_fc_3d(xx, uu, T(m), T(j), T(ext)), T(x), T(f), DT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_rotations_match():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1.5, 1.5, (3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tr.rot_xyz(*map(torch.from_numpy, a)).numpy(), np.asarray(jr.rot_xyz(*a)), atol=1e-6)
    np.testing.assert_allclose(
        tr.body_z_world(*map(torch.from_numpy, a)).numpy(),
        np.asarray(jr.body_z_world(*a)), atol=1e-6)


def test_projection_and_transform_match():
    np.testing.assert_allclose(tr.projection_matrix(PROJ_POINT, PROJ_NORMAL),
                               jr.projection_matrix(PROJ_POINT, PROJ_NORMAL), rtol=1e-15)
    pos, vel, _ = jbm.generate_trajectory("figure8", 6.0, 1, "xy", (0.0, 0.0), 1.0, 1 / 60)
    tp_, tv_ = tr.transform_trajectory(pos, vel, PROJ_POINT, PROJ_NORMAL)
    jp_, jv_ = jr.transform_trajectory(pos, vel, PROJ_POINT, PROJ_NORMAL)
    np.testing.assert_allclose(tp_, np.asarray(jp_), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tv_, np.asarray(jv_), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("traj_type", ["figure8", "circle", "square"])
def test_generate_trajectory_matches(traj_type):
    kw = dict(traj_type=traj_type, traj_length=6.0, num_cycles=2, traj_plane="zx",
              position_offset=(0.5, 0.0), scaling=-0.5, sample_time=1 / 60)
    for got, want in zip(tbm.generate_trajectory(**kw), jbm.generate_trajectory(**kw)):
        np.testing.assert_array_equal(got, want)


def test_generate_trajectory_rejects_bad_args():
    with pytest.raises(ValueError):
        tbm.generate_trajectory(traj_type="spiral")
    with pytest.raises(ValueError):
        tbm.generate_trajectory(traj_plane="xx")
    with pytest.raises(ValueError):
        tbm.check_timing(250, 60)
    assert tbm.check_timing(240, 60) == 4
