"""Numerical fidelity of the port's float64 envs: the port's general engine
(``envs/quadrotor.py``, ``envs/cartpole.py``) against the NumPy oracle
(``tests/oracles/numpy_reference.py``) at 1e-12, with the settings of the
JAX package's own oracle tests (``tests/test_dynamics.py``): 30 control
steps of the 1D, 2D and 3D quads and 100 of CartPole, randomized inertia and
initial state, no disturbances.

A float64 3D batch takes K1's plain version on the CPU and K1's float64
instance on a card (``ops/quad_substeps.py::quad3d_substeps``); the last
tests check that instance's entry point against the CUDA source, and on a
card against the oracle."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.ops import quad_substeps as K1

sys.path.insert(0, os.path.dirname(__file__))
from oracles import numpy_reference as oracle  # noqa: E402


def _quad_cfg(quad_type, dtype=torch.float64):
    return tq.QuadrotorConfig(
        quad_type=quad_type, ctrl_freq=60, pyb_freq=240, episode_len_sec=2,
        task="stabilization", cost="quadratic", randomized_init=True,
        randomized_inertial_prop=True, done_on_out_of_bound=False, dtype=dtype)


def _quad_rollout(quad_type, device, dtype=torch.float64):
    """30 steps of one quad (float64 unless ``dtype``) from env seed 42:
    (states (31, 12 or fewer), thrusts (30, nu), mass, inertia diagonal)."""
    nu = {1: 1, 2: 2, 3: 4}[quad_type]
    env = tq.make_quadrotor(_quad_cfg(quad_type, dtype), device=device)
    state, _, _ = env.reset(torch.tensor([42], dtype=torch.int32))
    mass = float(state.mass[0])
    j_diag = state.j_diag[0].cpu().numpy()
    T = 30
    rng = np.random.default_rng(7)
    thrusts = mass * 9.8 / nu * (1.0 + 0.05 * rng.standard_normal((T, nu)))
    # Inside the action bounds, so the env's clip leaves the oracle's input.
    thrusts = np.clip(thrusts, env.spaces.action_low, env.spaces.action_high)
    xs = [state.x[0].cpu().numpy()]
    for t in range(T):
        state, _, _, _, _ = env.step(state, torch.tensor(thrusts[t][None], dtype=dtype))
        xs.append(state.x[0].cpu().numpy())
    return np.stack(xs), thrusts, mass, j_diag


@pytest.mark.parametrize("quad_type", [1, 2, 3])
def test_quadrotor_env_trajectory_matches_oracle(quad_type):
    got, thrusts, mass, j_diag = _quad_rollout(quad_type, "cpu")
    assert got.dtype == np.float64
    want = oracle.quad_rollout(quad_type, got[0], thrusts, 1.0 / 240, 4, mass, j_diag)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cartpole_env_trajectory_matches_oracle():
    env = tc.make_cartpole(tc.CartPoleConfig(
        ctrl_freq=50, pyb_freq=50, episode_len_sec=5, task="stabilization", cost="quadratic",
        randomized_init=True, randomized_inertial_prop=True, done_on_out_of_bound=False,
        dtype=torch.float64), device="cpu")
    state, _, _ = env.reset(torch.tensor([3], dtype=torch.int32))
    pl, pm, cm = (float(v[0]) for v in (state.pole_length, state.pole_mass, state.cart_mass))
    T = 100
    forces = np.random.default_rng(5).uniform(-5, 5, size=(T, 1))
    xs = [state.x[0].numpy()]
    for t in range(T):
        state, _, _, _, _ = env.step(state, torch.tensor(forces[t][None], dtype=torch.float64))
        xs.append(state.x[0].numpy())
    got = np.stack(xs)
    assert got.dtype == np.float64
    want = oracle.cartpole_rollout(got[0], forces, 0.02, 1, pl, pm, cm)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_k1_float64_entry_mirrors_cuda_source():
    """K1's float64 entry point exists in the CUDA source with the float32
    entry's arguments, its scalars in double, as its ctypes signature says;
    both end in the launch plan (group, block, grid) and the stream."""
    import ctypes

    from safe_control_gym_torch import kernels

    src = (kernels.CSRC / "quad3d_substeps.cu").read_text()

    def params(name):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        return [arg.split()[-2] for arg in m.group(1).split(",")]  # each type

    f32, f64 = params("quad3d_substeps"), params("quad3d_substeps_f64")
    assert f64 == [{"float": "double"}.get(t, t) for t in f32] and "double" in f64
    assert f32[-4:] == ["int", "int", "int", "void*"]
    sig32 = kernels._SIGNATURES["quad3d_substeps"]
    sig64 = kernels._SIGNATURES["quad3d_substeps_f64"]
    assert len(sig64) == len(f64) == len(sig32)
    for c_type, t32, t64 in zip(f64, sig32, sig64):
        assert (t64 is ctypes.c_double) == (c_type == "double")
        assert t64 is (ctypes.c_double if t32 is ctypes.c_float else t32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("group", K1.GROUPS)
def test_float64_3d_env_steps_on_card_through_k1(group, dtype, monkeypatch):
    """On a card a 3D env steps through K1 (one launch a step) at every
    group the source builds, a float64 env through K1's float64 instance:
    its states are bit-equal to the same env's on the card through K1's
    plain version, and a float64 env stays within 1e-12 of the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's instances run only there")
    monkeypatch.setattr(K1, "plan_group", lambda B, dtype=None: group)
    before = K1.quad3d_substeps.launches
    got, thrusts, mass, j_diag = _quad_rollout(3, "cuda", dtype)
    assert K1.quad3d_substeps.launches == before + len(thrusts)
    assert got.dtype == {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    monkeypatch.setattr(tq, "quad3d_substeps", K1.quad3d_substeps_plain)
    plain, _, _, _ = _quad_rollout(3, "cuda", dtype)
    np.testing.assert_array_equal(got, plain)
    if dtype == torch.float64:
        want = oracle.quad_rollout(3, got[0], thrusts, 1.0 / 240, 4, mass, j_diag)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
