"""K1: the port's substep wrapper against the JAX package's Pallas kernel
(interpret mode), and the CUDA kernel against its plain version on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.ops import quad_substeps as tk
from safe_control_gym_tpu.envs.quadrotor import KF, cmd2pwm, pwm2rpm, quad_fc_3d
from safe_control_gym_tpu.ops.integrators import rk4_step
from safe_control_gym_tpu.ops.pallas_quad import make_quad3d_integrator

DT, N_SUB = 1.0 / 240.0, 4


def _random_batch(B):
    """tests/test_pallas.py's _random_batch distributions, drawn with NumPy.
    As a thrust command (actuation on) the second input runs through the
    lower PWM clip (0.028 N); test_actuation_matches_env_pipeline covers
    both clip limits."""
    rng = np.random.default_rng(B)
    x = (rng.standard_normal((B, 12)) * 0.2).astype(np.float32)
    f = rng.uniform(0.02, 0.08, (B, 4)).astype(np.float32)
    ext = (rng.standard_normal((B, 3)) * 1e-3).astype(np.float32)
    m = np.full((B,), 0.027, np.float32)
    j = np.tile(np.array([1.4e-5, 1.4e-5, 2.17e-5], np.float32), (B, 1))
    return x, f, ext, m, j


def _primal(euler, actuation):
    def substeps(x, f, ext, m, j):
        if actuation:
            f = pwm2rpm(cmd2pwm(f, jnp.float32)) ** 2 * KF
        fc = lambda xx, uu: quad_fc_3d(xx, uu, m, j, ext)
        for _ in range(N_SUB):
            x = x + DT * fc(x, f) if euler else rk4_step(fc, x, f, DT)
        return x
    return substeps


@pytest.mark.parametrize("B,euler", [(256, False), (128, True)])
@pytest.mark.parametrize("actuation", [False, True])
def test_plain_matches_pallas_kernel(B, euler, actuation):
    args = _random_batch(B)
    integ = make_quad3d_integrator(_primal(euler, actuation), DT, N_SUB, euler=euler,
                                   actuation=actuation, force_pallas=True)
    ref = jax.jit(jax.vmap(integ))(*map(jnp.asarray, args))
    before = tk.quad3d_substeps.launches
    out = tk.quad3d_substeps(*map(torch.from_numpy, args), dt=DT, n_sub=N_SUB, euler=euler,
                             actuation=actuation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert tk.quad3d_substeps.launches == before


def test_actuation_matches_env_pipeline():
    t = np.linspace(-0.01, 0.2, 301).astype(np.float32)
    want = np.asarray(pwm2rpm(cmd2pwm(jnp.asarray(t)[:, None].repeat(4, 1),
                                      jnp.float32)) ** 2 * KF)[:, 0]
    np.testing.assert_allclose(tk.actuate(torch.from_numpy(t)).numpy(), want, rtol=1e-6)


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for euler in (False, True):
        args = [torch.from_numpy(a).cuda() for a in _random_batch(4096)]
        kw = dict(dt=DT, n_sub=N_SUB, euler=euler, actuation=True)
        before = tk.quad3d_substeps.launches
        out = tk.quad3d_substeps(*args, **kw)
        assert tk.quad3d_substeps.launches == before + 1
        ref = tk.quad3d_substeps_plain(*args, **kw)
        torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)
