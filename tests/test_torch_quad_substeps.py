"""K1: the port's substep wrapper against the JAX package's Pallas kernel
(interpret mode), its launch plan against the CUDA source, and the CUDA
kernel against its plain version on a card."""

import ctypes
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch import kernels
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("group", tk.GROUPS)
def test_kernel_matches_plain_on_card(group, dtype):
    """At every group the source builds, both scalar types, RK4 and Euler,
    actuation on and off, and a ragged batch: bit-equal to the plain
    version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for B, euler, actuation in itertools.product((1000, 4096), (False, True), (False, True)):
        args = [torch.from_numpy(a).cuda().to(dtype) for a in _random_batch(B)]
        kw = dict(dt=DT, n_sub=N_SUB, euler=euler, actuation=actuation)
        before = tk.quad3d_substeps.launches
        out = tk.quad3d_substeps(*args, group=group, **kw)
        assert tk.quad3d_substeps.launches == before + 1
        ref = tk.quad3d_substeps_plain(*args, **kw)
        assert out.dtype == dtype and torch.equal(out, ref), (B, euler, actuation)


# What the CUDA source says: its entry points, its block limit and the
# groups its dispatch launches.
_SRC = (kernels.CSRC / "quad3d_substeps.cu").read_text()
_C_BLOCK = int(re.search(r"constexpr int BLOCK = (\d+);", _SRC).group(1))


def _c_params(name):
    """Each parameter type of the extern "C" entry ``name``."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", _SRC)
    assert m, name
    return [" ".join(arg.split()[:-1]) for arg in m.group(1).split(",")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("group", tk.GROUPS)
@pytest.mark.parametrize("B", [1, 33, 1000, 4096])
def test_launch_plan_covers_every_env_once(B, group, dtype):
    """Thread t of the plan's grid is lane t % G of env t // G; the envs
    below B are each one whole group, the lanes past them lie in the last
    block only, and one block fewer would leave envs out."""
    g, block, grid = tk.launch_plan(B, dtype, group)
    assert g == group
    env = np.arange(grid * block) // g
    assert np.array_equal(np.unique(env[env < B]), np.arange(B))
    assert np.all(np.bincount(env[env < B], minlength=B) == g)
    assert np.all(np.arange(grid * block)[env >= B] >= (grid - 1) * block)
    assert (grid - 1) * (block // g) < B


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 256, 1000, 4096, 16384, 65536, 1 << 22])
def test_launch_plan_fits_the_card(B, dtype):
    """Whole warps of whole groups, within the source's block limit and the
    card's grid; the plan's own group is one the source builds."""
    g, block, grid = tk.launch_plan(B, dtype)
    assert g in tk.GROUPS and 32 % g == 0
    assert block % 32 == 0 and 32 <= block <= min(_C_BLOCK, 1024)
    assert 1 <= grid <= 2**31 - 1 and grid * (block // g) >= B
    with pytest.raises(ValueError):
        tk.launch_plan(B, dtype, 3)


def test_launch_plan_mirrors_cuda_groups():
    """The groups the plan picks from are those the entries dispatch to,
    each launched in float and in double."""
    built = sorted(int(c) for c in re.findall(r"case (\d+):\s*return launch<T, \1>", _SRC))
    assert built == sorted(tk.GROUPS)
    assert set(tk.PLAN_MAX_B) == {torch.float32, torch.float64}
    for most in tk.PLAN_MAX_B.values():
        assert set(most) | {1} <= set(tk.GROUPS)
        # A wider group never runs at a larger batch than a narrower one.
        assert sorted(most, reverse=True) == sorted(most, key=most.get)
    assert re.search(r"return dispatch<float>\(", _SRC)
    assert re.search(r"return dispatch<double>\(", _SRC)


@pytest.mark.parametrize("name,scalar,c_scalar", [
    ("quad3d_substeps", ctypes.c_float, "float"),
    ("quad3d_substeps_f64", ctypes.c_double, "double")])
def test_ctypes_signature_mirrors_cuda_entry(name, scalar, c_scalar):
    """The ctypes argument types are the C entry's, parameter for parameter:
    six pointers, B, the scalars in the entry's type, the flags, the
    launch plan (group, block, grid) and the stream; version 2 is reported."""
    want = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            c_scalar: scalar}
    params = _c_params(name)
    assert [want[t] for t in params] == kernels._SIGNATURES[name]
    assert params[-4:] == ["int", "int", "int", "void*"]
    assert re.search(r'extern "C" int quad3d_substeps_api_version\(\) \{ return 2; \}', _SRC)
    assert kernels._SIGNATURES["quad3d_substeps_api_version"] == []
