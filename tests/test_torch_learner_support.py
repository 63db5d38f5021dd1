"""The learners' support modules of the port against the JAX package's on the
same seeded NumPy inputs: ``normalize_angle``, ``RescaleNormalizer`` and
``ActionUnnormalizer`` (``models/normalization.py``), the schedules
(``models/schedule.py``) exactly; the Gaussian and Ornstein-Uhlenbeck
processes (``models/random_processes.py``) with the JAX package's normals
replayed over 50 steps, at float32 rounding (rtol 1e-6, atol 1e-7: both
sides compute in float32, the JAX one op by op); the ring
``ReplayBuffer`` (``controllers/buffers.py``): pushes across the wrap and a
sample with the JAX package's indices, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers.buffers import ReplayBuffer as TBuffer
from safe_control_gym_torch.models import normalization as tn
from safe_control_gym_torch.models import random_processes as trp
from safe_control_gym_torch.models import schedule as ts
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers.buffers import ReplayBuffer as JBuffer
from safe_control_gym_tpu.models import normalization as jn
from safe_control_gym_tpu.models import random_processes as jrp
from safe_control_gym_tpu.models import schedule as js

RNG = np.random.default_rng(0)


def test_normalize_angle_exact():
    x = (RNG.normal(size=4096) * 20).astype(np.float32)
    x[:5] = [np.pi, -np.pi, 3 * np.pi, 0.0, -7 * np.pi]
    want = np.asarray(jn.normalize_angle(jnp.asarray(x)))
    got = tn.normalize_angle(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -np.pi and got.max() < np.pi
    np.testing.assert_array_equal(tn.normalize_angle(x.astype(np.float64)),
                                  jn.normalize_angle(x.astype(np.float64)))


def test_rescale_and_action_unnormalizer_exact():
    x = RNG.normal(size=(64, 3)).astype(np.float32)
    jout, _ = jn.RescaleNormalizer(coef=0.37)(jnp.asarray(x))
    tout, norm = tn.RescaleNormalizer(coef=0.37)(torch.from_numpy(x))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert isinstance(norm, tn.RescaleNormalizer)
    lo = np.array([-2.0, 0.1, -0.3], np.float32)
    hi = np.array([3.0, 0.7, 0.3], np.float32)
    a = (1.5 * RNG.normal(size=(64, 3))).astype(np.float32)  # outside [-1, 1] too
    want = np.asarray(jn.ActionUnnormalizer(low=jnp.asarray(lo), high=jnp.asarray(hi))(
        jnp.asarray(a)))
    got = tn.ActionUnnormalizer(torch.from_numpy(lo), torch.from_numpy(hi))(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["python-step", "int32-step"])
def test_schedules_exact(as_tensor):
    for step in range(12):
        jstep = jnp.asarray(step, jnp.int32) if as_tensor else step
        tstep = torch.tensor(step, dtype=torch.int32) if as_tensor else step
        for jsch, tsch in ((js.ConstantSchedule(0.3), ts.ConstantSchedule(0.3)),
                           (js.LinearSchedule(1.0, 0.1, 7), ts.LinearSchedule(1.0, 0.1, 7)),
                           (js.LinearSchedule(0.2, 0.9, 0), ts.LinearSchedule(0.2, 0.9, 0))):
            want, got = np.asarray(jsch(jstep)), tsch(tstep)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_gaussian_noise_replayed():
    jproc = jrp.make_action_noise_process({"func": "gaussian", "std": 0.3}, (4, 2))
    tproc = trp.make_action_noise_process({"func": "gaussian", "std": 0.3}, (4, 2))
    for i in range(50):
        k = jax.random.fold_in(jax.random.key(0), i)
        want, jproc = jproc.sample(k, (4, 2))
        eps = np.array(jax.random.normal(k, (4, 2)))
        got, tproc = tproc.sample(None, (4, 2), eps=torch.from_numpy(eps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_ou_noise_replayed_over_50_steps():
    """The OU state carried over 50 steps with the JAX package's normals, at
    float32 rounding; the state is never reset, and the port's parameters
    are float32."""
    spec = {"func": "ou", "mu": 0.1, "theta": 0.15, "sigma": 0.2, "dt": 1e-2}
    jproc = jrp.make_action_noise_process(spec, (4, 3))
    tproc = trp.make_action_noise_process(spec, (4, 3))
    assert tproc.dt.dtype == torch.float32
    for i in range(50):
        k = jax.random.fold_in(jax.random.key(1), i)
        want, jproc = jproc.sample(k)
        eps = np.array(jax.random.normal(k, (4, 3), jnp.float32))
        got, tproc = tproc.sample(None, eps=torch.from_numpy(eps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tproc.x.numpy(), np.asarray(jproc.x), rtol=1e-6, atol=1e-7)
    assert np.abs(tproc.x.numpy()).max() > 0.05
    assert float(tproc.reset().x.abs().max()) == 0.0
    with pytest.raises(ValueError):
        trp.make_action_noise_process({"func": "pink"}, (1,))


def test_replay_buffer_push_wrap_and_sample_exact():
    specs = {"obs": (3,), "act": (2,), "rew": (), "mask": ()}
    cap, B = 10, 4
    jbuf = JBuffer.create(cap, specs)
    tbuf = TBuffer(cap, specs)
    for i in range(5):  # 20 rows through a ring of 10: wraps at pushes 3 and 5
        batch = {k: RNG.normal(size=(B,) + s).astype(np.float32) for k, s in specs.items()}
        jbuf = jbuf.push({k: jnp.asarray(v) for k, v in batch.items()})
        tbuf.push({k: torch.from_numpy(v) for k, v in batch.items()})
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        for k in specs:
            np.testing.assert_array_equal(tbuf.data[k].numpy(), np.asarray(jbuf.data[k]))
    key = jax.random.key(3)
    want = jbuf.sample(key, 32)
    idx = np.asarray(jax.random.randint(key, (32,), 0, jnp.maximum(jbuf.size, 1)))
    got = tbuf.sample(None, 32, idx=torch.from_numpy(idx).long())
    for k in specs:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # Its own draws stay inside the filled rows.
    own = TBuffer(cap, specs)
    own.push({k: torch.ones((3,) + s) for k, s in specs.items()})
    drawn = own.sample(torch.Generator().manual_seed(0), 256)
    assert bool((drawn["mask"] == 1).all())
    # A JAX buffer loads into the port's.
    loaded = TBuffer(cap, specs)
    convert.load_replay_buffer(loaded, {k: np.asarray(v) for k, v in jbuf.data.items()},
                               jbuf.ptr, jbuf.size)
    assert (loaded.ptr, loaded.size) == (tbuf.ptr, tbuf.size)
    for k in specs:
        np.testing.assert_array_equal(loaded.data[k].numpy(), tbuf.data[k].numpy())
