"""The port's network, distribution and normalizer modules against the JAX
package's on the same NumPy inputs, with flax weights carried across by
``utils/convert.py``.

Tolerance: float32 forward passes whose matrix products sum in another
order in XLA and in PyTorch agree to a few ulps; rtol 1e-5 / atol 1e-6
holds them with room and would still catch a transposed weight or a wrong
activation by orders of magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.models import distributions as td
from safe_control_gym_torch.models import networks as tn
from safe_control_gym_torch.models import normalization as tnorm
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.models import distributions as jd
from safe_control_gym_tpu.models import networks as jn
from safe_control_gym_tpu.models import normalization as jnorm

RTOL, ATOL = 1e-5, 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jn.ACTIVATIONS))
def test_activation_matches_flax(name):
    x = _x((64,), scale=3.0)
    want = np.asarray(jn.get_activation(name)(jnp.asarray(x)))
    got = tn.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act,hidden,out_gain", [("tanh", (64, 64), 0.01), ("relu", (32, 16), 1.0)])
def test_mlp_forward_matches_flax(act, hidden, out_gain):
    nx, ny = 12, 4
    jm = jn.MLP(ny, hidden, act=act, out_gain=out_gain)
    params = jax.device_get(jm.init(jax.random.key(3), jnp.zeros((1, nx))))
    pm = tn.MLP(nx, ny, hidden, act=act, out_gain=out_gain)
    convert.load_mlp(pm, params)
    x = _x((256, nx))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # The reverse direction gives back the flax tree leaf for leaf.
    back = convert.mlp_params(pm)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_mlp_init_is_orthogonal_with_gains():
    """Fresh weights: orthogonal rows or columns scaled by the layer's
    gain, zero biases (flax's orthogonal initializer)."""
    m = tn.MLP(12, 4, (64, 64), act="tanh", out_gain=0.01,
               generator=torch.Generator().manual_seed(0))
    for layer, gain in zip(m.layers, (2.0**0.5, 2.0**0.5, 0.01)):
        w = layer.weight.detach().double()
        small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(small.numpy(), gain**2 * np.eye(small.shape[0]), atol=1e-5)
        assert not layer.bias.detach().any()


def test_normal_matches_jax():
    loc, value = _x((128, 4), 1), _x((128, 4), 2)
    scale = np.exp(_x((4,), 3, 0.3))
    jdist = jd.Normal(jnp.asarray(loc), jnp.asarray(scale))
    tdist = td.Normal(torch.from_numpy(loc), torch.from_numpy(scale))
    np.testing.assert_allclose(tdist.log_prob(torch.from_numpy(value)).numpy(),
                               np.asarray(jdist.log_prob(jnp.asarray(value))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tdist.entropy().numpy(), np.asarray(jdist.entropy()),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tdist.mode().numpy(), np.asarray(jdist.mode()))
    # Sampling from an explicit generator: the same seed gives the same
    # draws, and they follow loc + scale * N(0, 1).
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a, b = tdist.sample(g()), tdist.sample(g())
    assert torch.equal(a, b)
    z = ((a - tdist.loc) / tdist.scale).numpy()
    assert abs(z.mean()) < 4.0 / np.sqrt(z.size) and abs(z.std() - 1.0) < 0.1


def test_normalizers_match_jax():
    """Three updates of each running normalizer from the same batches."""
    jo, to = jnorm.MeanStdNormalizer.create((12,), clip=5.0), tnorm.MeanStdNormalizer((12,), clip=5.0)
    jr, tr = jnorm.RewardStdNormalizer.create(32), tnorm.RewardStdNormalizer(32)
    for i in range(3):
        x = _x((32, 12), 10 + i, 2.0) + 1.0
        rew, done = _x((32,), 20 + i), np.arange(32) % (5 + i) == 0
        jy, jo = jo(jnp.asarray(x))
        ty, _ = to(torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
        jy, jr = jr(jnp.asarray(rew), jnp.asarray(done))
        ty, _ = tr(torch.from_numpy(rew), torch.from_numpy(done))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    for jrms, trms in ((jo.rms, to.rms), (jr.rms, tr.rms)):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(trms, f).numpy(), np.asarray(getattr(jrms, f)),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tr.ret.numpy(), np.asarray(jr.ret), rtol=RTOL, atol=ATOL)
    # update=False reads the statistics without folding the batch in.
    before = to.rms.count.clone()
    to(torch.from_numpy(_x((4, 12))), update=False)
    assert torch.equal(to.rms.count, before)


@pytest.mark.parametrize("hw", [(36, 36), (45, 29)], ids=["square", "ragged"])
def test_cnn_forward_matches_flax(hw):
    """flax pads 'SAME' (unevenly where the stride leaves a remainder) and
    flattens NHWC; the port pads the same way and keeps the order.  The
    ragged image's first conv pads both axes unevenly (3 above, 4 below)."""
    h, w = hw
    jm = jn.CNN(6)
    params = jax.device_get(jm.init(jax.random.key(4), jnp.zeros((1, h, w, 3))))
    pm = tn.CNN((h, w, 3), 6)
    convert.load_cnn(pm, params)
    x = _x((4, h, w, 3), 5)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cnn_same_padding_is_xla_s():
    """XLA's 'SAME': ceil(n / s) outputs, the smaller half of the padding
    first."""
    assert tn._same_pads(36, 8, 4) == (2, 2)
    assert tn._same_pads(30, 8, 4) == (3, 3)
    assert tn._same_pads(45, 8, 4) == (3, 4)
    assert tn._same_pads(9, 4, 2) == (1, 2)
    assert tn._same_pads(5, 3, 1) == (1, 1)


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_forward_matches_flax(masked):
    """The GRU over a (B, T, D) sequence, with done masks that restart the
    carry mid-sequence and an initial carry, against flax's."""
    B, T, D, H = 4, 7, 5, 8
    jm = jn.RNN(H)
    params = jax.device_get(jm.init(jax.random.key(6), jnp.zeros((B, T, D))))
    pm = tn.RNN(D, H)
    convert.load_rnn(pm, params)
    xs, h0 = _x((B, T, D), 7), _x((B, H), 8)
    masks = (np.random.default_rng(9).random((B, T)) > 0.3).astype(np.float32) if masked else None
    jys, jh = jm.apply(params, jnp.asarray(xs), None if masks is None else jnp.asarray(masks),
                       jnp.asarray(h0))
    ys, h = pm(torch.from_numpy(xs), None if masks is None else torch.from_numpy(masks),
               torch.from_numpy(h0))
    assert ys.shape == (B, T, H) and h.shape == (B, H)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    # Without an initial carry both start from zeros.
    jys0, _ = jm.apply(params, jnp.asarray(xs))
    np.testing.assert_allclose(pm(torch.from_numpy(xs))[0].detach().numpy(), np.asarray(jys0),
                               rtol=RTOL, atol=ATOL)


def test_categorical_matches_jax():
    logits = _x((256, 5), 10, 2.0)
    value = np.random.default_rng(11).integers(0, 5, 256)
    jdist, tdist = jd.Categorical(jnp.asarray(logits)), td.Categorical(torch.from_numpy(logits))
    np.testing.assert_allclose(tdist.logits.numpy(), np.asarray(jdist.logits), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tdist.log_prob(torch.from_numpy(value)).numpy(),
                               np.asarray(jdist.log_prob(jnp.asarray(value))), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tdist.entropy().numpy(), np.asarray(jdist.entropy()), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tdist.mode().numpy(), np.asarray(jdist.mode()))
    # Sampling from an explicit generator: the same seed gives the same
    # draws, and their frequencies follow the probabilities (each within
    # 5 standard errors over 20000 draws of one row).
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tdist.sample(g())
    assert a.shape == (256,) and torch.equal(a, tdist.sample(g()))
    one = td.Categorical(torch.from_numpy(logits[:1]).expand(20000, 5))
    freq = np.bincount(one.sample(g()).numpy(), minlength=5) / 20000
    p = np.exp(np.asarray(jdist.logits[0]))
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / 20000) + 1e-9), (freq, p)
