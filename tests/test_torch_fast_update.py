"""K4, the PPO minibatch-gradient kernel (``parallel/fast_update.py``): its
plain version against ``jax.grad`` of the reference losses and against the
JAX package's Pallas kernel (interpret mode), and the CUDA kernel against
the plain version on a card.

Tolerance: rtol 2e-4 / atol 2e-6 on gradients, the JAX suite's own
(``tests/test_fast_update.py``): the hand-written backward sums its terms in
another order than autodiff, over a few hundred samples in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.models.networks import MLP as TMLP
from safe_control_gym_torch.parallel import fast_update as tfu
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.models.distributions import Normal
from safe_control_gym_tpu.models.networks import MLP as JMLP
from safe_control_gym_tpu.parallel import fast_update as jfu

RTOL, ATOL = 2e-4, 2e-6
HALF_LOG_2PI32 = float(np.float32(0.5 * np.log(2.0 * np.pi)))


def _nets(nx, nu, H, act, seed=3):
    ja, jc = JMLP(nu, (H, H), act=act, out_gain=0.01), JMLP(1, (H, H), act=act)
    k = jax.random.key(seed)
    ap = jax.device_get(ja.init(k, jnp.zeros((1, nx))))
    cp = jax.device_get(jc.init(jax.random.fold_in(k, 1), jnp.zeros((1, nx))))
    ta, tc = TMLP(nx, nu, (H, H), act=act), TMLP(nx, 1, (H, H), act=act)
    convert.load_mlp(ta, ap)
    convert.load_mlp(tc, cp)
    return (ja, jc, ap, cp), (ta, tc)


def _batch(mb, nx, nu, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(obs=f(mb, nx), act=0.5 * f(mb, nu), v=f(mb), logp=0.1 * f(mb) - 4.0,
                ret=f(mb), adv=f(mb))


def _pack(b):
    cols = [b["obs"], b["act"]] + [b[k][:, None] for k in ("v", "logp", "ret", "adv")]
    return np.concatenate(cols, 1).astype(np.float32)  # (mb, F)


def _flax_grads(g, tag):
    """The port's gradient dict as flax-layout trees for one net."""
    return {"params": {f"Dense_{i}": {"kernel": g[f"w{i + 1}{tag}"].numpy().T,
                                      "bias": g[f"b{i + 1}{tag}"].numpy()} for i in range(3)}}


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("nx,nu,act", [(12, 4, "tanh"), (12, 4, "relu"), (4, 1, "tanh")])
def test_plain_grads_match_jax_grad(nx, nu, act):
    H, mb, clip = 64, 512, 0.2
    (ja, jc, ap, cp), (ta, tc) = _nets(nx, nu, H, act)
    logstd = -0.5 * np.ones(nu, np.float32)
    b = _batch(mb, nx, nu)

    def losses(ap_, logstd_, cp_):
        dist = Normal(ja.apply(ap_, b["obs"]), jnp.exp(logstd_))
        logp = dist.log_prob(b["act"])
        ratio = jnp.exp(logp - b["logp"])
        min_surr = jnp.minimum(ratio * b["adv"], jnp.clip(ratio, 1 - clip, 1 + clip) * b["adv"])
        v = jc.apply(cp_, b["obs"])[..., 0]
        sums = jnp.stack([min_surr.sum(), (b["logp"] - logp).sum(), ((v - b["ret"]) ** 2).sum()])
        return -min_surr.mean() + 0.5 * ((v - b["ret"]) ** 2).mean(), sums

    (_, sums_ref), (ga, gl, gc) = jax.value_and_grad(losses, argnums=(0, 1, 2), has_aux=True)(
        ap, jnp.asarray(logstd), cp)
    w = tfu.prep_weights(ta, tc, torch.tensor(logstd))
    g, sums = tfu.ppo_grads(torch.from_numpy(_pack(b).T.copy()), w, clip=clip, act=act)
    _assert_trees_close(_flax_grads(g, "a"), ga)
    _assert_trees_close(_flax_grads(g, "c"), gc)
    np.testing.assert_allclose(g["logstd"].numpy(), np.asarray(gl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_ref), rtol=2e-4)


@pytest.mark.parametrize("clip", [0.2, 0.0], ids=["tie-inside", "clip-edge"])
def test_plain_grads_match_jax_kernel_at_ties(clip):
    """Half the samples sit at ratio == 1 exactly (the actor's output layer
    is zero, each action equals its bias, logstd = -log(2 pi)/2 so the
    log-prob is exactly 0, and logp_old = 0).  With clip 0.2 that is the
    surr1 == surr2 tie strictly inside the bounds (weight 1); with clip 0
    it is the clip edge, where the kernels' convention (fast_update.py:
    151-158) gives weight 1/2 and jax.grad of jnp.clip would split the
    edge again.  The plain version follows the JAX kernel in both."""
    nx, nu, H, mb = 12, 4, 16, 64
    (ja, jc, ap, cp), (ta, tc) = _nets(nx, nu, H, "tanh", seed=5)
    bias = np.asarray([0.3, -0.2, 0.1, 0.05], np.float32)
    ap["params"]["Dense_2"] = {"kernel": np.zeros((H, nu), np.float32), "bias": bias}
    convert.load_mlp(ta, ap)
    logstd = np.full(nu, -HALF_LOG_2PI32, np.float32)
    b = _batch(mb, nx, nu, seed=1)
    at_one = np.arange(mb) % 2 == 0
    b["act"][at_one] = bias
    b["logp"][at_one] = 0.0

    w = tfu.prep_weights(ta, tc, torch.tensor(logstd))
    mb_t = torch.from_numpy(_pack(b).T.copy())
    g, sums = tfu.ppo_grads(mb_t, w, clip=clip, act="tanh")

    fu = jfu.FastPPOUpdate(mb, H, "tanh", clip, chunk=mb, interpret=True, obs_dim=nx, act_dim=nu)
    mb_T = jnp.asarray(_pack(b).T.reshape(-1, 8, mb // 8))
    jga, jgc, jgl, jsums = jax.device_get(fu.grads(mb_T, fu.prep_weights(ap, cp, jnp.asarray(logstd))))
    _assert_trees_close(_flax_grads(g, "a"), jga)
    _assert_trees_close(_flax_grads(g, "c"), jgc)
    np.testing.assert_allclose(g["logstd"].numpy(), jgl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sums.numpy(), jsums, rtol=2e-4, atol=1e-6)

    # The ratio-1 samples add exactly -w_pol = weight * adv / mb to every
    # logstd entry (their diff is 0); the rest carry diff != 0.
    weight = 1.0 if clip > 0 else 0.5
    g1, _ = tfu.ppo_grads_plain(mb_t[:, torch.from_numpy(at_one)], w, clip=clip, act="tanh")
    want = weight * b["adv"][at_one].sum() / at_one.sum()
    np.testing.assert_allclose(g1["logstd"].numpy(), np.full(nu, want), rtol=1e-5, atol=1e-7)


def _numpy_nets(nx, nu, H, seed):
    """flax-layout parameter trees of an actor (nu outputs) and a critic from
    a numpy generator, and the port's MLPs carrying them (utils/convert.py)."""
    rng = np.random.default_rng(seed)

    def tree(n_out):
        dims = (nx, H, H, n_out)
        return {"params": {f"Dense_{i}": {
            "kernel": (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(dims[i + 1])).astype(np.float32)} for i in range(3)}}

    ap, cp = tree(nu), tree(1)
    ta, tc = TMLP(nx, nu, (H, H)), TMLP(nx, 1, (H, H))
    convert.load_mlp(ta, ap)
    convert.load_mlp(tc, cp)
    return ap, cp, ta, tc


@pytest.mark.parametrize("nx,nu,H", [(12, 4, 128), (128, 8, 32)], ids=["h128", "obs128-act8"])
def test_plain_grads_match_jax_kernel_at_widths(nx, nu, H):
    """The widths the port's K4 now takes: config 4 at H = 128 and the JAX
    rule's largest observation and action widths, against the JAX kernel in
    interpret mode on numpy-seeded weights and a batch spanning both sides
    of the clip range."""
    mb, clip = 256, 0.2
    ap, cp, ta, tc = _numpy_nets(nx, nu, H, seed=H)
    logstd = np.linspace(-0.7, -0.3, nu).astype(np.float32)
    b = _batch(mb, nx, nu, seed=7)
    mean = np.asarray(ta(torch.from_numpy(b["obs"])).detach())
    b["logp"] = (-0.5 * ((b["act"] - mean) / np.exp(logstd)) ** 2 - logstd - HALF_LOG_2PI32).sum(
        -1).astype(np.float32) + 0.3 * b["logp"]
    w = tfu.prep_weights(ta, tc, torch.tensor(logstd))
    g, sums = tfu.ppo_grads(torch.from_numpy(_pack(b).T.copy()), w, clip=clip, act="tanh")

    fu = jfu.FastPPOUpdate(mb, H, "tanh", clip, chunk=mb, interpret=True, obs_dim=nx, act_dim=nu)
    mb_T = jnp.asarray(_pack(b).T.reshape(-1, 8, mb // 8))
    jga, jgc, jgl, jsums = jax.device_get(fu.grads(mb_T, fu.prep_weights(ap, cp, jnp.asarray(logstd))))
    _assert_trees_close(_flax_grads(g, "a"), jga)
    _assert_trees_close(_flax_grads(g, "c"), jgc)
    np.testing.assert_allclose(g["logstd"].numpy(), jgl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sums.numpy(), jsums, rtol=2e-4, atol=1e-4)


# kernel_scope against the JAX package's use_fast_update="auto" rule
# (safe_control_gym_tpu/controllers/ppo.py:240-256), case by case:
# (obs_dim, act_dim, hidden, activation, minibatch, use_clipped_value) ->
# the JAX rule's answer on a TPU, and the port's where it differs.  The JAX
# rule checks no hidden width; the port stops at 256.  Its TPU-only chunk
# terms (mb % 1024 up to 4096, else mb % 4096) are VMEM and Mosaic limits.
_SCOPE_CASES = {
    "config4": ((12, 4, 64, "tanh", 131072, False), True, True),
    "h128": ((12, 4, 128, "tanh", 131072, False), True, True),
    "h256": ((12, 4, 256, "relu", 4096, False), True, True),
    "h257": ((12, 4, 257, "tanh", 4096, False), True, False),
    "obs128-act8": ((128, 8, 64, "tanh", 8192, False), True, True),
    "obs129": ((129, 4, 64, "tanh", 8192, False), False, False),
    "act9": ((12, 9, 64, "tanh", 8192, False), False, False),
    "elu": ((12, 4, 64, "elu", 8192, False), False, False),
    "clipped-value": ((12, 4, 64, "tanh", 8192, True), False, False),
    "mb-not-8": ((12, 4, 64, "tanh", 8196, False), False, False),
    "mb-264-tpu-chunk": ((4, 1, 64, "tanh", 264, False), False, True),
    "mb-4104-tpu-chunk": ((6, 2, 64, "tanh", 4104, False), False, True),
}


@pytest.mark.parametrize("case", list(_SCOPE_CASES))
def test_kernel_scope_against_jax_auto_rule(case):
    args, jax_tpu, port = _SCOPE_CASES[case]
    nx, nu, H, act, mb, clipped = args
    jax_rule = (not clipped and act in ("tanh", "relu") and nx <= 128 and nu <= 8 and mb % 8 == 0
                and (mb % 1024 == 0 if mb <= 4096 else mb % 4096 == 0))
    assert jax_rule == jax_tpu
    assert tfu.kernel_scope(*args) == port
    if jax_tpu:  # the port drops only terms of the TPU, and the width beyond 256
        assert port or H > 256


@pytest.mark.parametrize("hidden,act,mb,clipped_value", [
    (128, "tanh", 8192, False), (32, "relu", 264, False), (64, "tanh", 8192, True)],
    ids=["h128", "h32-mb264", "clipped-value"])
def test_kernel_scope_picks_as_the_jax_package(hidden, act, mb, clipped_value):
    """The JAX package's own PPO (fast_interpret stands in for the TPU) on
    config 4 takes its kernel exactly where kernel_scope says yes, except
    for the TPU-only minibatch chunking (mb 264)."""
    from safe_control_gym_tpu.controllers.ppo import PPO as JPPO
    from safe_control_gym_tpu.envs import quadrotor as jq

    env = jq.make_quadrotor(jq.QuadrotorConfig(quad_type=3, episode_len_sec=1))
    jppo = JPPO(env, seed=0, fast_interpret=True, rollout_batch_size=8, rollout_steps=8,
                hidden_dim=hidden, activation=act, mini_batch_size=mb,
                use_clipped_value=clipped_value)
    port = tfu.kernel_scope(12, 4, hidden, act, mb, clipped_value)
    tpu_chunks = mb % 1024 == 0 if mb <= 4096 else mb % 4096 == 0
    assert (jppo._fu is not None) == (port and tpu_chunks)


@pytest.mark.parametrize("kw", [
    dict(hidden=257), dict(obs_dim=129), dict(act_dim=9), dict(act="elu"), dict(mb_size=100),
    dict(clipped_value=True), dict(hidden=0)],
    ids=["h257", "obs129", "act9", "elu", "mb100", "clipped-value", "h0"])
def test_fast_ppo_update_raises_outside_scope(kw):
    args = dict(mb_size=256, hidden=64, act="tanh", clip_param=0.2, obs_dim=12, act_dim=4)
    tfu.FastPPOUpdate(**args)  # in scope
    with pytest.raises(ValueError):
        tfu.FastPPOUpdate(**{**args, **kw})


def test_fast_ppo_update_keys_and_shapes():
    """FastPPOUpdate.grads returns dicts keyed like the modules'
    named_parameters(), with each parameter's shape."""
    nx, nu, H = 12, 4, 32
    _, (ta, tc) = _nets(nx, nu, H, "tanh")
    fu = tfu.FastPPOUpdate(256, H, "tanh", 0.2, obs_dim=nx, act_dim=nu)
    logstd = -0.5 * torch.ones(nu)
    ga, gc, glogstd, sums = fu.grads(torch.from_numpy(_pack(_batch(256, nx, nu)).T.copy()),
                                     fu.prep_weights(ta, tc, logstd))
    for grads, net in ((ga, ta), (gc, tc)):
        assert list(grads) == [k for k, _ in net.named_parameters()]
        for k, p in net.named_parameters():
            assert grads[k].shape == p.shape, k
    assert glogstd.shape == (nu,) and sums.shape == (3,)
    with pytest.raises(ValueError):
        tfu.FastPPOUpdate(100, H, "tanh", 0.2)
    with pytest.raises(ValueError):
        tfu.FastPPOUpdate(128, H, "elu", 0.2)


@pytest.mark.parametrize("nx,nu,H", [(12, 4, 64), (12, 4, 128), (128, 8, 64), (128, 8, 256)])
def test_kernel_matches_plain_on_card(nx, nu, H):
    """K4 against its plain version on the card, and two launches on the
    same input bit for bit (no float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    mb = 4096
    _, (ta, tc) = _nets(nx, nu, H, "tanh")
    dev = torch.device("cuda")
    w = tfu.prep_weights(ta.to(dev), tc.to(dev), -0.5 * torch.ones(nu, device=dev))
    x = torch.from_numpy(_pack(_batch(mb, nx, nu)).T.copy()).to(dev)
    g1, s1 = tfu.ppo_grads(x, w, clip=0.2)
    g2, s2 = tfu.ppo_grads(x, w, clip=0.2)
    gp, sp = tfu.ppo_grads_plain(x, w, clip=0.2)
    torch.cuda.synchronize()
    for k in tfu.SEGMENTS:
        assert torch.equal(g1[k], g2[k]), k
        torch.testing.assert_close(g1[k], gp[k], rtol=RTOL, atol=ATOL)
    assert torch.equal(s1, s2)
    torch.testing.assert_close(s1, sp, rtol=2e-4, atol=1e-4)
