"""The port's SafeExplorerPPO and SafetyLayer (``controllers/safe_explorer.py``)
against the JAX package's on tests/test_rl.py::test_safe_explorer_ppo's
CartPole (a box constraint on the state, B = 8, T = 50, 2 epochs of
minibatches of 100, 60 pretrain steps).

The JAX pretrain keeps its dataset in locals; the test reads it by wrapping
the NumPy module that ``safe_explorer.py`` calls ``np.concatenate`` through
(monkeypatched for the test, the JAX package unedited).  Draws are
replayed: the pretrain's uniform actions (``fold_in(key(seed), i)``), the
PPO collection's normals and the epochs' permutations from the train step's
key chain.

Tolerances: the projection rtol 1e-5 / atol 1e-6 (float32 dot products);
the dataset's observations rtol 1e-5 / atol 1e-6 and its constraint
differences atol 4e-6 (two float32 values of up to 10, each within an ulp
of 1e-6), its actions and mask exactly; the regression after 100
full-batch Adam epochs rtol 1e-3 on the loss (2.6e-4 seen), over its first
10 epochs 1e-5 on the losses and 3e-5 of each weight tensor's largest
entry (9e-6 seen; later epochs drift, see the test); the
train step's parameters rtol 3e-4 / atol 3e-6 (the PPO suite's)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from safe_control_gym_torch.controllers import safe_explorer as tse
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers import safe_explorer as jse
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.ops import ctr_prng as jctr

B, T, STEPS = 8, 50, 60
CFG = dict(task="stabilization", cost="rl_reward", normalized_rl_action_space=True,
           randomized_init=True, episode_len_sec=0.5,
           constraints=({"constraint_form": "default_constraint", "constrained_variable": "state",
                         "upper_bounds": [1.0, 10.0, 0.3, 10.0],
                         "lower_bounds": [-1.0, -10.0, -0.3, -10.0]},))
KW = dict(rollout_batch_size=B, rollout_steps=T, opt_epochs=2, mini_batch_size=100,
          pretrain_steps=STEPS)


class _RecordingNumpy:
    """NumPy, with every ``concatenate`` result recorded."""

    def __init__(self):
        self.concatenated = []

    def __getattr__(self, name):
        return getattr(np, name)

    def concatenate(self, *a, **k):
        out = np.concatenate(*a, **k)
        self.concatenated.append(out)
        return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX SafeExplorerPPO before and after its pretrain, the dataset
    its pretrain regressed on, and the pretrain's loss."""
    jctrl = jse.SafeExplorerPPO(jc.make_cartpole(jc.CartPoleConfig(**CFG)), seed=0, **KW)
    params0 = jax.device_get(jctrl.safety_layer.params)
    mp = pytest.MonkeyPatch()
    rec = _RecordingNumpy()
    mp.setattr(jse, "np", rec)
    try:
        loss = jctrl.pretrain()["pretrain_loss"]
    finally:
        mp.undo()
    return jctrl, params0, rec.concatenated, loss


@pytest.fixture(scope="module")
def tenv():
    return tc.make_cartpole(tc.CartPoleConfig(**CFG), device="cpu")


def test_get_safe_action_matches_jax():
    """Random g (the layer's MLP), c and actions: rows that violate, rows
    with no violation (lambda 0 everywhere: constraint 0 picked, the action
    unchanged) and exact ties (two constraints with the same g and c)."""
    obs_dim, act_dim, nc, n = 4, 2, 5, 512
    jl = jse.SafetyLayer(obs_dim, act_dim, nc, seed=3)
    params = jax.tree.map(np.array, jax.device_get(jl.params))
    d2 = params["params"]["Dense_2"]
    d2["kernel"][:, act_dim:2 * act_dim] = d2["kernel"][:, :act_dim]  # constraint 1 = 0
    d2["bias"] = np.random.default_rng(1).normal(size=nc * act_dim).astype(np.float32)
    d2["bias"][act_dim:2 * act_dim] = d2["bias"][:act_dim]
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    act = rng.uniform(-1, 1, (n, act_dim)).astype(np.float32)
    c = rng.normal(size=(n, nc)).astype(np.float32)
    c[:, 1] = c[:, 0]
    c[: n // 4] = -50.0  # no violation
    want = np.asarray(jl.get_safe_action(params, jnp.asarray(obs), jnp.asarray(act),
                                         jnp.asarray(c), 0.1))
    tl = tse.SafetyLayer(obs_dim, act_dim, nc)
    convert.load_mlp(tl.net, params)
    with torch.no_grad():
        got = tl.get_safe_action(torch.from_numpy(obs), torch.from_numpy(act),
                                 torch.from_numpy(c), 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[: n // 4], act[: n // 4])
    assert (np.abs(got - act).max(-1) > 1e-3).sum() > n // 4
    # The tie picks the first of the two equal constraints in both packages.
    with torch.no_grad():
        g = tl.g(torch.from_numpy(obs))
        lam = torch.clamp_min(((g * torch.from_numpy(act)[:, None]).sum(-1) + torch.from_numpy(c)
                               + 0.1) / ((g * g).sum(-1) + 1e-8), 0.0)
    worst = torch.argmax(lam, -1).numpy()
    assert (worst == 0).sum() > n // 4 and (worst != 1).all()


def test_pretrain_dataset_matches_jax(jax_side, tenv):
    """The same random actions from the same reset: the regressed
    transitions (obs_t, a_t), their targets c_{t+1} - c_t and weights
    ~done_{t+1}, the first step dropped."""
    jctrl, _, data, _ = jax_side
    X, A, DC, W = data[:4]
    key = jax.random.key(0)
    acts = np.stack([np.array(jax.random.uniform(jax.random.fold_in(key, i), (B, 1),
                                                 minval=-1.0, maxval=1.0)) for i in range(STEPS)])
    seeds = np.asarray(jax.vmap(jctr.env_seed_from_key)(jax.random.split(key, B)))
    port = tse.SafeExplorerPPO(tenv, seed=0, **KW)
    got = port.safety_layer.collect_dataset(port.vec, STEPS, seed=0, acts=torch.from_numpy(acts),
                                            env_seeds=torch.tensor(seeds))
    assert got[0].shape == (B * (STEPS - 1), 4) and got[2].shape == (B * (STEPS - 1), 8)
    np.testing.assert_array_equal(got[1].numpy(), A)
    np.testing.assert_array_equal(got[3].numpy(), W.astype(np.float32))
    assert 0 < (W == 0).sum()  # episode ends dropped
    np.testing.assert_allclose(got[0].numpy(), X, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), DC, rtol=1e-5, atol=4e-6)


def test_regression_matches_jax(jax_side, tenv):
    """100 full-batch Adam epochs on the JAX pretrain's own dataset from its
    initial weights: the last epoch's loss.  The weights agree to float32
    rounding for the first epochs and then drift apart (Adam turns the sign
    of a ~0 gradient into an lr-sized step), so they are held over 10
    epochs against the JAX pretrain's epoch (safe_explorer.py:83-93 of the
    JAX package: its layer's ``g`` and ``tx``), at 3e-5 of each tensor's
    largest entry."""
    jctrl, params0, data, loss = jax_side
    X, A, DC, W = (torch.from_numpy(np.asarray(a, np.float32)) for a in data[:4])
    port = tse.SafeExplorerPPO(tenv, seed=0, **KW)
    convert.load_mlp(port.safety_layer.net, params0)
    np.testing.assert_allclose(float(port.safety_layer.fit(X, A, DC, W)), loss, rtol=1e-3)

    jl = jctrl.safety_layer
    Xj, Aj, DCj, Wj = (jnp.asarray(a, jnp.float32) for a in data[:4])

    @jax.jit
    def train_epoch(params, opt_state):
        def loss_fn(p):
            pred = (jl.g(p, Xj) * Aj[:, None, :]).sum(-1)
            return (Wj[:, None] * (pred - DCj) ** 2).mean()

        lj, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt_state = jl.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, lj

    layer = tse.SafetyLayer(4, 1, 8)
    convert.load_mlp(layer.net, params0)
    params, opt_state = params0, jl.tx.init(params0)
    for _ in range(10):
        params, opt_state, lj = train_epoch(params, opt_state)
        lt = layer.fit(X, A, DC, W, epochs=1)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for x, y in zip(jax.tree.leaves(convert.mlp_params(layer.net)),
                    jax.tree.leaves(jax.device_get(params))):
        assert np.abs(x - y).max() <= 3e-5 * np.abs(y).max()
    assert np.abs(convert.mlp_params(layer.net)["params"]["Dense_0"]["kernel"]
                  - params0["params"]["Dense_0"]["kernel"]).max() > 1e-3


def test_train_step_matches_jax(jax_side, tenv):
    """One ``_train_step`` after the pretrain, from the JAX package's weights,
    safety layer and env state, with its collection normals and
    permutations replayed: every sampled action projected, then PPO."""
    jctrl, _, _, _ = jax_side
    js = jctrl.state
    jnew, jm = jctrl._train_step(js)
    port = tse.SafeExplorerPPO(tenv, seed=0, **KW)
    ac = jax.device_get(js.ac)
    convert.load_actor_critic(port.state.ac, ac.actor_params, ac.critic_params, ac.logstd)
    convert.load_mlp(port.safety_layer.net, jax.device_get(jctrl.safety_layer.params))
    port.state.env_state = convert.cartpole_state_from_numpy(
        jax.tree.map(np.asarray, {k: getattr(js.env_state, k)
                                  for k in js.env_state.__dataclass_fields__ if k != "key"}), "cpu")
    port.state.obs = torch.tensor(np.asarray(js.obs))
    key, eps = js.key, []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        eps.append(np.array(jax.random.normal(k_act, (B, 1))))
    perm = np.stack([np.array(jax.random.permutation(k, B * T))
                     for k in jax.random.split(key, 2 + 2)[1:-1]])
    _, tm = port._train_step(port.state, eps=torch.from_numpy(np.stack(eps)),
                             perm=torch.from_numpy(perm))
    jac = jax.device_get(jnew.ac)
    got = convert.actor_critic_params(port.state.ac)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves((jac.actor_params, jac.critic_params,
                                                           jac.logstd))):
        np.testing.assert_allclose(x, y, rtol=3e-4, atol=3e-6)
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(port.state.obs.numpy(), np.asarray(jnew.obs), rtol=2e-4,
                               atol=2e-5)


def test_pretrain_and_learn_run(tenv):
    """The port's own pretrain (its generator's actions) and ``learn``: a
    finite loss, one train step, the filter on the current weights."""
    port = tse.SafeExplorerPPO(tenv, seed=0, **KW)
    res = port.pretrain()
    assert np.isfinite(res["pretrain_loss"])
    m = port.learn(max_env_steps=B * T)
    assert port.state.total_steps == B * T and all(np.isfinite(v) for v in m.values())
    obs = torch.zeros(3, 4)
    act = torch.full((3, 1), 0.5)
    c = port._cc.get_values_raw(obs, act)
    torch.testing.assert_close(port.action_filter_fn(obs, act),
                               port.safety_layer.get_safe_action(obs, act, c, 0.0))
    with pytest.raises(ValueError):
        tse.SafeExplorerPPO(tc.make_cartpole(tc.CartPoleConfig(task="stabilization"),
                                             device="cpu"))
