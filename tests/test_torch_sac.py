"""The port's SAC (``controllers/sac.py``) against the JAX package's on the
same weights, buffers and draws.

The JAX package draws inside its jitted step from a key chain; each test
re-derives those draws (the ``jax.random.split``s of the step) and hands
them to the port's optional draw arguments.  The JAX inner functions
(``env_steps``, ``update``) are reached through the closure cells of
``SAC._make_train_step()``, without editing the JAX package.

Tolerances, against each tensor's largest entry: the actor's sample (action
and log-prob) 2e-6; one update's losses, new parameters (actor, twin Q,
target) and ``log_alpha`` 3e-5, the losses rtol 1e-5 / atol 1e-6 (relu nets of float32,
sums in other orders: 9e-6 seen on the parameters; a wrong term moves them
by Adam's lr-sized first step, ~1e-3 of their scale); the buffer rows an
env-step body writes exactly for the flags and 2e-6 for the states; a
whole train step the same as one update; ``train_many(3)`` against three
train steps bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from safe_control_gym_torch.controllers import sac as tsac
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers import sac as jsac
from safe_control_gym_tpu.envs import cartpole as jc

H, BS = 32, 64
PARAM_TOL = 3e-5  # updated parameters, against each tensor's largest entry
# CartPole stabilization from x = 2.25 (the bound is 2.4) with the cart's
# speed drawn in +-1.5: within 20 steps of random actions some envs leave
# the bound (termination) and some reach the 10-step limit (truncation).
TERM_CFG = dict(task="stabilization", cost="rl_reward", normalized_rl_action_space=True,
                randomized_init=True, episode_len_sec=0.2,
                init_state={"init_x": 2.25, "init_x_dot": 0.0, "init_theta": 0.0,
                            "init_theta_dot": 0.0},
                init_state_randomization_info={
                    "init_x_dot": {"distrib": "uniform", "low": -1.5, "high": 1.5}})


def rel_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max_abs_err {err:.3g} > {tol:g} x {scale:.3g}"


def loss_close(got, want, what=""):
    """A loss or metric: rtol 1e-5, atol 1e-6 (a mean of Q values of either
    sign cancels to ~1e-4 of their scale)."""
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6, err_msg=what)


def leaves_close(got_tree, want_tree, tol, what=""):
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        rel_close(g, w, tol, f"{what} leaf {i}")


def fields(js):
    return jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                     if k != "key"})


def closure(ctrl):
    """The JAX train step's inner functions (env_steps, update, ...)."""
    step = ctrl._make_train_step()
    return dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))


def envs(**cfg):
    return (jc.make_cartpole(jc.CartPoleConfig(**cfg)),
            tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"))


def load_state(port, jctrl):
    """The JAX SAC's state (weights, temperature, buffer, env state, obs,
    step count) into the port's."""
    js, st = jctrl.state, port.state
    convert.load_mlp(st.actor.net, jax.device_get(js.actor_params))
    convert.load_twin_q(st.critic, jax.device_get(js.critic_params))
    convert.load_twin_q(st.target_critic, jax.device_get(js.target_critic_params))
    with torch.no_grad():
        st.log_alpha.copy_(torch.tensor(np.asarray(js.log_alpha)))
    convert.load_replay_buffer(st.buffer, jax.device_get(js.buffer.data), js.buffer.ptr,
                               js.buffer.size)
    st.env_state = convert.cartpole_state_from_numpy(fields(js.env_state), "cpu")
    st.obs = torch.tensor(np.asarray(js.obs))
    st.total_steps = int(js.total_steps)


def check_state(port, js, tol):
    st = port.state
    rel_close(st.log_alpha.numpy(), np.asarray(js.log_alpha), tol, "log_alpha")
    leaves_close(convert.mlp_params(st.actor.net), js.actor_params, tol, "actor")
    for q in ("q1", "q2"):
        leaves_close(convert.mlp_params(getattr(st.critic, q)), js.critic_params[q], tol, q)
        leaves_close(convert.mlp_params(getattr(st.target_critic, q)),
                     js.target_critic_params[q], tol, f"target {q}")


def update_draws(key, size, act_dim):
    """The draws of the JAX package's update (sac.py:208-213)."""
    _, k_samp, k_a1, k_a2 = jax.random.split(key, 4)
    return (np.array(jax.random.randint(k_samp, (BS,), 0, max(size, 1))),
            np.array(jax.random.normal(k_a1, (BS, act_dim))),
            np.array(jax.random.normal(k_a2, (BS, act_dim))))


def test_actor_sample_matches_jax():
    """Action and log-prob on the JAX package's normals; the pre-activations
    reach beyond +-20 (where torch's softplus would switch to x) and the
    log-std hits both clip bounds."""
    obs_dim, act_dim, n = 4, 2, 256
    jactor = jsac._Actor(obs_dim, act_dim, H, "relu")
    params = jax.device_get(jactor.init(jax.random.key(0), jnp.zeros((1, obs_dim))))
    params["params"]["Dense_2"]["bias"] = np.array([-21.0, 0.2, 2.5, -25.0], np.float32)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    key = jax.random.key(1)
    a_j, lp_j = jactor.sample(params, jnp.asarray(obs), key)
    eps = np.array(jax.random.normal(key, (n, act_dim)))
    tactor = tsac._Actor(obs_dim, act_dim, H, "relu")
    convert.load_mlp(tactor.net, params)
    a_t, lp_t = tactor.sample(torch.from_numpy(obs), eps=torch.from_numpy(eps))
    pre = tactor.dist_params(torch.from_numpy(obs))[0].detach() + 7.39 * torch.from_numpy(eps)
    assert float(pre[:, 0].min()) < -20 and float(pre[:, 0].max()) > -20
    rel_close(a_t.detach().numpy(), np.asarray(a_j), 2e-6, "action")
    rel_close(lp_t.detach().numpy(), np.asarray(lp_j), 2e-6, "log-prob")
    rel_close(tactor.mode(torch.from_numpy(obs)).detach().numpy(),
              np.asarray(jactor.mode(params, jnp.asarray(obs))), 2e-6, "mode")


def test_log_std_clip_splits_the_gradient_on_a_bound():
    """jnp.clip's gradient is 1/2 exactly on a bound; the port's too."""
    tactor = tsac._Actor(1, 1, 4, "relu")
    x = torch.tensor([-20.0, 2.0, 0.5, -30.0], requires_grad=True)
    y = tsac.clip_split(x, tactor.log_std_min, tactor.log_std_max)
    (g,) = torch.autograd.grad(y.sum(), [x])
    jg = jax.grad(lambda v: jnp.clip(v, -20.0, 2.0).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g.tolist() == [0.5, 0.5, 1.0, 0.0]


@pytest.fixture(scope="module")
def jax_sac():
    jenv, tenv = envs(**TERM_CFG)
    jctrl = jsac.SAC(jenv, seed=0, hidden_dim=H, rollout_batch_size=4, train_interval=8,
                     warm_up_steps=1000, train_batch_size=BS, max_buffer_size=256,
                     use_entropy_tuning=True)
    return jctrl, tenv


def port_sac(tenv, **kw):
    return tsac.SAC(tenv, seed=0, hidden_dim=H, train_batch_size=BS, max_buffer_size=256,
                    use_entropy_tuning=True, **kw)


def test_env_step_body_matches_jax(jax_sac):
    """20 env steps of uniform warm-up actions (the JAX package's, from its
    key chain) through terminations and truncations write the same buffer
    rows: obs, act, rew, the true next_obs across each auto-reset, and the
    bootstrap mask 0 on terminations only."""
    jctrl, tenv = jax_sac
    n, B = 20, 4
    js = closure(jctrl)["env_steps"](jctrl.state, n)
    port = port_sac(tenv, rollout_batch_size=B, warm_up_steps=1000)
    load_state(port, jctrl)
    key = jctrl.state.key
    for _ in range(n):
        key, _, k_warm = jax.random.split(key, 3)
        a = np.array(jax.random.uniform(k_warm, (B, 1), jnp.float32, -1.0, 1.0))
        port.env_step(port.state, act=torch.from_numpy(a))
    buf, jbuf = port.state.buffer, js.buffer
    assert (buf.ptr, buf.size, port.state.total_steps) == (int(jbuf.ptr), int(jbuf.size),
                                                           int(js.total_steps)) == (80, 80, 80)
    mask = buf.data["mask"][:80].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jbuf.data["mask"][:80]))
    assert 0 < (mask == 0).sum() < 80  # terminations
    np.testing.assert_array_equal(buf.data["act"].numpy(), np.asarray(jbuf.data["act"]))
    for k in ("obs", "rew", "next_obs"):
        rel_close(buf.data[k].numpy(), np.asarray(jbuf.data[k]), 2e-6, k)
    # Truncations: next_obs is the terminal observation, not the reset one.
    obs_next_row = buf.data["obs"][4:80].numpy()
    assert (np.abs(buf.data["next_obs"][:76].numpy() - obs_next_row).max(-1) > 1e-3).sum() >= 4
    rel_close(port.state.obs.numpy(), np.asarray(js.obs), 2e-6, "obs")


def test_update_matches_jax(jax_sac):
    """One update from one buffer and one set of weights, with the JAX
    package's indices and normals, entropy tuning on."""
    jctrl, tenv = jax_sac
    rng = np.random.default_rng(3)
    jstate = jctrl.state
    buf = jstate.buffer
    for _ in range(40):  # 160 random transitions
        batch = {"obs": rng.normal(size=(4, 4)), "act": rng.uniform(-1, 1, (4, 1)),
                 "rew": rng.uniform(0, 1, 4), "next_obs": rng.normal(size=(4, 4)),
                 "mask": (rng.random(4) > 0.2).astype(np.float32)}
        buf = buf.push({k: jnp.asarray(v, jnp.float32) for k, v in batch.items()})
    jstate = jstate.replace(buffer=buf)
    jnew, jm = closure(jctrl)["update"](jstate)
    port = port_sac(tenv, rollout_batch_size=4)
    jctrl_view = type("V", (), {"state": jstate})
    load_state(port, jctrl_view)
    idx, e1, e2 = update_draws(jstate.key, int(buf.size), 1)
    tm = port.update(port.state, torch.from_numpy(idx).long(), torch.from_numpy(e1),
                     torch.from_numpy(e2))
    for k in ("critic_loss", "actor_loss", "alpha"):
        loss_close(tm[k], jm[k], k)
    check_state(port, jax.device_get(jnew), PARAM_TOL)
    # The update moved every network and the temperature.
    assert float(jnew.log_alpha) != float(jstate.log_alpha)
    a0 = np.asarray(jstate.actor_params["params"]["Dense_1"]["kernel"])
    assert np.abs(convert.mlp_params(port.state.actor.net)["params"]["Dense_1"]["kernel"]
                  - a0).max() > 1e-4


def test_train_step_matches_jax():
    """A whole small train step (B = 2, train_interval 4, updates_per_step
    2; the first env step in the warm-up, the second from the policy)
    against the JAX package's jitted ``_train_step``, with its draws
    replayed from its key chain."""
    jenv, tenv = envs(**TERM_CFG)
    kw = dict(hidden_dim=H, rollout_batch_size=2, train_interval=4, warm_up_steps=2,
              train_batch_size=BS, max_buffer_size=64, updates_per_step=2,
              use_entropy_tuning=True)
    jctrl = jsac.SAC(jenv, seed=0, **kw)
    jnew, jm = jctrl._train_step(jctrl.state)
    key, size, draws = jctrl.state.key, 0, {k: [] for k in ("uniform", "eps", "idx", "eps_next",
                                                             "eps_pi")}
    for _ in range(2):
        key, k_act, k_warm = jax.random.split(key, 3)
        draws["eps"].append(np.array(jax.random.normal(k_act, (2, 1))))
        draws["uniform"].append(np.array(jax.random.uniform(k_warm, (2, 1), jnp.float32, -1.0,
                                                            1.0)))
        size += 2
    for _ in range(2):
        idx, e1, e2 = update_draws(key, size, 1)
        key = jax.random.split(key, 4)[0]
        draws["idx"].append(idx)
        draws["eps_next"].append(e1)
        draws["eps_pi"].append(e2)
    port = tsac.SAC(tenv, seed=0, **{k: v for k, v in kw.items()})
    load_state(port, jctrl)
    tdraws = {k: torch.from_numpy(np.stack(v)) for k, v in draws.items()}
    tdraws["idx"] = tdraws["idx"].long()
    _, tm = port._train_step(port.state, tdraws)
    jnew = jax.device_get(jnew)
    for k in ("critic_loss", "actor_loss", "alpha"):
        loss_close(tm[k], jm[k], k)
    check_state(port, jnew, PARAM_TOL)
    for k in ("obs", "act", "rew", "next_obs", "mask"):
        rel_close(port.state.buffer.data[k].numpy(), np.asarray(jnew.buffer.data[k]), 2e-6, k)
    assert port.state.total_steps == int(jnew.total_steps) == 4


def test_train_many_equals_three_train_steps():
    """``train_many(3)`` advances the state bit for bit as three train steps
    do (the counterpart of test_offpolicy_train_many_chunk_matches_loop)."""
    _, tenv = envs(**dict(TERM_CFG, episode_len_sec=5))
    kw = dict(hidden_dim=H, rollout_batch_size=4, train_interval=40, warm_up_steps=80,
              train_batch_size=BS, max_buffer_size=2000, updates_per_step=2)
    a, b = tsac.SAC(tenv, seed=0, **kw), tsac.SAC(tenv, seed=0, **kw)
    for _ in range(3):
        a.state, ma = a._train_step(a.state)
    b.state, mb = b.train_many(3)(b.state)
    for pa, pb in zip(a.state.critic.parameters(), b.state.critic.parameters()):
        assert torch.equal(pa, pb)
    for pa, pb in zip(a.state.actor.parameters(), b.state.actor.parameters()):
        assert torch.equal(pa, pb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma) and np.isfinite(float(ma["critic_loss"]))
    assert a.state.total_steps == 120
    act = a.select_action(np.zeros(4, np.float32))
    assert act.shape == (1,) and np.isfinite(act).all()
    m = a.learn(max_env_steps=80)
    assert a.state.total_steps == 200 and set(m) == {"critic_loss", "actor_loss", "alpha"}


HOST_DATA_OPS = {"lift_fresh", "_local_scalar_dense", "nonzero", "is_nonzero", "equal", "item",
                 "masked_select", "unique", "_unique2", "bincount"}


class SyncAudit(TorchDispatchMode):
    """Records the operations that on a card would copy host data to the
    device or read a value back (each a host-device synchronization), as
    tests/test_torch_firmware.py's audit does."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_DATA_OPS or (name == "_to_copy" and "device" in (kwargs or {})):
            self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


def audit_train_steps(agent, steps=2):
    """One train step to make the env's per-device constants, then
    ``steps`` audited train steps; returns the last metrics."""
    agent.state, m = agent._train_step(agent.state)
    for _ in range(steps):
        with SyncAudit() as audit:
            agent.state, m = agent._train_step(agent.state)
        assert audit.hits == [], audit.hits
    return m


def test_train_step_on_config4_makes_no_sync_by_its_ops():
    """SAC train steps on BASELINE config 4 (the 3D quadrotor, K1's plain
    version here), one in the warm-up and one from the policy, make no
    operation that would synchronize host and card; the metrics stay
    tensors."""
    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    env = make_quadrotor(cfg4(episode_len_sec=0.1), device="cpu")
    agent = tsac.SAC(env, seed=0, hidden_dim=H, rollout_batch_size=4, train_interval=8,
                     warm_up_steps=16, train_batch_size=BS, max_buffer_size=256,
                     use_entropy_tuning=True)
    m = audit_train_steps(agent)
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    assert np.isfinite(float(m["critic_loss"])) and agent.state.total_steps == 24
