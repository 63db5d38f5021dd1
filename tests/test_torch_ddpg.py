"""The port's DDPG (``controllers/ddpg.py``) against the JAX package's on the
same weights, buffers and draws, the Ornstein-Uhlenbeck state carried.

As for SAC (``test_torch_sac.py``, whose helpers this file shares), the JAX
draws are re-derived from the key chain of the step and handed to the
port's optional draw arguments; the JAX inner functions come from the
closure cells of ``DDPG._make_train_step()``.  Tolerances, against each
tensor's largest entry: the losses rtol 1e-5 / atol 1e-6 and the updated parameters 3e-5
(relu nets of float32, sums in other orders); the buffer rows and the OU
state 2e-6, the mask exactly; ``train_many(3)`` bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safe_control_gym_torch.controllers import ddpg as tddpg
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers import ddpg as jddpg
from test_torch_sac import (BS, H, PARAM_TOL, TERM_CFG, audit_train_steps, closure, envs, fields,
                            leaves_close, loss_close, rel_close)

OU = {"func": "ou", "sigma": 0.3, "theta": 0.15}


def load_state(port, js):
    """A JAX DDPG state (weights, noise state, buffer, env state, obs, step
    count) into the port's."""
    st = port.state
    for name in ("actor", "critic", "target_actor", "target_critic"):
        convert.load_mlp(getattr(st, name), jax.device_get(getattr(js, f"{name}_params")))
    st.noise.x = torch.tensor(np.asarray(js.noise.x))
    convert.load_replay_buffer(st.buffer, jax.device_get(js.buffer.data), js.buffer.ptr,
                               js.buffer.size)
    st.env_state = convert.cartpole_state_from_numpy(fields(js.env_state), "cpu")
    st.obs = torch.tensor(np.asarray(js.obs))
    st.total_steps = int(js.total_steps)


def check_params(port, js, tol):
    st = port.state
    for name in ("actor", "critic", "target_actor", "target_critic"):
        leaves_close(convert.mlp_params(getattr(st, name)), getattr(js, f"{name}_params"), tol,
                     name)


def env_draws(key, B):
    """(next key, OU normals, uniforms) of one JAX env step (ddpg.py:124-130)."""
    key, k_noise, k_warm = jax.random.split(key, 3)
    return (key, np.array(jax.random.normal(k_noise, (B, 1), jnp.float32)),
            np.array(jax.random.uniform(k_warm, (B, 1), jnp.float32, -1.0, 1.0)))


def port_ddpg(tenv, **kw):
    return tddpg.DDPG(tenv, seed=0, hidden_dim=H, train_batch_size=BS, random_process=OU, **kw)


def test_env_step_body_matches_jax():
    """20 policy steps (no warm-up), the OU noise on the actor's tanh
    output, through terminations and truncations: the same buffer rows and
    OU state as the JAX package's scan body."""
    jenv, tenv = envs(**TERM_CFG)
    kw = dict(hidden_dim=H, rollout_batch_size=4, train_interval=8, warm_up_steps=0,
              train_batch_size=BS, max_buffer_size=128, random_process=OU)
    jctrl = jddpg.DDPG(jenv, seed=0, **kw)
    js = closure(jctrl)["env_steps"](jctrl.state, 20)
    port = tddpg.DDPG(tenv, seed=0, **kw)
    load_state(port, jctrl.state)
    key = jctrl.state.key
    for _ in range(20):
        key, eps, _ = env_draws(key, 4)
        port.env_step(port.state, eps=torch.from_numpy(eps))
    buf, jbuf = port.state.buffer, js.buffer
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size)) == (80, 80)
    np.testing.assert_array_equal(buf.data["mask"].numpy(), np.asarray(jbuf.data["mask"]))
    assert 0 < int((buf.data["mask"][:80] == 0).sum()) < 80
    for k in ("obs", "act", "rew", "next_obs"):
        rel_close(buf.data[k].numpy(), np.asarray(jbuf.data[k]), 2e-6, k)
    rel_close(port.state.noise.x.numpy(), np.asarray(js.noise.x), 2e-6, "OU state")
    assert float(port.state.noise.x.abs().max()) > 0.05  # carried across the resets


def test_update_matches_jax():
    """One update from one buffer and one set of weights with the JAX
    package's indices: both losses, actor, critic and both targets."""
    jenv, tenv = envs(**TERM_CFG)
    jctrl = jddpg.DDPG(jenv, seed=0, hidden_dim=H, rollout_batch_size=4, train_batch_size=BS,
                       max_buffer_size=256, random_process=OU)
    rng = np.random.default_rng(4)
    buf = jctrl.state.buffer
    for _ in range(40):
        batch = {"obs": rng.normal(size=(4, 4)), "act": rng.uniform(-1, 1, (4, 1)),
                 "rew": rng.uniform(0, 1, 4), "next_obs": rng.normal(size=(4, 4)),
                 "mask": (rng.random(4) > 0.2).astype(np.float32)}
        buf = buf.push({k: jnp.asarray(v, jnp.float32) for k, v in batch.items()})
    jstate = jctrl.state.replace(buffer=buf)
    jnew, jm = closure(jctrl)["update"](jstate)
    port = port_ddpg(tenv, rollout_batch_size=4, max_buffer_size=256)
    load_state(port, jstate)
    idx = np.array(jax.random.randint(jax.random.split(jstate.key)[1], (BS,), 0, int(buf.size)))
    tm = port.update(port.state, torch.from_numpy(idx).long())
    for k in ("critic_loss", "actor_loss"):
        loss_close(tm[k], jm[k], k)
    check_params(port, jax.device_get(jnew), PARAM_TOL)


def test_train_step_matches_jax():
    """A whole train step (B = 2, train_interval 4, updates_per_step 2; one
    warm-up env step, one from the policy, the OU noise advancing on both)
    against the JAX package's jitted ``_train_step``."""
    jenv, tenv = envs(**TERM_CFG)
    kw = dict(hidden_dim=H, rollout_batch_size=2, train_interval=4, warm_up_steps=2,
              train_batch_size=BS, max_buffer_size=64, updates_per_step=2, random_process=OU)
    jctrl = jddpg.DDPG(jenv, seed=0, **kw)
    jnew, jm = jctrl._train_step(jctrl.state)
    key, draws = jctrl.state.key, {"eps": [], "uniform": [], "idx": []}
    for _ in range(2):
        key, eps, u = env_draws(key, 2)
        draws["eps"].append(eps)
        draws["uniform"].append(u)
    for _ in range(2):
        key, k_samp = jax.random.split(key)
        draws["idx"].append(np.array(jax.random.randint(k_samp, (BS,), 0, 4)))
    port = tddpg.DDPG(tenv, seed=0, **kw)
    load_state(port, jctrl.state)
    tdraws = {k: torch.from_numpy(np.stack(v)) for k, v in draws.items()}
    tdraws["idx"] = tdraws["idx"].long()
    _, tm = port._train_step(port.state, tdraws)
    jnew = jax.device_get(jnew)
    for k in ("critic_loss", "actor_loss"):
        loss_close(tm[k], jm[k], k)
    check_params(port, jnew, PARAM_TOL)
    rel_close(port.state.noise.x.numpy(), np.asarray(jnew.noise.x), 2e-6, "OU state")
    for k in ("obs", "act", "rew", "next_obs", "mask"):
        rel_close(port.state.buffer.data[k].numpy(), np.asarray(jnew.buffer.data[k]), 2e-6, k)


def test_train_steps_run_and_train_many_equals_loop():
    """Five train steps give finite losses and ``select_action`` a finite
    action of shape (1,) (test_ddpg_train_step_runs); ``train_many(3)``
    advances a second controller bit for bit as three train steps."""
    _, tenv = envs(**dict(TERM_CFG, episode_len_sec=5))
    kw = dict(hidden_dim=H, rollout_batch_size=4, train_interval=40, warm_up_steps=80,
              train_batch_size=BS, max_buffer_size=2000, updates_per_step=2)
    a, b = tddpg.DDPG(tenv, seed=0, **kw), tddpg.DDPG(tenv, seed=0, **kw)
    for _ in range(3):
        a.state, ma = a._train_step(a.state)
    b.state, mb = b.train_many(3)(b.state)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for pa, pb in zip(getattr(a.state, name).parameters(),
                          getattr(b.state, name).parameters()):
            assert torch.equal(pa, pb), name
    assert torch.equal(a.state.noise.x, b.state.noise.x)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for _ in range(2):
        a.state, ma = a._train_step(a.state)
    assert np.isfinite(float(ma["critic_loss"])) and np.isfinite(float(ma["actor_loss"]))
    act = a.select_action(np.zeros(4))
    assert act.shape == (1,) and np.isfinite(act).all()


def test_train_step_on_config4_makes_no_sync_by_its_ops():
    """DDPG train steps on BASELINE config 4 (K1's plain version here), one
    in the warm-up and one from the policy, the OU noise advancing on both,
    make no operation that would synchronize host and card."""
    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    env = make_quadrotor(cfg4(episode_len_sec=0.1), device="cpu")
    agent = tddpg.DDPG(env, seed=0, hidden_dim=H, rollout_batch_size=4, train_interval=8,
                       warm_up_steps=16, train_batch_size=BS, max_buffer_size=256)
    m = audit_train_steps(agent)
    assert np.isfinite(float(m["critic_loss"])) and agent.state.total_steps == 24
