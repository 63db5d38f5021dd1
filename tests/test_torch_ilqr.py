"""The port's iLQR controller against the JAX package's, on the CartPole
config of ``tests/test_controllers.py:64-79``.

- ``_backward``'s gains and feedforward from the same trajectory (JAX's
  LQR-policy rollout) and the same lambda, float32, within GAIN_REL of the
  largest entry.  The reference's reversed sweep amplifies a last-place
  difference about twofold every ten steps back from the end of the
  200-step horizon (measured at lambda 1 and 0.1: ~1e-7 over the last 100
  steps, 2e-4 and 1.8e-3 of a step's largest gain at the first step), so
  GAIN_REL holds over the last 100 steps and SWEEP_REL over all of them
  (measured 1.8e-3 for the gains, 5.2e-3 for the feedforward).  The
  feedforward u + du - K x cancels to ~0.01 over the last 100 steps; there
  it is held at FF_ATOL (measured 6.1e-7);
- ``_forward`` from the same gains: states within the JAX suite's state
  tolerance (rtol 2e-4 / atol 2e-5);
- ``learn()``'s final cost: rtol COST_RTOL (the lambda loop's decisions
  compare float32 costs; the first LQR gains come from each package's own
  float32 Riccati solve, 1e-5 apart on CartPole, ``test_torch_lqr_pid``);
- the bar: after ``learn()``, one episode ends with |x|, |theta| < 0.1."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safe_control_gym_torch.controllers.ilqr import iLQR as TiLQR
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_tpu.controllers.ilqr import iLQR as JiLQR
from safe_control_gym_tpu.envs import cartpole as jc

GAIN_REL, SWEEP_REL, FF_ATOL, COST_RTOL = 1e-5, 1e-2, 2e-6, 1e-5
CFG = dict(task="stabilization", cost="quadratic", randomized_init=False,
           init_state={"init_theta": 0.2, "init_x": -0.3}, episode_len_sec=4)


def controllers(**kw):
    cfg = jc.CartPoleConfig(**CFG)
    jenv, tenv = jc.make_cartpole(cfg), tc.make_cartpole(tc.CartPoleConfig(**CFG), device="cpu")
    return (JiLQR(jenv, q_lqr=[1.0], r_lqr=[0.1], **kw),
            TiLQR(tenv, q_lqr=[1.0], r_lqr=[0.1], **kw))


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def lqr_rollout(jc_):
    """JAX's initial LQR policy rollout, the input of the first backward pass."""
    from safe_control_gym_tpu.ops.integrators import discretize_linear_system
    from safe_control_gym_tpu.ops.linalg import dlqr_gain

    m = jc_.model
    state, _, _ = jax.jit(jc_.env.reset)(jax.random.key(0))

    def gain(x_g):
        A, B = m.df_func(x_g, jc_.u_0)
        return dlqr_gain(*discretize_linear_system(A, B, m.dt), jc_.Q, jc_.R)[0]

    K0 = jax.vmap(gain)(jc_.x_ref)
    ff = jnp.einsum("tij,tj->ti", K0, jc_.x_ref) + jc_.u_0
    return state.x[: m.nx], -K0, ff


def test_backward_and_forward_match_jax():
    jl, tl = controllers()
    x0, K0, ff = lqr_rollout(jl)
    xs, us = jl._forward(x0, K0, ff)
    t_xs, t_us = tl._forward(torch.as_tensor(np.asarray(x0)), torch.as_tensor(np.asarray(K0)),
                             torch.as_tensor(np.asarray(ff)))
    np.testing.assert_allclose(t_xs.numpy(), np.asarray(xs), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t_us.numpy(), np.asarray(us), rtol=2e-4, atol=2e-5)
    for lamb in (1.0, 0.1):
        Ks, uffs = map(np.asarray, jl._backward(xs, us, jnp.asarray(lamb)))
        t_Ks, t_uffs = tl._backward(torch.as_tensor(np.asarray(xs)),
                                    torch.as_tensor(np.asarray(us)), lamb)
        assert t_Ks.shape == (tl.T, 1, 4) and t_uffs.shape == (tl.T, 1)
        assert rel(t_Ks.numpy()[100:], Ks[100:]) < GAIN_REL
        np.testing.assert_allclose(t_uffs.numpy()[100:], uffs[100:], rtol=0, atol=FF_ATOL)
        assert rel(t_Ks.numpy(), Ks) < SWEEP_REL
        assert rel(t_uffs.numpy(), uffs) < SWEEP_REL


def test_learn_matches_jax_and_stabilizes():
    jl, tl = controllers(max_iterations=8)
    want, got = jl.learn()["cost"], tl.learn()["cost"]
    assert np.isfinite(got) and got == tl.final_cost
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    assert rel(tl.gains_fb.numpy(), jl.gains_fb) < 1e-3
    # tests/test_controllers.py:64-79: one episode with the learned policy.
    vec = make_vec_env(tl.env, 1, auto_reset=False)
    state, obs, _ = vec.reset(env_seeds=torch.tensor([0], dtype=torch.int32))
    tl.reset()
    for _ in range(tl.env.max_episode_steps):
        a = tl.select_action(obs[0].numpy())
        assert a.shape == (1,)
        state, obs, _, done, _ = vec.step_no_reset(state, torch.as_tensor(a)[None])
        if bool(done[0]):
            break
    x = state.x[0].numpy()
    assert np.abs(x[[0, 2]]).max() < 0.1, x
