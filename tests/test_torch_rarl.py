"""The port's RARL and RAP (``controllers/rarl.py``) against the JAX
package's on the 2D quadrotor of tests/test_rl.py::test_rarl_and_rap_phases
(B = 4, T = 25, 2 epochs of 2 minibatches of 50).

One protagonist phase and one adversary phase start from the JAX package's
weights and env state, with its protagonist and adversary normals and its
permutations replayed from the key chain of its jitted phases
(``jax.random.split`` as in rarl.py:140-290 of the JAX package).  Each of
the reference's quirks has a case of its own: the SGD step on ``logstd``,
the KL gate (both gradients zeroed, Adam still stepping) and the
adversary's ``-rew``; RAP changes the picked adversary and no other; RARL
on CartPole (the adversary width 1) runs.

Tolerances: parameters rtol 3e-4 / atol 3e-6 after four Adam steps (the
PPO suite's, ``test_torch_ppo.py``: tanh nets, and the rollouts' states
agree to float32 rounding), the mean KL atol 1e-6 (a mean of log-prob
differences that cancels to ~1e-3)."""

import jax
import numpy as np
import pytest
import torch

from safe_control_gym_torch.controllers import rarl as trarl
from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.utils import convert
from safe_control_gym_tpu.controllers import rarl as jrarl
from safe_control_gym_tpu.envs import quadrotor as jq

B, T, EPOCHS, MB = 4, 25, 2, 50
Q2_CFG = dict(quad_type=2, task="stabilization", cost="rl_reward", normalized_rl_action_space=True,
              adversary_disturbance="dynamics", episode_len_sec=2, ctrl_freq=25, pyb_freq=50)
KW = dict(rollout_batch_size=B, rollout_steps=T, opt_epochs=EPOCHS, mini_batch_size=MB)
RTOL, ATOL = 3e-4, 3e-6


def fields(js):
    return jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                     if k != "key"})


def agent_params(agent):
    return (convert.mlp_params(agent.actor), convert.mlp_params(agent.critic),
            agent.logstd.detach().numpy().copy())


def check_agent(agent, jagent, what):
    ja = jax.device_get((jagent.actor_params, jagent.critic_params, jagent.logstd))
    for got, want in zip(jax.tree.leaves(agent_params(agent)), jax.tree.leaves(ja)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def load_state(port, js):
    jp = jax.device_get(js.pro)
    convert.load_rarl_agent(port.state.pro, jp.actor_params, jp.critic_params, jp.logstd)
    ja = jax.device_get(js.adv)
    if isinstance(port.state.adv, list):
        convert.load_rarl_population(port.state.adv, ja.actor_params, ja.critic_params,
                                     ja.logstd)
    else:
        convert.load_rarl_agent(port.state.adv, ja.actor_params, ja.critic_params, ja.logstd)
    port.state.env_state = convert.quad_state_from_numpy(fields(js.env_state), "cpu")
    port.state.obs = torch.tensor(np.asarray(js.obs))
    port.state.total_steps = int(js.total_steps)


def phase_draws(key, act_dim, adv_dim, n_adv=1):
    """The draws of one JAX phase: RAP's pick, the protagonist's and the
    adversary's normals a step, the epochs' permutations."""
    key, k_pick, k_upd = jax.random.split(key, 3)
    draws = {"pick": int(jax.random.randint(k_pick, (), 0, n_adv)) if n_adv > 1 else None}
    pro, adv = [], []
    for _ in range(T):
        key, k_p, k_a = jax.random.split(key, 3)
        pro.append(np.array(jax.random.normal(k_p, (B, act_dim))))
        adv.append(np.array(jax.random.normal(k_a, (B, adv_dim))))
    draws["pro_eps"] = torch.from_numpy(np.stack(pro))
    draws["adv_eps"] = torch.from_numpy(np.stack(adv))
    draws["perm"] = torch.from_numpy(np.stack([
        np.array(jax.random.permutation(k, B * T)) for k in jax.random.split(k_upd, EPOCHS)]))
    return draws


@pytest.fixture(scope="module")
def q2_envs():
    return (jq.make_quadrotor(jq.QuadrotorConfig(**Q2_CFG)),
            tq.make_quadrotor(tq.QuadrotorConfig(**Q2_CFG), device="cpu"))


def test_pro_and_adv_phases_match_jax(q2_envs):
    jenv, tenv = q2_envs
    jctrl = jrarl.RARL(jenv, seed=0, **KW)
    port = trarl.RARL(tenv, seed=0, **KW)
    assert port.adv_dim == jctrl.adv_dim == 2
    load_state(port, jctrl.state)
    s1, m1 = jctrl._train_pro(jctrl.state)
    _, tm1 = port._train_pro(port.state, phase_draws(jctrl.state.key, 2, 2))
    check_agent(port.state.pro, s1.pro, "protagonist after its phase")
    check_agent(port.state.adv, jctrl.state.adv, "adversary after the protagonist's phase")
    np.testing.assert_allclose(float(tm1["kl"]), float(m1["kl"]), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(port.state.obs.numpy(), np.asarray(s1.obs), rtol=2e-4, atol=2e-5)
    s2, m2 = jctrl._train_adv(s1)
    _, tm2 = port._train_adv(port.state, phase_draws(s1.key, 2, 2))
    check_agent(port.state.adv, s2.adv, "adversary after its phase")
    check_agent(port.state.pro, s2.pro, "protagonist after the adversary's phase")
    np.testing.assert_allclose(float(tm2["kl"]), float(m2["kl"]), rtol=1e-3, atol=1e-6)
    assert port.state.total_steps == int(s2.total_steps) == 2 * B * T
    # Both phases moved their agent.
    a0 = np.asarray(jctrl.state.adv.actor_params["params"]["Dense_0"]["kernel"])
    assert np.abs(agent_params(port.state.adv)[0]["params"]["Dense_0"]["kernel"] - a0).max() > 1e-5
    assert port.select_action(np.zeros(6)).shape == (2,)


def _minibatch(port, agent, seed=0, logp_shift=0.0):
    rng = np.random.default_rng(seed)
    n = MB
    obs = torch.from_numpy(0.5 * rng.normal(size=(n, port.obs_dim)).astype(np.float32))
    with torch.no_grad():
        dist = port._dist(agent, obs)
        act = dist.sample(torch.Generator().manual_seed(seed))
        logp = dist.log_prob(act) + logp_shift
    adv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return {"obs": obs, "act": act, "logp": logp, "ret": torch.from_numpy(
        rng.normal(size=n).astype(np.float32)), "adv": adv}


def test_logstd_takes_a_plain_sgd_step(q2_envs):
    """``logstd - actor_lr * g``: the gradient's own size, not Adam's
    lr-sized first step."""
    _, tenv = q2_envs
    port = trarl.RARL(tenv, seed=0, **KW)
    agent = port.state.pro
    mb = _minibatch(port, agent)
    before = agent.logstd.detach().clone()
    with torch.enable_grad():
        dist = port._dist(agent, mb["obs"])
        logp = dist.log_prob(mb["act"])
        ratio = torch.exp(logp - mb["logp"])
        p_loss = -torch.minimum(ratio * mb["adv"], torch.clamp(ratio, 0.8, 1.2) * mb["adv"]).mean()
        (g,) = torch.autograd.grad(p_loss - 0.01 * dist.entropy().mean(), [agent.logstd])
    port.minibatch_step(agent, mb)
    torch.testing.assert_close(agent.logstd.detach(), before - 3e-4 * g, rtol=0, atol=1e-9)
    # Adam's first step would be lr * sign(g), every entry 3e-4 in size.
    step = (agent.logstd.detach() - before).abs()
    assert float(step.min()) > 0 and float((step - 3e-4).abs().max()) > 3e-5, step
    assert agent.actor_opt.count == 1


def test_kl_gate_zeroes_actor_and_logstd_but_adam_steps(q2_envs):
    """With the gate shut (KL of this minibatch far above 1.5 target_kl),
    neither the actor nor logstd moves, Adam still counts the step, and the
    critic moves."""
    _, tenv = q2_envs
    port = trarl.RARL(tenv, seed=0, **KW)
    agent = port.state.pro
    mb = _minibatch(port, agent, logp_shift=1.0)
    actor0 = [p.detach().clone() for p in agent.actor.parameters()]
    critic0 = [p.detach().clone() for p in agent.critic.parameters()]
    logstd0 = agent.logstd.detach().clone()
    kl = port.minibatch_step(agent, mb)
    assert float(kl) > 0.5
    assert agent.actor_opt.count == 1 and agent.critic_opt.count == 1
    assert all(torch.equal(a, b) for a, b in zip(actor0, agent.actor.parameters()))
    assert torch.equal(agent.logstd.detach(), logstd0)
    assert not all(torch.equal(a, b) for a, b in zip(critic0, agent.critic.parameters()))


def test_adversary_records_minus_the_reward(q2_envs):
    """The same steps (same state and normals) record ``rew`` for the
    protagonist's phase and exactly ``-rew`` for the adversary's."""
    _, tenv = q2_envs
    port = trarl.RARL(tenv, seed=0, **KW)
    g = torch.Generator().manual_seed(1)
    pro_eps, adv_eps = torch.randn(T, B, 2, generator=g), torch.randn(T, B, 2, generator=g)
    env_state, obs = port.state.env_state, port.state.obs
    r_pro = port.collect(port.state, port.state.adv, False, pro_eps, adv_eps)
    port.state.env_state, port.state.obs = env_state, obs
    r_adv = port.collect(port.state, port.state.adv, True, pro_eps, adv_eps)
    assert torch.equal(r_adv["rew"], -r_pro["rew"]) and bool((r_pro["rew"] != 0).any())
    assert r_adv["act"].shape == (T, B, 2) and not torch.equal(r_adv["act"], r_pro["act"])


def test_rap_changes_the_picked_adversary_only(q2_envs):
    """RAP (3 adversaries): the adversary phase with the JAX package's pick
    matches its update of that population slot; the other two stay as they
    were, in both packages."""
    jenv, tenv = q2_envs
    jctrl = jrarl.RAP(jenv, seed=0, num_adversaries=3, **KW)
    port = trarl.RAP(tenv, seed=0, num_adversaries=3, **KW)
    load_state(port, jctrl.state)
    s1, _ = jctrl._train_adv(jctrl.state)
    draws = phase_draws(jctrl.state.key, 2, 2, n_adv=3)
    before = [agent_params(a) for a in port.state.adv]
    port._train_adv(port.state, draws)
    i = draws["pick"]
    pop = jax.device_get(s1.adv)
    for k in range(3):
        ja = jax.tree.map(lambda x: x[k], (pop.actor_params, pop.critic_params, pop.logstd))
        got = agent_params(port.state.adv[k])
        for g_, w_ in zip(jax.tree.leaves(got), jax.tree.leaves(ja)):
            np.testing.assert_allclose(g_, w_, rtol=RTOL, atol=ATOL, err_msg=f"adversary {k}")
        same = all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(got),
                                                         jax.tree.leaves(before[k])))
        assert same == (k != i), (k, i)
    check_agent(port.state.pro, s1.pro, "protagonist")
    # The port's own picks come from its CPU generator.
    port._train_adv(port.state)
    assert 0 <= port._pick() < 3


@pytest.mark.parametrize("channel", ["dynamics", "action"])
def test_rarl_on_cartpole_runs(channel):
    """The reference's canonical RARL task, both adversary channels (width
    1): a protagonist and an adversary phase give finite KLs."""
    env = tc.make_cartpole(tc.CartPoleConfig(
        task="stabilization", cost="rl_reward", normalized_rl_action_space=True,
        randomized_init=True, episode_len_sec=2, adversary_disturbance=channel,
        adversary_disturbance_scale=0.1), device="cpu")
    port = trarl.RARL(env, seed=0, **KW)
    assert port.adv_dim == 1
    state, m = port._train_step(port.state)
    assert np.isfinite(float(m["kl"])) and state.total_steps == 2 * B * T
    assert port.select_action(np.zeros(4)).shape == (1,)


def test_cycle_on_config4_makes_no_sync_by_its_ops():
    """A RARL cycle on BASELINE config 4 with the adversary on the dynamics
    channel (K1's plain version here) makes no operation that would
    synchronize host and card."""
    from safe_control_gym_torch.baseline import cfg4
    from test_torch_sac import audit_train_steps

    env = tq.make_quadrotor(cfg4(episode_len_sec=0.1, adversary_disturbance="dynamics"),
                            device="cpu")
    port = trarl.RARL(env, seed=0, rollout_batch_size=4, rollout_steps=10, opt_epochs=1,
                      mini_batch_size=20)
    assert port.adv_dim == 3
    m = audit_train_steps(port, steps=1)
    assert np.isfinite(float(m["kl"])) and port.state.total_steps == 2 * 2 * 40
