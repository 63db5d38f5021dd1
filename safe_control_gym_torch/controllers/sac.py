"""SAC (soft actor-critic) with a device-resident replay buffer.

Port of ``safe_control_gym_tpu/controllers/sac.py`` (reference
safe_control_gym/controllers/sac/sac.py + sac_utils.py), with the same
semantics:

  * squashed-Gaussian actor: MLP -> (mu, log_std clipped to [-20, 2]),
    reparameterized sample, tanh squash with the stable log-prob correction
    ``logp -= sum(2 (log2 - a - softplus(-2a)))`` (sac_utils.py:173-209);
  * twin Q networks with a min-target, a target twin with soft update tau
    (sac_utils.py:138-165, 414);
  * optional automatic temperature tuning toward a target entropy
    (-act_dim by default) (sac.py:36-127);
  * warm-up with uniform random actions (sac.py:247-268);
  * truncation-aware transitions: next_obs is the true terminal observation
    and the bootstrap mask stays 1 on time-limit ends.

One train step is ``train_interval // B`` env steps of the general engine
(on the 3D quadrotor one K1 launch each) pushed into the ring buffer, then
``updates_per_step`` gradient updates.  Where the JAX package carries a
PRNG key in its state, the controller draws from its own
``torch.Generator``; every draw can be handed in instead (the tests replay
the JAX package's).  A train step reads nothing back from the device: the
warm-up test, the buffer's pointer and fill level are host ints, and the
metrics come back as tensors.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.controllers.buffers import ReplayBuffer
from safe_control_gym_torch.models.networks import MLP
from safe_control_gym_torch.models.optim import Adam
from safe_control_gym_torch.parallel.vector import make_vec_env

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
# The JAX package's float32 constants: 0.5 * log(2 pi) and log(2).
HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi)))
LOG_2 = float(np.log(np.float32(2.0)))


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """Defaults mirror the reference's sac.yaml."""

    hidden_dim: int = 256
    activation: str = "relu"
    gamma: float = 0.99
    tau: float = 0.005
    init_temperature: float = 0.2
    use_entropy_tuning: bool = False
    target_entropy: Optional[float] = None
    train_interval: int = 100
    train_batch_size: int = 64
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    entropy_lr: float = 1e-3
    max_env_steps: int = 1_000_000
    warm_up_steps: int = 1000
    rollout_batch_size: int = 4
    max_buffer_size: int = 1_000_000
    updates_per_step: int = 1


def transition_specs(obs_dim: int, act_dim: int) -> dict:
    """The replay buffer's fields (SAC's and DDPG's)."""
    return {"obs": (obs_dim,), "act": (act_dim,), "rew": (), "next_obs": (obs_dim,), "mask": ()}


def soft_update(target: nn.Module, source: nn.Module, tau: float):
    """``target = (1 - tau) * target + tau * source`` in place, in the JAX
    package's order of operations (sac_utils.py:414)."""
    with torch.no_grad():
        tp = list(target.parameters())
        torch._foreach_mul_(tp, 1.0 - tau)
        torch._foreach_add_(tp, torch._foreach_mul(list(source.parameters()), tau))


def clip_split(x, lo, hi):
    """``jnp.clip`` as JAX writes it, a maximum then a minimum: on a bound
    the gradient splits, as jax.grad's does (``lo`` and ``hi`` 0-dim
    tensors)."""
    return torch.minimum(torch.maximum(x, lo), hi)


class _Actor(nn.Module):
    """Squashed-Gaussian actor: one MLP giving (mu, log_std)."""

    def __init__(self, obs_dim, act_dim, hidden, act, generator=None):
        super().__init__()
        self.net = MLP(obs_dim, 2 * act_dim, (hidden, hidden), act=act, generator=generator)
        self.act_dim = act_dim
        self.register_buffer("log_std_min", torch.tensor(LOG_STD_MIN))
        self.register_buffer("log_std_max", torch.tensor(LOG_STD_MAX))
        self.register_buffer("zero", torch.tensor(0.0))

    def dist_params(self, obs):
        out = self.net(obs)
        mu, log_std = out[..., :self.act_dim], out[..., self.act_dim:]
        return mu, clip_split(log_std, self.log_std_min, self.log_std_max)

    def sample(self, obs, generator=None, eps=None):
        """(tanh(pre), log-prob) of a reparameterized draw; ``eps`` the
        standard normals (drawn from ``generator`` where None)."""
        mu, log_std = self.dist_params(obs)
        std = torch.exp(log_std)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
        pre = mu + std * eps
        # Written as the JAX package does: (pre - mu) / std recomputed, not eps.
        logp = (-0.5 * ((pre - mu) / std) ** 2 - log_std - HALF_LOG_2PI).sum(-1)
        # Tanh correction (sac_utils.py:200); softplus as jax.nn.softplus,
        # logaddexp(x, 0), with no threshold.
        logp = logp - (2.0 * (LOG_2 - pre - torch.logaddexp(-2.0 * pre, self.zero))).sum(-1)
        return torch.tanh(pre), logp

    def mode(self, obs):
        mu, _ = self.dist_params(obs)
        return torch.tanh(mu)


class _TwinQ(nn.Module):
    def __init__(self, obs_dim, act_dim, hidden, act, generator=None):
        super().__init__()
        self.q1 = MLP(obs_dim + act_dim, 1, (hidden, hidden), act=act, generator=generator)
        self.q2 = MLP(obs_dim + act_dim, 1, (hidden, hidden), act=act, generator=generator)

    def forward(self, obs, act):
        x = torch.cat([obs, act], -1)
        return self.q1(x)[..., 0], self.q2(x)[..., 0]


@dataclasses.dataclass
class SACState:
    """Training state, updated in place by each train step."""

    actor: _Actor
    critic: _TwinQ
    target_critic: _TwinQ
    log_alpha: torch.Tensor
    actor_opt: Adam
    critic_opt: Adam
    alpha_opt: Adam
    buffer: ReplayBuffer
    env_state: Any
    obs: torch.Tensor
    total_steps: int = 0


def draw_at(draws, key, i):
    """The ``i``-th of a train step's handed-in draws named ``key``; None
    (the generator draws) where none were handed in."""
    return None if draws is None else draws[key][i]


class SAC(BaseController):
    """SAC on the env's device (CUDA unless the env was built on the CPU)."""

    GENERATORS = ("gen",)

    def __init__(self, env, seed: int = 0, **kwargs):
        super().__init__(env, seed=seed)
        known = {f.name for f in dataclasses.fields(SACConfig)}
        self.cfg = cfg = SACConfig(**{k: v for k, v in kwargs.items() if k in known})
        self.device = dev = env.device
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.vec = make_vec_env(env, cfg.rollout_batch_size)
        obs_dim, act_dim = env.spaces.obs_dim, env.spaces.action_dim
        self.act_dim = act_dim
        # Actions are squashed to [-1, 1], then mapped affinely to the box.
        lo = np.asarray(env.spaces.action_low, np.float32)
        hi = np.asarray(env.spaces.action_high, np.float32)
        self.act_lo = torch.tensor(lo, device=dev)
        self.act_span = torch.tensor(hi - lo, device=dev)
        self.target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                               else -float(act_dim))
        init = torch.Generator().manual_seed(seed)
        actor = _Actor(obs_dim, act_dim, cfg.hidden_dim, cfg.activation, init).to(dev)
        critic = _TwinQ(obs_dim, act_dim, cfg.hidden_dim, cfg.activation, init).to(dev)
        log_alpha = torch.log(torch.tensor(cfg.init_temperature, device=dev))
        env_state, obs, _ = self.vec.reset(seed=seed)
        inf = float("inf")
        self.state = SACState(
            actor=actor, critic=critic, target_critic=copy.deepcopy(critic), log_alpha=log_alpha,
            actor_opt=Adam(actor.parameters(), cfg.actor_lr, inf),
            critic_opt=Adam(critic.parameters(), cfg.critic_lr, inf),
            alpha_opt=Adam([log_alpha], cfg.entropy_lr, inf),
            buffer=ReplayBuffer(cfg.max_buffer_size, transition_specs(obs_dim, act_dim),
                                device=dev),
            env_state=env_state, obs=obs)

    def _to_box(self, a):
        return self.act_lo + (a + 1.0) * 0.5 * self.act_span

    def _uniform(self, shape):
        return torch.empty(shape, device=self.device).uniform_(-1.0, 1.0, generator=self.gen)

    # -- train step -----------------------------------------------------------
    @torch.no_grad()
    def env_step(self, state: SACState, act=None, eps=None, uniform=None):
        """One step of the B envs, its transition pushed (sac.py:180-206).
        The action in [-1, 1] is ``act`` where given; else a uniform draw
        (``uniform``) during the warm-up and a policy sample (its normals
        ``eps``) after it."""
        if act is None:
            shape = (self.cfg.rollout_batch_size, self.act_dim)
            if state.total_steps < self.cfg.warm_up_steps:
                act = self._uniform(shape) if uniform is None else uniform
            else:
                act, _ = state.actor.sample(state.obs, self.gen, eps)
        env_state, obs, rew, done, info = self.vec.step(state.env_state, self._to_box(act))
        push_transition(state.buffer, state.obs, act, rew, obs, done, info)
        state.env_state, state.obs = env_state, obs
        state.total_steps += self.cfg.rollout_batch_size
        return state

    def update(self, state: SACState, idx=None, eps_next=None, eps_pi=None):
        """One gradient update (sac.py:208-269) from a minibatch of the
        buffer (rows ``idx`` where given); ``eps_next`` and ``eps_pi`` the
        normals of the target's and the actor loss's samples.  Returns the
        metrics as tensors."""
        cfg = self.cfg
        batch = state.buffer.sample(self.gen, cfg.train_batch_size, idx)
        alpha = torch.exp(state.log_alpha)
        actor, critic = state.actor, state.critic
        with torch.no_grad():
            a_next, logp_next = actor.sample(batch["next_obs"], self.gen, eps_next)
            q1_t, q2_t = state.target_critic(batch["next_obs"], a_next)
            target_q = batch["rew"] + cfg.gamma * batch["mask"] * (
                torch.minimum(q1_t, q2_t) - alpha * logp_next)
        with torch.enable_grad():
            q1, q2 = critic(batch["obs"], batch["act"])
            c_loss = ((q1 - target_q) ** 2).mean() + ((q2 - target_q) ** 2).mean()
            c_grads = torch.autograd.grad(c_loss, list(critic.parameters()))
        state.critic_opt.step(c_grads)
        with torch.enable_grad():
            a, logp = actor.sample(batch["obs"], self.gen, eps_pi)
            q1, q2 = critic(batch["obs"], a)
            a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
            a_grads = torch.autograd.grad(a_loss, list(actor.parameters()))
        state.actor_opt.step(a_grads)
        if cfg.use_entropy_tuning:
            with torch.enable_grad():
                la = state.log_alpha.detach().requires_grad_()
                al_loss = (torch.exp(la) * (-logp.detach() - self.target_entropy)).mean()
                al_grad = torch.autograd.grad(al_loss, [la])
            state.alpha_opt.step(al_grad)
        soft_update(state.target_critic, critic, cfg.tau)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(), "alpha": alpha}

    def _train_step(self, state: SACState, draws=None):
        """``train_interval // B`` env steps, then ``updates_per_step``
        updates (sac.py:271-276).  ``draws`` replaces the generator's draws:
        per env step ``uniform`` and ``eps`` ((n, B, act_dim)), per update
        ``idx`` ((u, batch)), ``eps_next`` and ``eps_pi`` ((u, batch,
        act_dim)).  Returns ``(state, metrics)``; ``state`` is updated in
        place."""
        cfg = self.cfg
        for i in range(cfg.train_interval // cfg.rollout_batch_size):
            self.env_step(state, eps=draw_at(draws, "eps", i), uniform=draw_at(draws, "uniform", i))
        metrics = {}
        for u in range(cfg.updates_per_step):
            metrics = self.update(state, draw_at(draws, "idx", u), draw_at(draws, "eps_next", u),
                                  draw_at(draws, "eps_pi", u))
        return state, metrics

    # -- reference API --------------------------------------------------------
    def learn(self, max_env_steps: Optional[int] = None, **kwargs):
        steps_target = max_env_steps or self.cfg.max_env_steps
        n_iters = max(steps_target // self.cfg.train_interval, 1)
        return {k: float(v) for k, v in self._learn_chunked(n_iters).items()}

    @torch.no_grad()
    def select_action(self, obs, info=None):
        obs = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)
        return self._policy(obs).cpu().numpy()

    @torch.no_grad()
    def _policy(self, obs):
        return self._to_box(self.state.actor.mode(obs))


def push_transition(buffer: ReplayBuffer, obs, act, rew, next_obs, done, info):
    """Push one truncation-aware transition per env: the true next
    observation even across an auto-reset, and the bootstrap mask 0 only on
    a real termination (sac.py:187-199, ddpg.py:135-140)."""
    truncated = info["TimeLimit.truncated"]
    next_obs = torch.where(done[:, None], info["terminal_observation"], next_obs)
    mask = 1.0 - (done & ~truncated).to(rew.dtype)
    buffer.push({"obs": obs, "act": act, "rew": rew, "next_obs": next_obs, "mask": mask})
