"""DDPG: the deterministic off-policy twin of SAC.

Port of ``safe_control_gym_tpu/controllers/ddpg.py`` (reference
safe_control_gym/controllers/ddpg/ddpg.py + ddpg_utils.py): a deterministic
tanh actor, one Q critic, a target actor and a target critic with soft
update tau, exploration by an action-noise process (Ornstein-Uhlenbeck by
default, ``models/random_processes.py``), warm-up random actions, and the
truncation-aware replay of SAC.  The noise process advances on every env
step, warm-up included, and is never reset at an episode's end, as in the
JAX package.  Draws come from the controller's ``torch.Generator`` or are
handed in; a train step reads nothing back from the device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.controllers.buffers import ReplayBuffer
from safe_control_gym_torch.controllers.sac import (draw_at, push_transition, soft_update,
                                                    transition_specs)
from safe_control_gym_torch.models.networks import MLP
from safe_control_gym_torch.models.optim import Adam
from safe_control_gym_torch.models.random_processes import make_action_noise_process
from safe_control_gym_torch.parallel.vector import make_vec_env


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Defaults mirror the reference's ddpg.yaml."""

    hidden_dim: int = 256
    activation: str = "relu"
    gamma: float = 0.99
    tau: float = 0.005
    train_interval: int = 100
    train_batch_size: int = 64
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    max_env_steps: int = 1_000_000
    warm_up_steps: int = 10_000
    rollout_batch_size: int = 4
    max_buffer_size: int = 1_000_000
    random_process: Optional[dict] = None
    updates_per_step: int = 1


@dataclasses.dataclass
class DDPGState:
    """Training state, updated in place by each train step."""

    actor: MLP
    critic: MLP
    target_actor: MLP
    target_critic: MLP
    actor_opt: Adam
    critic_opt: Adam
    noise: Any
    buffer: ReplayBuffer
    env_state: Any
    obs: torch.Tensor
    total_steps: int = 0


class DDPG(BaseController):
    """DDPG on the env's device (CUDA unless the env was built on the CPU)."""

    GENERATORS = ("gen",)

    def __init__(self, env, seed: int = 0, **kwargs):
        super().__init__(env, seed=seed)
        known = {f.name for f in dataclasses.fields(DDPGConfig)}
        self.cfg = cfg = DDPGConfig(**{k: v for k, v in kwargs.items() if k in known})
        self.device = dev = env.device
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.vec = make_vec_env(env, cfg.rollout_batch_size)
        obs_dim, act_dim = env.spaces.obs_dim, env.spaces.action_dim
        self.act_dim = act_dim
        lo = np.asarray(env.spaces.action_low, np.float32)
        hi = np.asarray(env.spaces.action_high, np.float32)
        self.act_lo = torch.tensor(lo, device=dev)
        self.act_span = torch.tensor(hi - lo, device=dev)
        init = torch.Generator().manual_seed(seed)
        hidden = (cfg.hidden_dim, cfg.hidden_dim)
        actor = MLP(obs_dim, act_dim, hidden, act=cfg.activation, out_act="tanh",
                    generator=init).to(dev)
        critic = MLP(obs_dim + act_dim, 1, hidden, act=cfg.activation, generator=init).to(dev)
        noise = make_action_noise_process(cfg.random_process or {"func": "ou", "sigma": 0.2},
                                          (cfg.rollout_batch_size, act_dim), device=dev)
        env_state, obs, _ = self.vec.reset(seed=seed)
        inf = float("inf")
        self.state = DDPGState(
            actor=actor, critic=critic, target_actor=copy.deepcopy(actor),
            target_critic=copy.deepcopy(critic),
            actor_opt=Adam(actor.parameters(), cfg.actor_lr, inf),
            critic_opt=Adam(critic.parameters(), cfg.critic_lr, inf), noise=noise,
            buffer=ReplayBuffer(cfg.max_buffer_size, transition_specs(obs_dim, act_dim),
                                device=dev),
            env_state=env_state, obs=obs)

    def _to_box(self, a):
        return self.act_lo + (a + 1.0) * 0.5 * self.act_span

    @staticmethod
    def _q(critic, obs, act):
        return critic(torch.cat([obs, act], -1))[..., 0]

    # -- train step -----------------------------------------------------------
    @torch.no_grad()
    def env_step(self, state: DDPGState, act=None, eps=None, uniform=None):
        """One step of the B envs, its transition pushed (ddpg.py:124-145).
        The noise process advances by one sample (its normals ``eps`` where
        given); the action in [-1, 1] is ``act`` where given, else a uniform
        draw (``uniform``) during the warm-up and ``clip(actor(obs) + noise,
        -1, 1)`` after it."""
        shape = (self.cfg.rollout_batch_size, self.act_dim)
        noise, _ = state.noise.sample(self.gen, shape, eps)
        if act is None:
            if state.total_steps < self.cfg.warm_up_steps:
                act = uniform if uniform is not None else torch.empty(
                    shape, device=self.device).uniform_(-1.0, 1.0, generator=self.gen)
            else:
                act = torch.clamp(state.actor(state.obs) + noise, -1.0, 1.0)
        env_state, obs, rew, done, info = self.vec.step(state.env_state, self._to_box(act))
        push_transition(state.buffer, state.obs, act, rew, obs, done, info)
        state.env_state, state.obs = env_state, obs
        state.total_steps += self.cfg.rollout_batch_size
        return state

    def update(self, state: DDPGState, idx=None):
        """One gradient update (ddpg.py:147-181) from a minibatch of the
        buffer (rows ``idx`` where given).  Returns the metrics as
        tensors."""
        cfg = self.cfg
        batch = state.buffer.sample(self.gen, cfg.train_batch_size, idx)
        with torch.no_grad():
            a_next = state.target_actor(batch["next_obs"])
            target_q = batch["rew"] + cfg.gamma * batch["mask"] * self._q(
                state.target_critic, batch["next_obs"], a_next)
        critic, actor = state.critic, state.actor
        with torch.enable_grad():
            c_loss = ((self._q(critic, batch["obs"], batch["act"]) - target_q) ** 2).mean()
            c_grads = torch.autograd.grad(c_loss, list(critic.parameters()))
        state.critic_opt.step(c_grads)
        with torch.enable_grad():
            a_loss = -self._q(critic, batch["obs"], actor(batch["obs"])).mean()
            a_grads = torch.autograd.grad(a_loss, list(actor.parameters()))
        state.actor_opt.step(a_grads)
        soft_update(state.target_actor, actor, cfg.tau)
        soft_update(state.target_critic, critic, cfg.tau)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}

    def _train_step(self, state: DDPGState, draws=None):
        """``train_interval // B`` env steps, then ``updates_per_step``
        updates.  ``draws`` replaces the generator's draws: per env step
        ``eps`` (the noise's normals) and ``uniform`` ((n, B, act_dim)), per
        update ``idx`` ((u, batch)).  Returns ``(state, metrics)``; ``state``
        is updated in place."""
        cfg = self.cfg
        for i in range(cfg.train_interval // cfg.rollout_batch_size):
            self.env_step(state, eps=draw_at(draws, "eps", i),
                          uniform=draw_at(draws, "uniform", i))
        metrics = {}
        for u in range(cfg.updates_per_step):
            metrics = self.update(state, draw_at(draws, "idx", u))
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
        return self._to_box(self.state.actor(obs))
