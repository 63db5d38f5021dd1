"""RARL (Robust Adversarial Reinforcement Learning) and RAP.

Port of ``safe_control_gym_tpu/controllers/rarl.py`` (reference
safe_control_gym/controllers/rarl/rarl.py, rap.py): a protagonist PPO agent
and an adversary PPO agent acting through the env's adversary channel
(``env.extras["set_adversary_control"]``, benchmark_env.py:256-266),
trained in alternating phases (rarl.py:340-460).  The adversary maximizes
the negative task reward.  RAP keeps a population of adversaries and picks
one per phase.

The JAX package's quirks are kept: the actor's Adam is unclipped
``optax.adam``; ``logstd`` takes a plain SGD step ``logstd - actor_lr * g``;
the approximate-KL gate zeroes both the actor's and ``logstd``'s gradients
while Adam still steps; the critic loss carries the factor 0.5; advantages
are always GAE, standardized with the population std plus 1e-6; each epoch
takes a permutation cut to ``n_mini * mini_batch_size``.

Every env step of the general engine is one K1 launch on the 3D
quadrotor.  Draws come from the controller's ``torch.Generator`` (RAP's
pick from a CPU generator, so that the population, a Python list, is
indexed with no device read) or are handed in.  A phase updates the state
in place; the picked adversary is updated in place in its population slot.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

import numpy as np
import torch

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.controllers.sac import clip_split
from safe_control_gym_torch.models.distributions import Normal
from safe_control_gym_torch.models.networks import MLP
from safe_control_gym_torch.models.optim import Adam
from safe_control_gym_torch.parallel.vector import make_vec_env


@dataclasses.dataclass(frozen=True)
class RARLConfig:
    hidden_dim: int = 64
    activation: str = "tanh"
    gamma: float = 0.99
    use_gae: bool = True
    gae_lambda: float = 0.95
    clip_param: float = 0.2
    target_kl: float = 0.01
    entropy_coef: float = 0.01
    opt_epochs: int = 10
    mini_batch_size: int = 64
    actor_lr: float = 3e-4
    critic_lr: float = 1e-3
    max_env_steps: int = 1_000_000
    rollout_batch_size: int = 4
    rollout_steps: int = 100
    # Alternation cadence (reference rarl.yaml).
    num_adv_iters: int = 1
    num_pro_iters: int = 1
    num_adversaries: int = 1  # >1 => RAP population


@dataclasses.dataclass
class Agent:
    """One PPO agent: actor (mean), critic, the state-independent logstd
    (a leaf tensor that requires grad) and the two Adams."""

    actor: MLP
    critic: MLP
    logstd: torch.Tensor
    actor_opt: Adam
    critic_opt: Adam


@dataclasses.dataclass
class RARLState:
    """Training state, updated in place by each phase."""

    pro: Agent
    adv: Union[Agent, List[Agent]]  # a list of num_adversaries agents for RAP
    env_state: Any
    obs: torch.Tensor
    total_steps: int = 0


_FIELDS = ("obs", "act", "logp", "ret", "adv")  # what a minibatch step reads


class RARL(BaseController):
    """RARL on the env's device (CUDA unless the env was built on the CPU)."""

    # ``pick_gen`` draws the adversary of a phase where there is a
    # population (RAP, or RARL given num_adversaries > 1).
    GENERATORS = ("gen", "pick_gen")

    def __init__(self, env, seed: int = 0, **kwargs):
        super().__init__(env, seed=seed)
        if env.config.adversary_disturbance is None:
            raise ValueError("RARL requires env adversary_disturbance to be set.")
        known = {f.name for f in dataclasses.fields(RARLConfig)}
        self.cfg = cfg = RARLConfig(**{k: v for k, v in kwargs.items() if k in known})
        self.device = dev = env.device
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.pick_gen = torch.Generator().manual_seed(seed)
        self.vec = make_vec_env(env, cfg.rollout_batch_size)
        self.set_adv = env.extras["set_adversary_control"]
        self.obs_dim = obs_dim = env.spaces.obs_dim
        self.act_dim = act_dim = env.spaces.action_dim
        # The adversary acts in [-1, 1]^dim of its channel (benchmark_env.py:328).
        self.adv_dim = {
            "action": act_dim,
            "dynamics": int(env.config.quad_type) if hasattr(env.config, "quad_type") else 1,
        }[env.config.adversary_disturbance]
        c = cfg.clip_param
        self._clip_lo = torch.tensor(1.0 - c, device=dev)
        self._clip_hi = torch.tensor(1.0 + c, device=dev)
        init = torch.Generator().manual_seed(seed)
        pro = self._make_agent(act_dim, init)
        if cfg.num_adversaries > 1:
            adv = [self._make_agent(self.adv_dim, init) for _ in range(cfg.num_adversaries)]
        else:
            adv = self._make_agent(self.adv_dim, init)
        env_state, obs, _ = self.vec.reset(seed=seed)
        self.state = RARLState(pro=pro, adv=adv, env_state=env_state, obs=obs)

    def _make_agent(self, adim, init):
        cfg, hidden = self.cfg, (self.cfg.hidden_dim, self.cfg.hidden_dim)
        actor = MLP(self.obs_dim, adim, hidden, act=cfg.activation, out_gain=0.01,
                    generator=init).to(self.device)
        critic = MLP(self.obs_dim, 1, hidden, act=cfg.activation, generator=init).to(self.device)
        logstd = torch.full((adim,), -0.5, device=self.device, requires_grad=True)
        inf = float("inf")
        return Agent(actor, critic, logstd, Adam(actor.parameters(), cfg.actor_lr, inf),
                     Adam(critic.parameters(), cfg.critic_lr, inf))

    # -- shared PPO machinery ---------------------------------------------------
    @staticmethod
    def _dist(agent: Agent, obs):
        return Normal(agent.actor(obs), torch.exp(agent.logstd))

    @staticmethod
    def _value(agent: Agent, obs):
        return agent.critic(obs)[..., 0]

    def _pick(self, pick=None):
        """RAP's adversary index for a phase (rap.py:38-470), from the CPU
        generator where ``pick`` is None; None without a population."""
        if self.cfg.num_adversaries <= 1:
            return None
        if pick is None:
            pick = int(torch.randint(0, self.cfg.num_adversaries, (1,), generator=self.pick_gen))
        return pick

    @torch.no_grad()
    def collect(self, state: RARLState, adv_inst: Agent, update_adversary: bool,
                pro_eps=None, adv_eps=None):
        """T steps of both agents (rarl.py:140-183 of the JAX package);
        ``pro_eps`` (T, B, act_dim) and ``adv_eps`` (T, B, adv_dim) the
        normals of the two samples, drawn where None.  The record is the
        updated agent's: its action, log-prob, value and reward (``-rew``
        for the adversary)."""
        recs = []
        for t in range(self.cfg.rollout_steps):
            pro_dist = self._dist(state.pro, state.obs)
            pro_act = _sample(pro_dist, self.gen, pro_eps, t)
            adv_dist = self._dist(adv_inst, state.obs)
            adv_act = _sample(adv_dist, self.gen, adv_eps, t)
            env_state = self.set_adv(state.env_state, adv_act)
            env_state, obs, rew, done, info = self.vec.step(env_state, pro_act)
            if update_adversary:
                agent, act, dist, r = adv_inst, adv_act, adv_dist, -rew
            else:
                agent, act, dist, r = state.pro, pro_act, pro_dist, rew
            tv = torch.where(info["TimeLimit.truncated"],
                             self._value(agent, info["terminal_observation"]),
                             torch.zeros_like(r))
            recs.append({"obs": state.obs, "act": act, "rew": r,
                         "mask": 1.0 - done.to(r.dtype), "v": self._value(agent, state.obs),
                         "logp": dist.log_prob(act), "terminal_v": tv})
            state.env_state, state.obs = env_state, obs
        return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}

    def gae(self, roll, last_val):
        """Returns and GAE advantages by a reversed loop over T
        (rarl.py:185-203)."""
        cfg = self.cfg
        rews = roll["rew"] + cfg.gamma * roll["terminal_v"]
        vals = torch.cat([roll["v"], last_val[None]], 0)
        ret, adv = last_val, torch.zeros_like(last_val)
        rets, advs = [], []
        for t in reversed(range(rews.shape[0])):
            mask = roll["mask"][t]
            ret = rews[t] + cfg.gamma * mask * ret
            td = rews[t] + cfg.gamma * mask * vals[t + 1] - vals[t]
            adv = adv * cfg.gae_lambda * cfg.gamma * mask + td
            rets.append(ret)
            advs.append(adv)
        return torch.stack(rets[::-1]), torch.stack(advs[::-1])

    def _unpack(self, rows, adim):
        out, o = {}, 0
        for f, w in zip(_FIELDS, (self.obs_dim, adim, 1, 1, 1)):
            out[f] = rows[:, o:o + w] if f in ("obs", "act") else rows[:, o]
            o += w
        return out

    def minibatch_step(self, agent: Agent, mb):
        """One minibatch of the clipped surrogate (rarl.py:215-250): Adam on
        the actor's MLP and SGD on ``logstd``, both behind the KL gate, then
        Adam on the critic.  Returns the approximate KL."""
        cfg = self.cfg
        actor_params = list(agent.actor.parameters())
        with torch.enable_grad():
            dist = self._dist(agent, mb["obs"])
            logp = dist.log_prob(mb["act"])
            ratio = torch.exp(logp - mb["logp"])
            clip_adv = clip_split(ratio, self._clip_lo, self._clip_hi) * mb["adv"]
            p_loss = -torch.minimum(ratio * mb["adv"], clip_adv).mean()
            kl = (mb["logp"] - logp).mean()
            loss = p_loss - cfg.entropy_coef * dist.entropy().mean()
            grads = torch.autograd.grad(loss, actor_params + [agent.logstd])
        kl = kl.detach()
        gate = torch.ones_like(kl) if cfg.target_kl <= 0 else (kl <= 1.5 * cfg.target_kl).to(
            kl.dtype)
        agent.actor_opt.step(grads[:-1], scale=gate)
        with torch.no_grad():
            agent.logstd.sub_(cfg.actor_lr * (grads[-1] * gate))
        with torch.enable_grad():
            v = self._value(agent, mb["obs"])
            c_loss = 0.5 * ((v - mb["ret"]) ** 2).mean()
            c_grads = torch.autograd.grad(c_loss, list(agent.critic.parameters()))
        agent.critic_opt.step(c_grads)
        return kl

    def ppo_update(self, agent: Agent, batch, perm=None):
        """``opt_epochs`` epochs of minibatch steps (rarl.py:205-265), each
        over a fresh permutation of the B * T samples cut to ``n_mini *
        mini_batch_size`` (``perm`` (opt_epochs, B * T) replaces the
        draws).  Returns the mean KL."""
        cfg = self.cfg
        cols = [batch[f].reshape(-1, *batch[f].shape[2:]) for f in _FIELDS]
        packed = torch.cat([c[:, None] if c.dim() == 1 else c for c in cols], 1)
        N, mb = packed.shape[0], cfg.mini_batch_size
        n_mini = max(N // mb, 1)
        adim = batch["act"].shape[-1]
        kls = []
        for e in range(cfg.opt_epochs):
            p = perm[e] if perm is not None else torch.randperm(N, generator=self.gen,
                                                                device=self.device)
            blocks = packed[p[:n_mini * mb]].reshape(n_mini, mb, -1)
            kls.append(torch.stack([self.minibatch_step(agent, self._unpack(blocks[i], adim))
                                    for i in range(n_mini)]).mean())
        return torch.stack(kls).mean()

    def _phase(self, state: RARLState, update_adversary: bool, draws=None):
        """One protagonist or adversary phase (rarl.py:267-290): pick the
        adversary, collect, GAE, standardize, update the phase's agent in
        place.  ``draws``: ``pick`` (RAP's index), ``pro_eps``, ``adv_eps``
        and ``perm``, each replacing the generator's draws."""
        draws = draws or {}
        i = self._pick(draws.get("pick"))
        adv_inst = state.adv if i is None else state.adv[i]
        roll = self.collect(state, adv_inst, update_adversary, draws.get("pro_eps"),
                            draws.get("adv_eps"))
        agent = adv_inst if update_adversary else state.pro
        with torch.no_grad():
            rets, advs = self.gae(roll, self._value(agent, state.obs))
            advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
        kl = self.ppo_update(agent, {**roll, "ret": rets, "adv": advs}, draws.get("perm"))
        state.total_steps += self.cfg.rollout_batch_size * self.cfg.rollout_steps
        return state, {"kl": kl}

    def _train_pro(self, state: RARLState, draws=None):
        """A protagonist phase; returns ``(state, {"kl"})``."""
        return self._phase(state, False, draws)

    def _train_adv(self, state: RARLState, draws=None):
        """An adversary phase; returns ``(state, {"kl"})``."""
        return self._phase(state, True, draws)

    def _train_step(self, state: RARLState):
        """One alternation cycle: ``num_pro_iters`` protagonist phases, then
        ``num_adv_iters`` adversary phases; the metrics of the last
        protagonist phase."""
        metrics = {"kl": torch.zeros((), device=self.device)}
        for _ in range(self.cfg.num_pro_iters):
            state, metrics = self._train_pro(state)
        for _ in range(self.cfg.num_adv_iters):
            state, _ = self._train_adv(state)
        return state, metrics

    # -- reference API --------------------------------------------------------
    def learn(self, max_env_steps: Optional[int] = None, **kwargs):
        cfg = self.cfg
        steps_target = max_env_steps or cfg.max_env_steps
        per_cycle = ((cfg.num_pro_iters + cfg.num_adv_iters) * cfg.rollout_batch_size
                     * cfg.rollout_steps)
        n_cycles = max(steps_target // per_cycle, 1)
        return {k: float(v) for k, v in self._learn_chunked(n_cycles, chunk=4).items()}

    @torch.no_grad()
    def select_action(self, obs, info=None):
        obs = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)
        return self._policy(obs).cpu().numpy()

    @torch.no_grad()
    def _policy(self, obs):
        return self.state.pro.actor(obs)


def _sample(dist: Normal, generator, eps, t):
    """A draw of ``dist``: ``loc + scale * eps[t]`` where normals are handed
    in (the JAX package's Normal.sample), else from ``generator``."""
    if eps is None:
        return dist.sample(generator)
    return dist.loc + dist.scale * eps[t]


class RAP(RARL):
    """RARL with a population of adversaries, one picked per phase
    (reference rap.py:38-470)."""

    def __init__(self, env, seed: int = 0, num_adversaries: int = 3, **kwargs):
        super().__init__(env, seed=seed, num_adversaries=num_adversaries, **kwargs)
