"""PPO (clipped surrogate) on the port's engines and kernels.

Port of ``safe_control_gym_tpu/controllers/ppo.py`` (reference
safe_control_gym/controllers/ppo/ppo.py + ppo_utils.py), with the same
semantics:

  * rollout over a vectorized env batch with optional obs/reward
    normalizers (ppo.py:247-276), or with ``use_fast_rollout=True`` the
    policy-in-kernel engine of the env's family, one launch per train step:
    K3 for the 3D quadrotor (``parallel/fast_policy.py``), K6 for CartPole
    (``parallel/fast_cartpole.py``), K8 for the 1D/2D quadrotors
    (``parallel/fast_quad_planar.py``);
  * time-truncation bootstrap ``rew += gamma * V(terminal obs)``
    (ppo.py:259-273);
  * returns/advantages by a reversed GAE loop with done masks
    (ppo_utils.py:428-456) and global advantage standardization;
  * clipped surrogate + entropy, the approximate-KL gate on the actor
    update (ppo_utils.py:128-161), optional clipped value loss;
  * a Gaussian policy with state-independent logstd initialized at -0.5.

The minibatch gradients come from ``torch.autograd`` of the two networks,
from ``torch.autograd`` of one fused 2H-wide network (``fused_update``, the
JAX package's A/B path), or, with ``use_fast_update``, from K4
(``parallel/fast_update.py``, one launch per minibatch).  The optimizers
repeat optax's ``clip_by_global_norm`` + ``adam`` (see :class:`Adam`).
Under ``parallel/distributed.py::sharded_train_step`` (data parallelism
over ranks) each rank computes its share of every minibatch and
``data_parallel`` sums the gradients and losses over the ranks before the
KL gate and the Adam steps; in one process it is None.
Where the JAX package carries a PRNG key in its state, the controller draws
from its own ``torch.Generator``; the state (:class:`PPOState`) is updated
in place.

Under a profiler a train step shows its phases as spans
(``utils/profiling.py::annotate``): ``scg.ppo.train_step`` around the
leaves ``collect``, ``gae``, ``pack``, ``shuffle``, ``gather``,
``transpose``, ``k4`` (the minibatch's gradients on any path) and
``optimizer`` (loss means, entropy term, sync, KL gate, Adam steps).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.models.distributions import Normal
from safe_control_gym_torch.models.networks import MLP
from safe_control_gym_torch.models.normalization import MeanStdNormalizer, RewardStdNormalizer
from safe_control_gym_torch.models.optim import Adam
from safe_control_gym_torch.envs.cartpole import CartPoleConfig
from safe_control_gym_torch.parallel import fast_cartpole, fast_env, fast_quad_planar
from safe_control_gym_torch.parallel.fast_policy import FastPolicyRollout, pack_weights
from safe_control_gym_torch.parallel.fast_update import (FastPPOUpdate, kernel_scope,
                                                         minibatch_layout, prep_weights)
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils.profiling import annotate

_UPDATE_FIELDS = ("obs", "act", "v", "logp", "ret", "adv")  # all the update reads
_BLK = 256  # samples per block of the one-shuffle-per-step permutation (ppo.py:625)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX package's fields and defaults (reference ppo.yaml).

    ``fused_update``: minibatch gradients through ONE 2H-wide network, the
    actor's and critic's hidden layers concatenated and the cross blocks
    structurally zero (:func:`fused_net`); both losses come from one
    autograd pass.  The parameters are disjoint and the losses add, so the
    gradients are the separate networks' (the JAX package's A/B path).  It
    conflicts with ``use_fast_update=True``, and "auto" leaves K4 off."""

    hidden_dim: int = 64
    activation: str = "tanh"
    norm_obs: bool = False
    norm_reward: bool = False
    clip_obs: float = 10.0
    clip_reward: float = 10.0
    gamma: float = 0.99
    use_gae: bool = False
    gae_lambda: float = 0.95
    use_clipped_value: bool = False
    clip_param: float = 0.2
    target_kl: float = 0.01
    entropy_coef: float = 0.01
    opt_epochs: int = 10
    mini_batch_size: int = 64
    reshuffle_each_epoch: bool = True
    fused_update: bool = False
    # "auto": K4 on a CUDA device when fast_update.kernel_scope holds
    # (tanh/relu, no clipped value loss, obs_dim <= 128, act_dim <= 8,
    # hidden_dim <= 256, minibatch a multiple of 8); True: K4 (its plain
    # version on the CPU); False: torch.autograd.
    use_fast_update: Any = "auto"
    actor_lr: float = 3e-4
    critic_lr: float = 1e-3
    max_grad_norm: float = 0.5
    max_env_steps: int = 1_000_000
    rollout_batch_size: int = 4
    rollout_steps: int = 100


class ActorCritic(nn.Module):
    """Actor MLP (mean), critic MLP (value) and the state-independent
    logstd (ppo_utils.py:186-187)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int, act: str,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.actor = MLP(obs_dim, act_dim, (hidden, hidden), act=act, out_gain=0.01,
                         generator=generator)
        self.critic = MLP(obs_dim, 1, (hidden, hidden), act=act, generator=generator)
        self.logstd = nn.Parameter(-0.5 * torch.ones(act_dim))

    def actor_params(self):
        """The actor's optimizer group: MLP params, then logstd."""
        return list(self.actor.parameters()) + [self.logstd]


def fused_net(ac: ActorCritic):
    """The actor and critic as one network of width 2H: [(W1, b1), (W2, b2),
    (W3, b3)] (weight (out, in)), the hidden layers concatenated actor
    first and the cross blocks zero, built from the parameters so that
    autograd reaches them (ppo.py:430-450)."""
    a, c = ac.actor.layers, ac.critic.layers
    if len(a) != 3 or len(c) != 3:
        raise ValueError("fused_update takes actor and critic MLPs of two hidden layers")
    return [(torch.cat([a[0].weight, c[0].weight], 0), torch.cat([a[0].bias, c[0].bias])),
            *[(torch.block_diag(a[i].weight, c[i].weight), torch.cat([a[i].bias, c[i].bias]))
              for i in (1, 2)]]


@dataclasses.dataclass
class PPOState:
    """Training state, updated in place by each train step."""

    ac: ActorCritic
    actor_opt: Adam
    critic_opt: Adam
    obs_norm: MeanStdNormalizer
    rew_norm: RewardStdNormalizer
    env_state: Any  # QuadState (general engine) or packed rows (fast rollout)
    obs: torch.Tensor
    total_steps: int = 0


def fast_rollout_engine(env_cfg):
    """The policy-in-kernel engine of an env config's family and whether the
    config is in its envelope (the JAX package's selection and asserts,
    ppo.py:159-210: the normalized action space, and the goal-horizon rows
    of the quadrotors; not the maze, which FastPolicyRollout takes but
    neither package's PPO sends it)."""
    if isinstance(env_cfg, CartPoleConfig):
        return (fast_cartpole.FastCartPolePolicyRollout,
                fast_cartpole.supports(env_cfg, allow_normalized=True))
    if not hasattr(env_cfg, "quad_type"):
        raise ValueError("use_fast_rollout supports CartPole and quadrotor configs, not "
                         f"{type(env_cfg).__name__}")
    if int(env_cfg.quad_type) in (1, 2):
        return (fast_quad_planar.FastPlanarQuadPolicyRollout,
                fast_quad_planar.supports(env_cfg, allow_normalized=True, allow_goal_horizon=True))
    return FastPolicyRollout, fast_env.supports(env_cfg, allow_normalized=True,
                                                allow_goal_horizon=True)


class PPO(BaseController):
    """PPO on the env's device (CUDA unless the env was built on the CPU).

    ``use_fast_rollout=True`` collects with the policy-in-kernel engine of
    the env's family (:func:`fast_rollout_engine`; running normalizers off;
    no action filter)."""

    GENERATORS = ("gen",)

    def __init__(self, env, seed: int = 0, output_dir: str = ".", action_filter_fn=None,
                 use_fast_rollout: bool = False, **kwargs):
        super().__init__(env, output_dir=output_dir, seed=seed)
        known = {f.name for f in dataclasses.fields(PPOConfig)}
        self.cfg = cfg = PPOConfig(**{k: v for k, v in kwargs.items() if k in known})
        self.device = dev = env.device
        self.use_fast_rollout = use_fast_rollout
        self.action_filter_fn = action_filter_fn
        self.data_parallel = None  # set for a step by distributed.sharded_train_step
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.vec = make_vec_env(env, cfg.rollout_batch_size)
        obs_dim, act_dim = env.spaces.obs_dim, env.spaces.action_dim
        self.obs_dim, self.act_dim = obs_dim, act_dim
        ac = ActorCritic(obs_dim, act_dim, cfg.hidden_dim, cfg.activation,
                         generator=torch.Generator().manual_seed(seed)).to(dev)
        self._fp = None
        if use_fast_rollout:
            if cfg.norm_obs or cfg.norm_reward:
                raise ValueError("the fast rollout does not implement running normalizers")
            if action_filter_fn is not None:
                raise ValueError("the fast rollout takes no action filter")
            engine, in_envelope = fast_rollout_engine(env.config)
            if not in_envelope:
                raise ValueError(f"env config outside the envelope of {engine.__name__} "
                                 "(supports(cfg, allow_normalized=True, ...))")
            self._fp = engine(env, cfg.rollout_batch_size, cfg.rollout_steps,
                              mlp_hidden=cfg.hidden_dim, mlp_act=cfg.activation, device=dev)
            if self._fp.obs_dim != obs_dim:
                raise ValueError(f"the fast rollout's observation ({self._fp.obs_dim}) is not "
                                 f"the env's ({obs_dim})")
            env_state = self._fp.reset(seed)
            # The initial observation carries the configured observation
            # noise, as the general engine's reset does (ppo.py:220-222).
            obs = self._fp.observe(env_state, generator=self.gen)
        else:
            env_state, obs, _ = self.vec.reset(seed=seed)
        self.state = PPOState(
            ac=ac,
            actor_opt=Adam(ac.actor_params(), cfg.actor_lr, cfg.max_grad_norm),
            critic_opt=Adam(ac.critic.parameters(), cfg.critic_lr, cfg.max_grad_norm),
            obs_norm=MeanStdNormalizer((obs_dim,), clip=cfg.clip_obs, device=dev),
            rew_norm=RewardStdNormalizer(cfg.rollout_batch_size, gamma=cfg.gamma,
                                         clip=cfg.clip_reward, device=dev),
            env_state=env_state,
            obs=obs,
        )
        use_fu = cfg.use_fast_update
        if use_fu == "auto":
            # An explicit fused_update wins over "auto" (ppo.py:245).
            use_fu = dev.type == "cuda" and not cfg.fused_update and kernel_scope(
                obs_dim, act_dim, cfg.hidden_dim, cfg.activation, cfg.mini_batch_size,
                cfg.use_clipped_value)
        if use_fu and cfg.fused_update:
            raise ValueError("use_fast_update=True conflicts with fused_update=True")
        # FastPPOUpdate raises for a shape outside K4's scope.
        self._fu = FastPPOUpdate(cfg.mini_batch_size, cfg.hidden_dim, cfg.activation,
                                 cfg.clip_param, obs_dim=obs_dim, act_dim=act_dim,
                                 clipped_value=cfg.use_clipped_value) if use_fu else None

    # -- policy ---------------------------------------------------------------
    def _dist(self, ac: ActorCritic, obs):
        return Normal(ac.actor(obs), torch.exp(ac.logstd))

    def _value(self, ac: ActorCritic, obs):
        return ac.critic(obs)[..., 0]

    # -- train step -----------------------------------------------------------
    @torch.no_grad()
    def collect(self, state: PPOState, eps=None):
        """T steps of the general engine, sampling from the controller's
        generator (ppo.py:289-329); ``eps`` (T, B, act_dim) replaces the
        sample's normals (``mean + std * eps``, the JAX package's
        Normal.sample)."""
        cfg, ac = self.cfg, state.ac
        recs = []
        with annotate("scg.ppo.collect"):
            for t in range(cfg.rollout_steps):
                dist = self._dist(ac, state.obs)
                act = dist.sample(self.gen) if eps is None else dist.loc + dist.scale * eps[t]
                if self.action_filter_fn is not None:
                    act = self.action_filter_fn(state.obs, act)
                logp = dist.log_prob(act)
                v = self._value(ac, state.obs)
                env_state, next_obs, rew, done, info = self.vec.step(state.env_state, act)
                if cfg.norm_obs:
                    next_obs, _ = state.obs_norm(next_obs)
                if cfg.norm_reward:
                    rew, _ = state.rew_norm(rew, done)
                # Truncation bootstrap (ppo.py:259-273).
                term_v = torch.where(info["TimeLimit.truncated"],
                                     self._value(ac, info["terminal_observation"]),
                                     torch.zeros_like(rew))
                recs.append({"obs": state.obs, "act": act, "rew": rew,
                             "mask": 1.0 - done.to(rew.dtype), "v": v, "logp": logp,
                             "terminal_v": term_v})
                state.env_state, state.obs = env_state, next_obs
            return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}

    @torch.no_grad()
    def collect_fast(self, state: PPOState):
        """The whole rollout in one launch of the policy engine (K3, K6 or
        K8; ppo.py:331-363)."""
        fp, ac = self._fp, state.ac
        with annotate("scg.ppo.collect"):
            seed = torch.randint(0, 2**31 - 1, (1,), generator=self.gen, device=self.device,
                                 dtype=torch.int32)
            rows, traj = fp.run(state.env_state, pack_weights(ac.actor, ac.critic, ac.logstd),
                                seed=seed)
            d = fp.unpack_traj(traj)
            # Truncation bootstrap from the stored terminal observations (the
            # kernels mask them to truncated steps).
            term_v = torch.where(d["trunc"] > 0.0, self._value(ac, d["term_obs"]),
                                 torch.zeros_like(d["rew"]))
            # The bootstrap observation carries the observation noise, as the
            # general engine's (ppo.py:358-361).
            state.env_state, state.obs = rows, fp.observe(rows, generator=self.gen)
        return {"obs": d["obs"], "act": d["act"], "rew": d["rew"], "mask": d["mask"],
                "v": d["v"], "logp": d["logp"], "terminal_v": term_v}

    def gae(self, roll, last_val):
        """Returns and advantages by a reversed loop over T (ppo.py:365-387,
        ppo_utils.py:428-456)."""
        cfg = self.cfg
        rews = roll["rew"] + cfg.gamma * roll["terminal_v"]
        vals = torch.cat([roll["v"], last_val[None]], 0)
        ret, adv = last_val, torch.zeros_like(last_val)
        rets, advs = [], []
        for t in reversed(range(rews.shape[0])):
            mask = roll["mask"][t]
            ret = rews[t] + cfg.gamma * mask * ret
            if cfg.use_gae:
                td = rews[t] + cfg.gamma * mask * vals[t + 1] - vals[t]
                adv = adv * cfg.gae_lambda * cfg.gamma * mask + td
            else:
                adv = ret - vals[t]
            rets.append(ret)
            advs.append(adv)
        return torch.stack(rets[::-1]), torch.stack(advs[::-1])

    def _block_index(self, N, perm):
        """(n_mini, mb) sample indices of the one shuffle of
        reshuffle_each_epoch=False (ppo.py:609-637): a permutation of
        256-sample blocks when shapes allow, expanded to their samples, else
        of samples.  ``perm`` (optional) is that permutation."""
        mb = self.cfg.mini_batch_size
        n_mini = max(N // mb, 1)
        take = n_mini * mb
        blocks = take == N and N % _BLK == 0 and mb % _BLK == 0
        with annotate("scg.ppo.shuffle"):
            if perm is None:
                perm = torch.randperm(N // _BLK if blocks else N, generator=self.gen,
                                      device=self.device)
            if blocks:
                perm = (perm[:, None] * _BLK + torch.arange(_BLK, device=perm.device)).reshape(-1)
            return perm[:take].reshape(n_mini, mb)

    def _minibatches(self, packed, idx):
        """The minibatches of the packed rows that ``idx`` ((n_mini, mb)
        sample indices) picks, as the step takes them: for K4 its batch-last
        (n_mini, F, m) blocks from ``fast_update.minibatch_layout`` (one
        kernel launch on the card, the plain gather and transpose on the
        CPU), else (n_mini, m, F) rows; m = mb, or under ``data_parallel``
        this rank's share of each minibatch's samples."""
        with annotate("scg.ppo.gather"):
            if self.data_parallel is not None:  # this rank's samples of every minibatch
                idx = self.data_parallel.share(idx)
            mbs = minibatch_layout(packed, idx) if self._fu is not None else packed[idx]
        # Opens empty (K4's layout is one operation, in the gather): the
        # benchmark's span test still lists this leaf.
        with annotate("scg.ppo.transpose"):
            return mbs

    def update(self, state: PPOState, batch, perm=None):
        """``opt_epochs`` epochs of minibatch steps on ``batch`` ((T, B, ...)
        fields).  ``perm`` replaces the controller's own shuffle: with
        ``reshuffle_each_epoch=False`` the one permutation of
        :meth:`_block_index`, else one permutation of the N samples per
        epoch ((opt_epochs, N)).  Returns the metrics averaged over
        minibatches and epochs."""
        cfg = self.cfg
        with annotate("scg.ppo.pack"):
            cols = [batch[f].reshape(-1, *batch[f].shape[2:]) for f in _UPDATE_FIELDS]
            packed = torch.cat([c[:, None] if c.dim() == 1 else c for c in cols],
                               1).to(torch.float32)
        N, mb = packed.shape[0], cfg.mini_batch_size
        n_mini = max(N // mb, 1)
        step = (self.minibatch_step_kernel if self._fu is not None else
                self.minibatch_step_fused if cfg.fused_update else self.minibatch_step)
        blocks = (None if cfg.reshuffle_each_epoch else
                  self._minibatches(packed, self._block_index(N, perm)))
        epochs = []
        for e in range(cfg.opt_epochs):
            if cfg.reshuffle_each_epoch:
                with annotate("scg.ppo.shuffle"):
                    p = perm[e] if perm is not None else torch.randperm(
                        N, generator=self.gen, device=self.device)
                blocks = self._minibatches(packed, p[:n_mini * mb].reshape(n_mini, mb))
            epochs.append(torch.stack([step(state, blocks[i]) for i in range(n_mini)]).mean(0))
        m = torch.stack(epochs).mean(0)
        return {"policy_loss": m[0], "value_loss": m[1], "entropy_loss": m[2], "approx_kl": m[3]}

    def _unpack(self, rows):
        """(mb, F) packed rows -> field dict: obs (mb, obs_dim) and act
        (mb, act_dim), a single action included; the rest (mb,)."""
        out, o = {}, 0
        for f, w in zip(_UPDATE_FIELDS, (self.obs_dim, self.act_dim, 1, 1, 1, 1)):
            out[f] = rows[:, o:o + w] if f in ("obs", "act") else rows[:, o]
            o += w
        return out

    def _clip_ratio(self, ratio):
        """``jnp.clip`` as JAX writes it, a maximum then a minimum: at a ratio
        exactly on a bound the gradient splits, as jax.grad's does."""
        c = self.cfg.clip_param
        lo = torch.full((), 1.0 - c, device=ratio.device)
        hi = torch.full((), 1.0 + c, device=ratio.device)
        return torch.minimum(torch.maximum(ratio, lo), hi)

    def _kl_gate(self, kl):
        """KL gate (ppo_utils.py:139-144) as a float 0/1 tensor.  It zeroes
        the actor's gradients, but Adam still steps: its moments decay and
        its count advances, so the params still move (ppo.py:515-521)."""
        tk = self.cfg.target_kl
        return torch.ones_like(kl) if tk <= 0 else (kl <= 1.5 * tk).to(kl.dtype)

    def _sync(self, grads, losses):
        """A minibatch's gradients and its (policy, value, entropy, KL) loss
        means over every rank's share (``data_parallel.sync``); the identity
        in one process."""
        if self.data_parallel is None:
            return list(grads), losses
        return self.data_parallel.sync(list(grads), losses)

    def minibatch_step(self, state: PPOState, mb_rows):
        """Gradients by torch.autograd of the reference losses
        (ppo.py:529-581)."""
        cfg, ac = self.cfg, state.ac
        with annotate("scg.ppo.k4"), torch.enable_grad():
            mb = self._unpack(mb_rows)
            p_loss, e_loss, v_loss, kl = self._losses(ac.actor(mb["obs"]), ac.logstd,
                                                      self._value(ac, mb["obs"]), mb)
            ga = torch.autograd.grad(p_loss + cfg.entropy_coef * e_loss, ac.actor_params())
            gc = torch.autograd.grad(v_loss, list(ac.critic.parameters()))
        with annotate("scg.ppo.optimizer"):
            g, losses = self._sync(ga + gc, torch.stack([p_loss, v_loss, e_loss, kl]).detach())
            state.actor_opt.step(g[:len(ga)], scale=self._kl_gate(losses[3]))
            state.critic_opt.step(g[len(ga):])
        return losses

    def _losses(self, mean, logstd, v_cur, mb):
        """(policy, entropy, value) losses and the approximate KL of one
        minibatch from the actor's means and the critic's values
        (ppo.py:529-581)."""
        cfg = self.cfg
        dist = Normal(mean, torch.exp(logstd))
        logp = dist.log_prob(mb["act"])
        ratio = torch.exp(logp - mb["logp"])
        clip_adv = self._clip_ratio(ratio) * mb["adv"]
        p_loss = -torch.minimum(ratio * mb["adv"], clip_adv).mean()
        e_loss = -dist.entropy().mean()
        kl = (mb["logp"] - logp).mean()
        if cfg.use_clipped_value:
            v_old_c = mb["v"] + torch.clamp(v_cur - mb["v"], -cfg.clip_param, cfg.clip_param)
            v_loss = 0.5 * torch.maximum((v_cur - mb["ret"]) ** 2,
                                         (v_old_c - mb["ret"]) ** 2).mean()
        else:
            v_loss = 0.5 * ((v_cur - mb["ret"]) ** 2).mean()
        return p_loss, e_loss, v_loss, kl

    def minibatch_step_fused(self, state: PPOState, mb_rows):
        """Both losses through the fused 2H-wide network and one autograd
        pass (ppo.py:420-495)."""
        cfg, ac = self.cfg, state.ac
        actor, critic = ac.actor_params(), list(ac.critic.parameters())
        with annotate("scg.ppo.k4"), torch.enable_grad():
            mb = self._unpack(mb_rows)
            h = mb["obs"]
            layers = fused_net(ac)
            for w, b in layers[:-1]:
                h = ac.actor.act(F.linear(h, w, b))
            out = F.linear(h, *layers[-1])
            p_loss, e_loss, v_loss, kl = self._losses(out[:, :self.act_dim], ac.logstd,
                                                      out[:, self.act_dim], mb)
            grads = torch.autograd.grad(p_loss + cfg.entropy_coef * e_loss + v_loss,
                                        actor + critic)
        with annotate("scg.ppo.optimizer"):
            grads, losses = self._sync(grads,
                                       torch.stack([p_loss, v_loss, e_loss, kl]).detach())
            state.actor_opt.step(grads[:len(actor)], scale=self._kl_gate(losses[3]))
            state.critic_opt.step(grads[len(actor):])
        return losses

    def minibatch_step_kernel(self, state: PPOState, mb_T):
        """Gradients from K4 (ppo.py:496-527); the KL gate, the entropy term
        and the Adam steps stay outside (they are parameter-sized)."""
        cfg, ac = self.cfg, state.ac
        with annotate("scg.ppo.k4"):
            ga, gc, glogstd, sums = self._fu.grads(mb_T,
                                                   prep_weights(ac.actor, ac.critic, ac.logstd))
        with annotate("scg.ppo.optimizer"):
            n = mb_T.shape[1]
            p_loss, kl, v_loss = -sums[0] / n, sums[1] / n, 0.5 * sums[2] / n
            with torch.no_grad():
                # Gaussian entropy depends on logstd alone: its loss and
                # gradient are closed form, d(-coef * entropy)/d logstd = -coef.
                e_loss = -(ac.logstd.sum()
                           + 0.5 * self.act_dim * (1.0 + math.log(2.0 * math.pi)))
            names = [k for k, _ in ac.actor.named_parameters()]
            g, losses = self._sync([ga[k] for k in names] + [glogstd]
                                   + [gc[k] for k, _ in ac.critic.named_parameters()],
                                   torch.stack([p_loss, v_loss, e_loss, kl]))
            g[len(names)] = g[len(names)] - cfg.entropy_coef
            state.actor_opt.step(g[:len(names) + 1], scale=self._kl_gate(losses[3]))
            state.critic_opt.step(g[len(names) + 1:])
        return losses

    def _train_step(self, state: PPOState, eps=None, perm=None):
        """Collect, GAE, advantage standardization, update (ppo.py:658-666).
        ``eps`` (the general engine's sample normals, :meth:`collect`; the
        fast rollout draws in its kernel) and ``perm`` (:meth:`update`)
        replace the generator's draws.  Returns
        ``(state, metrics)``; ``state`` is updated in place."""
        with annotate("scg.ppo.train_step"):
            roll = self.collect_fast(state) if self._fp is not None else self.collect(state, eps)
            return self.update_from(state, roll, None, perm)

    def update_from(self, state: PPOState, roll, last_val=None, perm=None):
        """GAE, the advantage standardization over the whole batch and the
        update on a collected rollout (``roll``: (T, B, ...) fields of
        :meth:`collect`; ``last_val``: (B,) values of the observations that
        follow it, by default the critic's of ``state.obs``).  Returns
        ``(state, metrics)``."""
        cfg = self.cfg
        with annotate("scg.ppo.gae"), torch.no_grad():
            if last_val is None:
                last_val = self._value(state.ac, state.obs)
            rets, advs = self.gae(roll, last_val)
            # jnp.std is the population std; torch.std defaults to correction=1.
            advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
        batch = {**roll, "ret": rets, "adv": advs}
        metrics = self.update(state, batch) if perm is None else self.update(state, batch, perm)
        state.total_steps += cfg.rollout_batch_size * cfg.rollout_steps
        return state, metrics

    # -- reference API --------------------------------------------------------
    def learn(self, max_env_steps: Optional[int] = None, log_fn=None, **kwargs):
        steps_target = max_env_steps or self.cfg.max_env_steps
        per_iter = self.cfg.rollout_batch_size * self.cfg.rollout_steps
        n_iters = max(steps_target // per_iter, 1)
        if log_fn is None:
            return {k: float(v) for k, v in self._learn_chunked(n_iters).items()}
        metrics = {}
        for _ in range(n_iters):
            self.state, metrics = self._train_step(self.state)
            log_fn(self.state.total_steps, {k: float(v) for k, v in metrics.items()})
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def select_action(self, obs, info=None):
        obs = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)
        return self._policy(obs).cpu().numpy()

    @torch.no_grad()
    def _policy(self, obs):
        if self.cfg.norm_obs:
            obs, _ = self.state.obs_norm(obs, update=False)
        return self._dist(self.state.ac, obs).mode()
