"""PPO's train step in plain PyTorch: rollout, returns, the clipped update.

One train step (upstream ``safe_control_gym/controllers/ppo``): T policy
steps of B envs with auto-reset and the time-limit bootstrap, returns by a
reversed loop (GAE where the configuration asks), advantages standardized
over the batch, then ``opt_epochs`` epochs of minibatch steps, each the
clipped surrogate with the entropy bonus (actor) and the value MSE
(critic) by ``torch.autograd``, the approximate-KL gate on the actor, and
optax's ``clip_by_global_norm`` and Adam on each network.

The random draws come from the job's seed alone: the envs' reset streams,
the Philox stream of each rollout keyed by a seed drawn from a
``torch.Generator`` on the device seeded with the job seed, and from the
same generator one permutation of the samples an epoch, in the order a
train step draws them.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import envs, policy, rng


@dataclasses.dataclass
class EnvBatch:
    """B envs: state rows, inertial rows, control-step rows, episode
    indices and seeds (uint32 words)."""

    s: list
    inert: list
    step_f: torch.Tensor
    ep: torch.Tensor
    seed: torch.Tensor


def reset(p, env_seed):
    ep = torch.zeros_like(env_seed)
    s, inert = envs.episode_draws(p, env_seed, ep)
    return EnvBatch(s, inert, torch.zeros(env_seed.shape, device=env_seed.device), ep, env_seed)


@torch.no_grad()
def rollout(p, act_name, w, seed, batch: EnvBatch, T: int, precision: str):
    """T policy steps of ``batch`` with auto-reset under the Philox stream
    of ``seed``: the records (T, B, ...) of obs, act, rew, mask, v, logp,
    done, trunc, terminal obs and its value, and the batch after them."""
    B = batch.step_f.shape[0]
    env = torch.arange(B, device=batch.step_f.device)
    s, inert, step_f, ep = batch.s, batch.inert, batch.step_f, batch.ep
    keys = ("obs", "act", "rew", "mask", "v", "logp", "done", "trunc", "term", "term_v")
    recs = {k: [] for k in keys}
    for t in range(T):
        obs = torch.stack(s, 1)
        mean, v = policy.forward(w, obs, act_name, precision)
        act, logp = policy.sample(mean, w["logstd"], seed, t, env)
        s_post, rew, done, trunc, _ = envs.step(p, s, inert, step_f, list(act.unbind(1)))
        term = torch.stack(s_post, 1) * trunc[:, None].to(torch.float32)
        term_v = torch.where(trunc, policy.forward(w, term, act_name, precision)[1],
                             torch.zeros_like(rew))
        donef = done.to(torch.float32)
        for k, x in zip(keys, (obs, act, rew, 1.0 - donef, v, logp, donef,
                               trunc.to(torch.float32), term, term_v)):
            recs[k].append(x)
        # Auto-reset: the next episode's draws where the step ended one.
        ep = ep + done.to(torch.int64)
        s_new, in_new = envs.episode_draws(p, batch.seed, ep)
        s = [torch.where(done, a, b) for a, b in zip(s_new, s_post)]
        inert = [torch.where(done, a, b) for a, b in zip(in_new, inert)]
        step_f = torch.where(done, torch.zeros_like(step_f), step_f + 1.0)
    return {k: torch.stack(v) for k, v in recs.items()}, EnvBatch(s, inert, step_f, ep, batch.seed)


class Adam:
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr))`` in place."""

    def __init__(self, params, lr, max_norm, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.max_norm = params, lr, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        self.count += 1
        c1, c2 = 1.0 - self.b1**self.count, 1.0 - self.b2**self.count
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            g = g * scale
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.add_((m / c1) / (torch.sqrt(v / c2) + self.eps), alpha=-self.lr)


class TrainJob:
    """The reference's copy of a PPO job: weights ``w`` (a dict of
    :data:`policy.LEAVES`, copied), B envs reset from ``seed``, rollouts of
    T steps, minibatches of ``mb`` samples.

    ``fault`` plants one of the faults a check must catch: ``"half_batch"``
    (each minibatch's second half left out, the means over the rest) or
    ``"reward_t0"`` (the rollout's rewards of its first step zeroed)."""

    def __init__(self, family, env_cfg, ppo_cfg, w, seed, B, T, mb, device,
                 precision="float32", fault=None):
        self.p = envs.params(family, env_cfg)
        self.cfg, self.B, self.T, self.mb = ppo_cfg, B, T, mb
        self.precision, self.fault, self.device = precision, fault, device
        self.w = {k: w[k].detach().clone().to(device) for k in policy.LEAVES}
        self.opt_a = Adam([self.w[k] for k in policy.ACTOR], ppo_cfg["actor_lr"],
                          ppo_cfg["max_grad_norm"])
        self.opt_c = Adam([self.w[k] for k in policy.CRITIC], ppo_cfg["critic_lr"],
                          ppo_cfg["max_grad_norm"])
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.envs = reset(self.p, rng.env_seeds(seed, B, device))
        self.first_grads = None  # what each optimizer took at its first step

    def _value(self, obs):
        return policy.forward(self.w, obs, self.cfg["activation"], self.precision)[1]

    @torch.no_grad()
    def rollout(self):
        seed = torch.randint(0, 2**31 - 1, (1,), generator=self.gen, device=self.device,
                             dtype=torch.int32)
        recs, self.envs = rollout(self.p, self.cfg["activation"], self.w, seed, self.envs, self.T,
                                  self.precision)
        if self.fault == "reward_t0":
            recs["rew"][0] = 0.0
        return recs

    @torch.no_grad()
    def returns(self, roll):
        cfg = self.cfg
        last_val = self._value(torch.stack(self.envs.s, 1))
        rews = roll["rew"] + cfg["gamma"] * roll["term_v"]
        vals = torch.cat([roll["v"], last_val[None]], 0)
        ret, adv = last_val, torch.zeros_like(last_val)
        rets, advs = [], []
        for t in reversed(range(self.T)):
            mask = roll["mask"][t]
            ret = rews[t] + cfg["gamma"] * mask * ret
            if cfg["use_gae"]:
                td = rews[t] + cfg["gamma"] * mask * vals[t + 1] - vals[t]
                adv = adv * cfg["gae_lambda"] * cfg["gamma"] * mask + td
            else:
                adv = ret - vals[t]
            rets.append(ret)
            advs.append(adv)
        adv = torch.stack(advs[::-1])
        return torch.stack(rets[::-1]), (adv - adv.mean()) / (adv.std(correction=0) + 1e-6)

    def minibatch(self, d):
        cfg, w = self.cfg, self.w
        if self.fault == "half_batch":
            d = {k: v[: v.shape[0] // 2] for k, v in d.items()}
        leaves = {k: w[k].detach().requires_grad_(True) for k in policy.LEAVES}
        with torch.enable_grad():
            mean, v = policy.forward(leaves, d["obs"], cfg["activation"], self.precision)
            logp = policy.log_prob(mean, leaves["logstd"], d["act"])
            ratio = torch.exp(logp - d["logp"])
            clipped = torch.clamp(ratio, 1.0 - cfg["clip_param"], 1.0 + cfg["clip_param"])
            p_loss = -torch.minimum(ratio * d["adv"], clipped * d["adv"]).mean()
            e_loss = -policy.entropy(leaves["logstd"])
            v_loss = 0.5 * ((v - d["ret"]) ** 2).mean()
            ga = torch.autograd.grad(p_loss + cfg["entropy_coef"] * e_loss,
                                     [leaves[k] for k in policy.ACTOR])
            gc = torch.autograd.grad(v_loss, [leaves[k] for k in policy.CRITIC])
        kl = (d["logp"] - logp).mean().detach()
        tk = cfg["target_kl"]
        gate = (kl <= 1.5 * tk).to(kl.dtype) if tk > 0 else torch.ones_like(kl)
        ga = [g * gate for g in ga]
        self.opt_a.step(ga)
        self.opt_c.step(gc)
        if self.first_grads is None:
            self.first_grads = {k: m / (1.0 - self.opt_a.b1) for k, m in
                                zip(policy.ACTOR + policy.CRITIC, self.opt_a.mu + self.opt_c.mu)}
        return torch.stack([p_loss.detach(), v_loss.detach(), e_loss.detach(), kl])

    def train_step(self):
        """One train step; returns its (policy, value, entropy, KL) losses,
        means over the minibatches and epochs."""
        roll = self.rollout()
        ret, adv = self.returns(roll)
        data = {"obs": roll["obs"].reshape(-1, roll["obs"].shape[-1]),
                "act": roll["act"].reshape(-1, roll["act"].shape[-1]),
                "logp": roll["logp"].reshape(-1), "ret": ret.reshape(-1), "adv": adv.reshape(-1)}
        N = data["logp"].shape[0]
        n_mini = max(N // self.mb, 1)
        epochs = []
        for _ in range(self.cfg["opt_epochs"]):
            perm = torch.randperm(N, generator=self.gen, device=self.device)
            idx = perm[: n_mini * self.mb].reshape(n_mini, self.mb)
            epochs.append(torch.stack([self.minibatch({k: v[i] for k, v in data.items()})
                                       for i in idx]).mean(0))
        return torch.stack(epochs).mean(0)
