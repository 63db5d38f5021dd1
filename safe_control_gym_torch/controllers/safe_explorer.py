"""Safe Explorer PPO (Dalal 2018 safety layer).

Port of ``safe_control_gym_tpu/controllers/safe_explorer.py`` (reference
safe_control_gym/controllers/safe_explorer/): per-constraint linear models
``c_{t+1} ~ c_t + g_w(s)' a`` fitted in a pretrain stage from random-action
transitions (safe_ppo.py:281-301, 435-462), then a closed-form action
projection applied to every sampled action (SafetyLayer.get_safe_action,
safe_explorer_utils.py:141-197):

    lambda_i* = max(0, (g_i' a + c_i + margin_i) / (g_i' g_i))
    a_safe    = a - lambda_{i*} g_{i*}   (the most-violating constraint only)

The projection is PPO's ``action_filter_fn``, so SafeExplorerPPO collects on
the general engine (the policy-in-kernel rollouts take no filter); on the
card its minibatch gradients come from K4.  The filter reads the safety
layer's current weights, so nothing is rebuilt after the pretrain.
"""

from __future__ import annotations

import torch

from safe_control_gym_torch.controllers.ppo import PPO
from safe_control_gym_torch.envs.constraints import build_constraints
from safe_control_gym_torch.models.networks import MLP
from safe_control_gym_torch.models.optim import Adam

PRETRAIN_EPOCHS = 100  # full-batch Adam epochs of the regression


class SafetyLayer:
    """Per-constraint linear sensitivity models g_w(s), fused into one MLP
    with nc * nu outputs (the reference builds a module list,
    safe_explorer_utils.py:60-80)."""

    def __init__(self, obs_dim, act_dim, num_constraints, hidden_dim=64, lr=1e-3, seed=0,
                 device=None):
        self.num_constraints = num_constraints
        self.act_dim = act_dim
        self.net = MLP(obs_dim, num_constraints * act_dim, (hidden_dim, hidden_dim), act="relu",
                       generator=torch.Generator().manual_seed(seed)).to(device)
        self.opt = Adam(self.net.parameters(), lr, float("inf"))

    def g(self, obs):
        return self.net(obs).reshape(obs.shape[:-1] + (self.num_constraints, self.act_dim))

    def get_safe_action(self, obs, act, c, margin=0.0):
        """Closed-form projection (safe_explorer_utils.py:141-197).  Ties in
        lambda pick the first constraint, as ``jnp.argmax`` does, so a row
        with no violation picks constraint 0 with lambda 0."""
        g = self.g(obs)  # (..., nc, nu)
        numer = (g * act[..., None, :]).sum(-1) + c + margin  # (..., nc)
        denom = (g * g).sum(-1) + 1e-8
        lam = torch.clamp_min(numer / denom, 0.0)
        worst = torch.argmax(lam, -1, keepdim=True)
        lam_star = torch.gather(lam, -1, worst)
        g_star = torch.gather(g, -2, worst[..., None].expand(*worst.shape, self.act_dim))[..., 0, :]
        return act - lam_star * g_star

    @torch.no_grad()
    def collect_dataset(self, vec_env, steps=200, seed=0, acts=None, env_seeds=None):
        """``steps`` random-action steps of ``vec_env`` from its reset
        (``seed``, or ``env_seeds``), with the reference's bookkeeping
        (safe_ppo.py:281-301): the transition (obs_t, a_t) regresses
        ``c_{t+1} - c_t`` and is weighted by ``~done_{t+1}``; the first step
        is dropped.  ``acts`` (steps, B, act_dim) replaces the uniform
        draws.  Returns (X, A, DC, W), concatenated once on the device."""
        state, obs, _ = vec_env.reset(seed=seed, env_seeds=env_seeds)
        B = obs.shape[0]
        gen = torch.Generator(device=obs.device).manual_seed(seed)
        obs_s, act_s, c_s, done_s = [], [], [], []
        for i in range(steps):
            act = acts[i] if acts is not None else torch.empty(
                (B, self.act_dim), device=obs.device).uniform_(-1.0, 1.0, generator=gen)
            state, obs2, _, done, info = vec_env.step(state, act)
            obs_s.append(obs)
            act_s.append(act)
            c_s.append(info["constraint_values"])
            done_s.append(done)
            obs = obs2
        c = torch.stack(c_s)
        X = torch.cat(obs_s[:-1])
        A = torch.cat(act_s[:-1])
        DC = (c[1:] - c[:-1]).reshape(-1, c.shape[-1])
        W = (~torch.stack(done_s[1:])).reshape(-1).to(X.dtype)
        return X, A, DC, W

    def fit(self, X, A, DC, W, epochs=PRETRAIN_EPOCHS):
        """Full-batch Adam on the weighted regression of ``DC`` on ``g(X)'
        A``; returns the last epoch's loss (a tensor, before its step)."""
        params = list(self.net.parameters())
        loss = None
        for _ in range(epochs):
            with torch.enable_grad():
                pred = (self.g(X) * A[:, None, :]).sum(-1)  # (N, nc)
                loss = (W[:, None] * (pred - DC) ** 2).mean()
                grads = torch.autograd.grad(loss, params)
            self.opt.step(grads)
        return loss.detach()

    def pretrain(self, vec_env, steps=200, seed=0):
        """Data collection and regression (the reference's pretrain loop);
        returns the last epoch's loss as a float."""
        return float(self.fit(*self.collect_dataset(vec_env, steps, seed)))


class SafeExplorerPPO(PPO):
    """PPO with the pretrained safety layer's projection on every sampled
    action (reference safe_ppo.py)."""

    def __init__(self, env, seed: int = 0, constraint_margin: float = 0.0,
                 pretrain_steps: int = 200, **kwargs):
        cc = build_constraints(env.config.constraints, env.spaces, env.device)
        if cc is None:
            raise ValueError("SafeExplorerPPO requires env constraints.")
        self._cc = cc
        obs_dim, act_dim = env.spaces.obs_dim, env.spaces.action_dim
        self.safety_layer = SafetyLayer(obs_dim, act_dim, cc.num_constraints, seed=seed,
                                        device=env.device)
        self.constraint_margin = constraint_margin
        self._pretrain_steps = pretrain_steps
        nx = env.spaces.state_dim

        def filter_fn(obs, act):
            c = cc.get_values_raw(obs[..., :nx], act)
            return self.safety_layer.get_safe_action(obs, act, c, constraint_margin)

        super().__init__(env, seed=seed, action_filter_fn=filter_fn, **kwargs)

    def pretrain(self):
        loss = self.safety_layer.pretrain(self.vec, steps=self._pretrain_steps, seed=self.seed)
        return {"pretrain_loss": loss}

    def learn(self, max_env_steps=None, **kwargs):
        self.pretrain()
        return super().learn(max_env_steps=max_env_steps, **kwargs)
