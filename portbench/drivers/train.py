"""Train traffic: PPO train steps back to back on one card.

Set-up builds one ``PPO`` with the policy kernel's rollout
(``use_fast_rollout=True``) and K4's update where it applies, loads the
weights made from the seed, and drives its first ``check_steps`` train
steps through the window's own call (``PPO.train_many(1)``); the window
goes on from there with the same object.  The check follows those first
steps with the plain reference (:mod:`portbench.reference.check`).

Traffic keys: ``num_envs``, ``rollout_steps``, ``minibatches`` (of one
epoch), ``check_steps``, ``trace_units``.
"""

from __future__ import annotations

import gc

import torch

from portbench import harness
from portbench.drivers import common
from portbench.reference import check, policy


class Job:
    def __init__(self, cell, seed: int, device):
        from safe_control_gym_torch.controllers.ppo import PPO

        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.B, self.T = int(tr["num_envs"]), int(tr["rollout_steps"])
        self.mb = self.B * self.T // int(tr["minibatches"])
        self.ppo = PPO(common.build_env(cfg, device), seed=seed, use_fast_rollout=True,
                       rollout_batch_size=self.B, rollout_steps=self.T,
                       mini_batch_size=self.mb, **cfg["ppo"])
        self.w0 = common.make_weights(seed, self.ppo.obs_dim, self.ppo.act_dim,
                                      int(cfg["ppo"]["hidden_dim"]), device)
        common.load_weights(self.ppo.state.ac, self.w0)
        self.first = {}
        self._record_first(self.ppo.state.actor_opt, policy.ACTOR)
        self._record_first(self.ppo.state.critic_opt, policy.CRITIC)
        self.step = self.ppo.train_many(1)
        self.losses = []
        for _ in range(int(tr["check_steps"])):
            self.unit()
            self.losses.append(torch.stack([self.metrics[k] for k in check.LOSS_KEYS]))
        self.w_n = {k: v.detach().clone()
                    for k, v in common.program_leaves(self.ppo.state.ac).items()}
        self.unit_env_steps = self.B * self.T

    def _record_first(self, opt, names):
        """Keep the gradients ``opt`` takes at its first step, read back from
        its first moment, then leave the optimizer as it was."""
        def first_step(grads, scale=None):
            del opt.step
            opt.step(grads, scale=scale)
            self.first.update({k: m / (1.0 - opt.b1) for k, m in zip(names, opt.mu)})

        opt.step = first_step

    def unit(self):
        self.ppo.state, self.metrics = self.step(self.ppo.state)

    def end_to_end(self, wall: float, units: int, unit_ms):
        return {"train_env_steps_per_s": units * self.unit_env_steps / wall,
                "train_step_p95_ms": harness.p95(unit_ms)}

    def free(self):
        del self.ppo, self.step, self.metrics
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def observed(self):
        return {"losses": self.losses, "first": self.first, "w0": self.w0, "wn": self.w_n}

    def check(self):
        ref = check.train_reference(self.cell, self.w0, self.seed, self.device,
                                    len(self.losses))
        return check.train_numbers(self.observed(), ref, self.cell.config["ppo"])
