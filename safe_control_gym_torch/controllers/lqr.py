"""LQR controller.

Port of ``safe_control_gym_tpu/controllers/lqr.py`` (reference
safe_control_gym/controllers/lqr/lqr.py): linearize the env's a-priori
model (``env.symbolic``) at the goal, discretize, solve the Riccati
equation, u = -K (x - x0) + u0 (lqr.py:164-202).  For trajectory tracking
the reference solves one Riccati equation per step on the host
(lqr.py:176-181); here the gains of every waypoint are one batched solve on
the env's device at build time, and the controller is a gain-table lookup.
The gains are float32, as the goal state and input are (lqr.py:40-41 of the
JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.envs.benchmark import Task
from safe_control_gym_torch.ops.integrators import discretize_linear_system
from safe_control_gym_torch.ops.linalg import clqr_gain, dlqr_gain, get_cost_weight_matrix
from safe_control_gym_torch.parallel.vector import make_vec_env


class LQR(BaseController):
    def __init__(self, env, q_lqr=(1.0,), r_lqr=(1.0,), discrete_dynamics: bool = True,
                 **kwargs):
        super().__init__(env, **kwargs)
        self.model = model = env.symbolic
        f32 = dict(dtype=torch.float32, device=env.device)
        self.Q = torch.as_tensor(get_cost_weight_matrix(list(q_lqr), model.nx), **f32)
        self.R = torch.as_tensor(get_cost_weight_matrix(list(r_lqr), model.nu), **f32)
        self.discrete_dynamics = discrete_dynamics
        self.task = Task(env.config.task)
        self.u_0 = torch.as_tensor(np.asarray(env.u_goal), **f32)
        self.x_0 = torch.as_tensor(np.asarray(env.x_goal), **f32)
        if self.task == Task.STABILIZATION:
            self.gain = self.gains(self.x_0[None], self.u_0[None])[0]
        else:
            # One Riccati solve per waypoint, in one batch.
            self.gain = self.gains(self.x_0, self.u_0.expand(self.x_0.shape[0], -1))
        self._step_i = 0

    def gains(self, x0s, u0s):
        """The LQR gains (N, nu, nx) at the operating points (x0s, u0s)."""
        A, B = self.model.batch_linearize(x0s, u0s)
        if self.discrete_dynamics:
            Ad, Bd = discretize_linear_system(A, B, self.model.dt)
            return dlqr_gain(Ad, Bd, self.Q, self.R)[0]
        return clqr_gain(A, B, self.Q, self.R)[0]

    def reset(self):
        self._step_i = 0

    @torch.no_grad()
    def select_action(self, obs, info=None):
        """The action for ``obs`` (one state, or a batch) at the controller's
        step count, as NumPy; advances the count."""
        x = torch.as_tensor(np.array(obs, np.float32), device=self.env.device)
        a = self._policy_at(x, self._step_i).cpu().numpy()
        self._step_i += 1
        return a

    def _policy_at(self, x, k: int):
        """u = -K (x - x0) + u0 for states x (..., nx) at step ``k``."""
        if self.task == Task.STABILIZATION:
            return -(x - self.x_0) @ self.gain.mT + self.u_0
        k = min(max(k, 0), self.x_0.shape[0] - 1)
        return -(x - self.x_0[k]) @ self.gain[k].mT + self.u_0

    def _policy(self, obs):
        # The time-invariant view that run() uses (stabilization); tracking
        # evaluates with run_tracking.
        return self._policy_at(obs, 0)

    @torch.no_grad()
    def run_tracking(self, num_episodes: int = 1, seed: int = 0, env_seeds=None):
        """Batched tracking evaluation with the time-indexed gain table: one
        full episode of ``num_episodes`` envs, stepped without reset and
        without freezing done envs (as the JAX package's scan).  Returns
        per-episode returns and tracking RMSE (NumPy)."""
        vec = make_vec_env(self.env, num_episodes, auto_reset=False)
        state, obs, _ = vec.reset(seed=seed, env_seeds=env_seeds)
        rews, mses = [], []
        for k in range(self.env.max_episode_steps):
            state, obs, r, _, info = vec.step_no_reset(state, self._policy_at(obs, k))
            rews.append(r)
            mses.append(info["mse"])
        return {"ep_returns": torch.stack(rews).sum(0).cpu().numpy(),
                "rmse": torch.stack(mses).mean(0).sqrt().cpu().numpy()}
