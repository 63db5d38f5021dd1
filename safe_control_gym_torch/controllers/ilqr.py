"""iLQR controller.

Port of ``safe_control_gym_tpu/controllers/ilqr.py`` (reference
safe_control_gym/controllers/lqr/ilqr.py):

  * the initial policy is the LQR gain at the goal (ilqr.py:472-514);
  * the forward rollout applies per-step feedback gains and feedforward;
  * the backward pass runs on the RK4-discretized linearization, with the
    eigenvalue-clipped, lambda-regularized inverse of H (ilqr.py:443-452);
  * lambda decreases by lamb_factor on a cost improvement and increases
    otherwise; the loop ends at lamb_max or at a small relative improvement
    (ilqr.py:260-370).

The linearization along the trajectory is one batched ``torch.func`` call;
the lambda loop runs on the host and reads the cost once an iteration, as
the reference's and the JAX package's do.  On a card, each step of the
backward pass's ``eigh`` also synchronizes with the host (its error check).
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.envs.benchmark import Task
from safe_control_gym_torch.ops.integrators import discretize_linear_system
from safe_control_gym_torch.ops.linalg import dlqr_gain, get_cost_weight_matrix


class iLQR(BaseController):
    def __init__(
        self,
        env,
        q_lqr=(1.0,),
        r_lqr=(1.0,),
        max_iterations: int = 15,
        lamb_factor: float = 10.0,
        lamb_max: float = 1000.0,
        epsilon: float = 0.01,
        **kwargs,
    ):
        super().__init__(env, **kwargs)
        self.model = env.symbolic
        self.device = env.device
        self.task = Task(env.config.task)
        nx, nu = self.model.nx, self.model.nu
        f32 = dict(dtype=torch.float32, device=self.device)
        self.Q = torch.as_tensor(get_cost_weight_matrix(list(q_lqr), nx), **f32)
        self.R = torch.as_tensor(get_cost_weight_matrix(list(r_lqr), nu), **f32)
        self.max_iterations = max_iterations
        self.lamb_factor = lamb_factor
        self.lamb_max = lamb_max
        self.epsilon = epsilon
        self.T = env.max_episode_steps
        self.u_0 = torch.as_tensor(np.asarray(env.u_goal), **f32)
        x_goal = np.asarray(env.x_goal, np.float32)
        if self.task == Task.STABILIZATION:
            x_ref = np.tile(x_goal[None], (self.T, 1))
        else:
            x_ref = x_goal[np.clip(np.arange(self.T), 0, x_goal.shape[0] - 1)]
        self.x_ref = torch.as_tensor(x_ref, **f32)
        # Gains: (T, nu, nx) feedback + (T, nu) feedforward.
        self.gains_fb = None
        self.input_ff = None
        self._step_i = 0

    def _cost(self, xs, us):
        """Total quadratic cost along a trajectory (model.loss summed)."""
        dx = xs[:-1] - self.x_ref
        du = us - self.u_0
        lx = 0.5 * torch.einsum("ti,ij,tj->", dx, self.Q, dx)
        lu = 0.5 * torch.einsum("ti,ij,tj->", du, self.R, du)
        dxT = xs[-1] - self.x_ref[-1]
        return lx + lu + 0.5 * dxT @ self.Q @ dxT

    def _forward(self, x0, gains_fb, input_ff):
        fd = self.model.fd_func
        x, xs, us = x0, [], []
        for K, uff in zip(gains_fb, input_ff):
            u = K @ x + uff
            xs.append(x)
            us.append(u)
            x = fd(x, u)
        return torch.stack(xs + [x]), torch.stack(us)

    def _backward(self, xs, us, lamb):
        """The reversed sweep of the reference's update_policy
        (ilqr.py:372-471): gains (T, nu, nx) and feedforward (T, nu)."""
        model, Q, R = self.model, self.Q, self.R
        dxT = xs[-1] - self.x_ref[-1]
        Sv, Sm = Q @ dxT, Q
        # The linearization along the trajectory, one batched call.
        Ac, Bc = model.batch_linearize(xs[:-1], us)
        Ad, Bd = discretize_linear_system(Ac, Bc, model.dt)
        Ks, uffs = [None] * self.T, [None] * self.T
        for k in range(self.T - 1, -1, -1):
            x_k, u_k, A, B = xs[k], us[k], Ad[k], Bd[k]
            Qv = Q @ (x_k - self.x_ref[k])
            Rv = R @ (u_k - self.u_0)
            g = Rv + B.T @ Sv
            G = B.T @ (Sm @ A)
            H = R + B.T @ (Sm @ B)
            H = 0.5 * (H + H.T)
            # Eigenvalue clipping + lambda regularization (ilqr.py:443-448).
            w, V = torch.linalg.eigh(H)
            w = torch.clamp_min(w, 0.0) + lamb
            H_inv = (V * (1.0 / w)) @ V.T
            duff = -H_inv @ g
            K = -H_inv @ G
            uffs[k] = u_k + duff - K @ x_k
            Ks[k] = K
            Sm_n = Q + A.T @ (Sm @ A) + K.T @ (H @ K) + K.T @ G + G.T @ K
            Sv = Qv + A.T @ Sv + K.T @ (H @ duff) + K.T @ g + G.T @ duff
            Sm = Sm_n
        return torch.stack(Ks), torch.stack(uffs)

    @torch.no_grad()
    def learn(self, **kwargs):
        """Run the iLQR iterations (reference run_ilqr, ilqr.py:150-370)."""
        model = self.model
        # The env's initial state for env seed ``self.seed`` (deterministic
        # without randomized_init).
        state, _, _ = self.env.reset(torch.tensor([self.seed], dtype=torch.int32,
                                                  device=self.device))
        x0 = state.x[0, : model.nx]

        # Iteration 0: LQR gains at the goals (ilqr.py:484-501), one batch.
        A, B = model.batch_linearize(self.x_ref, self.u_0.expand(self.T, -1))
        Ad, Bd = discretize_linear_system(A, B, model.dt)
        K0 = dlqr_gain(Ad, Bd, self.Q, self.R)[0]
        gains_fb = -K0
        input_ff = torch.einsum("tij,tj->ti", K0, self.x_ref) + self.u_0

        xs, us = self._forward(x0, gains_fb, input_ff)
        prev_cost = float(self._cost(xs, us))
        lamb = 1.0
        for _ in range(self.max_iterations):
            Ks, uffs = self._backward(xs, us, lamb)
            xs_new, us_new = self._forward(x0, Ks, uffs)
            new_cost = float(self._cost(xs_new, us_new))
            if not np.isfinite(new_cost):
                lamb *= self.lamb_factor
                if lamb > self.lamb_max:
                    break
                continue
            if new_cost < prev_cost:
                gains_fb, input_ff = Ks, uffs
                xs, us = xs_new, us_new
                improvement = (prev_cost - new_cost) / max(abs(prev_cost), 1e-12)
                prev_cost = new_cost
                lamb = max(lamb / self.lamb_factor, 1e-6)
                if improvement < self.epsilon:
                    break
            else:
                lamb *= self.lamb_factor
                if lamb > self.lamb_max:
                    break
        self.gains_fb = gains_fb
        self.input_ff = input_ff
        self.final_cost = prev_cost
        return {"cost": prev_cost}

    @torch.no_grad()
    def select_action(self, obs, info=None):
        if self.gains_fb is None:
            self.learn()
        k = min(self._step_i, self.T - 1)
        x = torch.as_tensor(np.asarray(obs, np.float32)[: self.model.nx], device=self.device)
        self._step_i += 1
        return (self.gains_fb[k] @ x + self.input_ff[k]).cpu().numpy()

    def reset(self):
        self._step_i = 0
