"""Nonlinear MPC.

Port of ``safe_control_gym_tpu/controllers/mpc.py`` (reference
safe_control_gym/controllers/mpc/mpc.py): RK4-discretized dynamics over a
horizon T, the quadratic tracking cost (Q, R from q_mpc/r_mpc diagonals,
mpc.py:68-71), state and input constraints with a tolerance
(mpc.py:230-258), a warm start that shifts the previous solution and
multipliers (mpc.py:303-310), references sliced from X_GOAL with the last
one repeated (mpc.py:327-345).

The IPOPT multiple-shooting NLP is a fixed-iteration augmented-Lagrangian
iLQR (``ops/trajopt.py``), batch-first: one solve takes a batch of initial
states, so ``select_action`` is a batch of one and ``solve_batch`` runs
one MPC instance per env in lockstep on the env's device.  Soft-constraint
mode is a fixed penalty weight (reference 10000 * slack^2, mpc.py:235-250)
instead of AL updates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.envs.benchmark import Task
from safe_control_gym_torch.envs.constraints import build_constraints
from safe_control_gym_torch.ops.integrators import discretize_linear_system
from safe_control_gym_torch.ops.linalg import get_cost_weight_matrix, solve_discrete_are
from safe_control_gym_torch.ops.trajopt import ALPHAS, al_ilqr_solve, ilqr_solve
from safe_control_gym_torch.parallel.vector import make_vec_env


class MPC(BaseController):
    def __init__(
        self,
        env,
        horizon: int = 5,
        q_mpc=(1.0,),
        r_mpc=(1.0,),
        warmstart: bool = True,
        soft_constraints: bool = False,
        constraint_tol: float = 1e-6,
        al_iters: int = 3,
        inner_iters: int = 6,
        soft_penalty: float = 10000.0,
        terminal_lqr_cost: bool = False,
        **kwargs,
    ):
        super().__init__(env, **kwargs)
        self.model = env.symbolic
        self.device = env.device
        self.T = horizon
        self.dt = self.model.dt
        nx, nu = self.model.nx, self.model.nu
        f32 = dict(dtype=torch.float32, device=self.device)
        self.Q = torch.as_tensor(get_cost_weight_matrix(list(q_mpc), nx), **f32)
        self.R = torch.as_tensor(get_cost_weight_matrix(list(r_mpc), nu), **f32)
        self.warmstart = warmstart
        self.soft_constraints = soft_constraints
        self.constraint_tol = constraint_tol
        self.al_iters = al_iters
        self.inner_iters = inner_iters
        self.soft_penalty = soft_penalty
        self.task = Task(env.config.task)
        self.u_eq = torch.as_tensor(np.asarray(env.u_goal), **f32)
        self.traj = torch.as_tensor(np.asarray(env.x_goal).reshape(-1, nx), **f32)  # (N, nx)
        # The line search's step sizes on the device, so that a solve makes
        # no host copy.
        self._alphas = torch.as_tensor(ALPHAS, **f32)
        self.traj_step = 0
        self._prev_us = None
        self._prev_mu = None

        # The compiled constraint program (the reference re-wraps its
        # symbolic constraints, mpc.py:83-96).
        self._cc = build_constraints(env.config.constraints, env.spaces, self.device)

        # Exact input-box bounds from the constraint program: the applied
        # (first) action is projected onto them, as IPOPT's inputs satisfy
        # their bounds exactly (AL satisfies them approximately).
        self._u_lo, self._u_hi = self._input_box_bounds()

        # Optional infinite-horizon terminal cost: P from the DARE at the
        # goal (off by default, as in the reference), of the float32
        # linearization, solved in float64 (the float32 SDA is off by a few
        # percent on the quadrotors' near-identity Ad).
        self.P_term = self.Q
        if terminal_lqr_cost:
            A, B = self.model.df_func(self.traj[0], self.u_eq)
            Ad, Bd = discretize_linear_system(A, B, self.dt)
            self.P_term = solve_discrete_are(
                *(t.double() for t in (Ad, Bd, self.Q, self.R))).float()

        self._solve = self._make_solver()

    def _make_solver(self):
        model, T = self.model, self.T
        Q, R, u_eq = self.Q, self.R, self.u_eq
        tol, cc, alphas = self.constraint_tol, self._cc, self._alphas
        iters = self.al_iters * self.inner_iters

        def fd(x, u):
            return model.fd_func(x, u)

        if cc is not None:
            # Raw (unrounded) values: the solver needs constraint gradients.
            def constraint_fn(x, u):
                return cc.get_values_raw(x, u) + tol
        else:
            constraint_fn = None

        def stage_cost(x, u, x_ref):
            dx = x - x_ref
            du = u - u_eq
            return 0.5 * dx @ Q @ dx + 0.5 * du @ R @ du

        def stage_soft(x, u, x_ref):
            s = torch.maximum(torch.zeros((), dtype=x.dtype, device=x.device), constraint_fn(x, u))
            return stage_cost(x, u, x_ref) + self.soft_penalty * torch.sum(s**2)

        def solve(x0, ref, us_init, mu0):
            """x0 (B, nx); ref (T+1, nx) goal states; us_init (B, T, nu);
            mu0 (B, T, nc) warm-started AL multipliers (zeros on the first
            solve).  Returns us (B, T, nu), cost (B,), mu (B, T, nc)."""
            P = self.P_term

            def term_cost(x):
                dx = x - ref[T]
                return 0.5 * dx @ P @ dx

            refs = ref[None, :T]
            if constraint_fn is None or self.soft_constraints:
                cost = stage_cost if constraint_fn is None else stage_soft
                res = ilqr_solve(fd, cost, term_cost, x0, us_init, iters=iters, alphas=alphas,
                                 stage_data=refs)
                return res.us, res.cost, mu0
            res, mu = al_ilqr_solve(fd, stage_cost, term_cost, constraint_fn, x0, us_init,
                                    al_iters=self.al_iters, inner_iters=self.inner_iters,
                                    mu0=mu0, alphas=alphas, stage_data=refs)
            return res.us, res.cost, mu

        return solve

    def get_references(self, step: int):
        """Horizon slice of the goal trajectory (mpc.py:327-345), (T+1, nx)."""
        if self.task == Task.STABILIZATION:
            return self.traj[0].expand(self.T + 1, -1)
        # Slices, not an index tensor: no host copy.
        step = max(step, 0)
        rows = self.traj[min(step, self.traj.shape[0] - 1): step + self.T + 1]
        return torch.cat([rows, self.traj[-1:].expand(self.T + 1 - rows.shape[0], -1)], 0)

    def _input_box_bounds(self):
        nu = self.model.nu
        lo = np.full(nu, -np.inf)
        hi = np.full(nu, np.inf)
        cc = self._cc
        if cc is not None:
            A_x, A_u, b = (t.cpu().numpy() for t in (cc.A_x, cc.A_u, cc.b))
            for i in range(A_u.shape[0]):
                if np.any(A_x[i] != 0):
                    continue
                nz = np.nonzero(A_u[i])[0]
                if nz.size != 1:
                    continue
                a, bi = A_u[i, nz[0]], b[i]
                if a > 0:
                    hi[nz[0]] = min(hi[nz[0]], bi / a)
                else:
                    lo[nz[0]] = max(lo[nz[0]], bi / a)
        f32 = dict(dtype=torch.float32, device=self.device)
        return torch.as_tensor(lo, **f32), torch.as_tensor(hi, **f32)

    def _mu_zeros(self, batch: int = 1):
        nc = self._cc.num_constraints if self._cc is not None else 1
        return torch.zeros((batch, self.T, nc), dtype=torch.float32, device=self.device)

    def _us_eq(self, batch: int = 1):
        return self.u_eq.expand(batch, self.T, -1)

    def reset(self):
        self.traj_step = 0
        self._prev_us = None
        self._prev_mu = None

    @torch.no_grad()
    def select_action(self, obs, info=None):
        """The first input of a warm-started solve from one observation, as
        NumPy, projected onto the input box."""
        x0 = torch.as_tensor(np.asarray(obs, np.float32)[: self.model.nx],
                             device=self.device)[None]
        ref = self.get_references(self.traj_step)
        if self._prev_us is None or not self.warmstart:
            us_init, mu0 = self._us_eq(), self._mu_zeros()
        else:
            # Shift the previous solution and multipliers (mpc.py:303-310).
            us_init = torch.cat([self._prev_us[:, 1:], self._prev_us[:, -1:]], 1)
            mu0 = torch.cat([self._prev_mu[:, 1:], self._prev_mu[:, -1:]], 1)
        us, _, mu = self._solve(x0, ref, us_init, mu0)
        self._prev_us = us
        self._prev_mu = mu if mu is not None else self._mu_zeros()
        self.traj_step += 1
        return torch.clamp(us[0, 0], self._u_lo, self._u_hi).cpu().numpy()

    @torch.no_grad()
    def solve_batch(self, x0s, step: int = 0):
        """Solve a batch of MPC problems in lockstep from states x0s (B, nx)
        (or observations, whose first nx entries are the state): inputs
        (B, T, nu) and costs (B,)."""
        x0s = torch.as_tensor(x0s, dtype=torch.float32, device=self.device)[:, : self.model.nx]
        B = x0s.shape[0]
        us, costs, _ = self._solve(x0s, self.get_references(step), self._us_eq(B),
                                   self._mu_zeros(B))
        return us, costs

    def _policy(self, obs):
        us, _ = self.solve_batch(obs, 0)
        return us[:, 0]

    @torch.no_grad()
    def run(self, num_episodes: int = 1, max_steps: int | None = None, seed: int = 0,
            analysis: bool = False, plot: bool = False, plot_dir: str = "."):
        """Sequential evaluation with per-solve wall time (reference
        MPC.run(), mpc.py:366-466): warm-started ``select_action`` solves in
        a host loop on one env, ``t_wall`` each solve's wall-clock with
        ``torch.cuda.synchronize`` as the barrier on a card (the reference
        stores IPOPT's t_wall_total, mpc.py:318), the obs/action/reward/done
        stacks, episode returns and, with ``analysis=True``, the state RMSE.
        Episode ``ep`` resets env seed ``seed + ep``.  For batched lockstep
        solves use ``solve_batch``."""
        env = self.env
        vec = make_vec_env(env, 1, auto_reset=False)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        results = {"obs": [], "action": [], "reward": [], "done": [], "t_wall": [],
                   "ep_returns": []}
        T_max = max_steps or env.max_episode_steps
        for ep in range(num_episodes):
            self.reset()
            state, obs, _ = vec.reset(
                env_seeds=torch.tensor([seed + ep], dtype=torch.int32, device=self.device))
            ep_ret = 0.0
            for _ in range(T_max):
                o = obs[0].cpu().numpy()
                t0 = time.perf_counter()
                act = self.select_action(o)
                sync()
                results["t_wall"].append(time.perf_counter() - t0)
                results["obs"].append(o)
                results["action"].append(act)
                state, obs, rew, done, _ = vec.step_no_reset(
                    state, torch.as_tensor(act, device=self.device)[None])
                rew, done = float(rew[0]), bool(done[0])
                ep_ret += rew
                results["reward"].append(rew)
                results["done"].append(done)
                if done:
                    break
            results["ep_returns"].append(ep_ret)
        for k in ("obs", "action", "reward", "done", "t_wall", "ep_returns"):
            results[k] = np.asarray(results[k])
        if analysis:
            from safe_control_gym_torch.utils.plotting import post_analysis

            n = results["obs"].shape[0]
            ref_traj = self.traj.cpu().numpy()
            if self.task == Task.STABILIZATION:
                goal = np.tile(ref_traj[0][None], (n, 1))
            else:
                goal = ref_traj[np.clip(np.arange(n), 0, ref_traj.shape[0] - 1)]
            results["analysis"] = post_analysis(
                goal, results["obs"][:, : self.model.nx], results["action"], env=env,
                plot=plot, save_plot=plot, plot_dir=plot_dir)
        return results
