"""GP-MPC: cautious MPC with learned GP residual dynamics.

Port of ``safe_control_gym_tpu/controllers/gp_mpc.py`` (reference
safe_control_gym/controllers/mpc/gp_mpc.py): a prior model, the hover
linearization of LinearMPC, plus per-dimension zero-mean SE-ARD GP
residuals learned from rollout data (gp_mpc.py:672-837), with
probabilistic constraint tightening from the propagated GP uncertainty
(precompute_probabilistic_limits, gp_mpc.py:286-358).

gpytorch is ``ops/gp.py``, the k-means inducing points Lloyd's
iterations, and the IPOPT NLP with GP mean dynamics (setup_gp_optimizer,
gp_mpc.py:424-577) the batched AL-iLQR of ``ops/trajopt.py`` on
``fd_prior(x, u) + GP_mean(z)``.  The uncertainty follows the reference's
mean-equivalence approximation: constraint bounds are tightened by a
z-score times the propagated residual std along the candidate rollout.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np
import torch

from safe_control_gym_torch.controllers.linear_mpc import hover_linearization, linear_fd
from safe_control_gym_torch.controllers.mpc import MPC
from safe_control_gym_torch.ops.gp import GPState, gp_fit, gp_mean, gp_predict, kmeans
from safe_control_gym_torch.ops.linalg import dlqr_gain
from safe_control_gym_torch.ops.trajopt import al_ilqr_solve, ilqr_solve


class GPMPC(MPC):
    def __init__(
        self,
        env,
        horizon: int = 5,
        q_mpc=(1.0,),
        r_mpc=(1.0,),
        prob: float = 0.955,  # constraint satisfaction probability
        num_samples: int = 300,
        num_inducing: int = 64,
        gp_iters: int = 150,
        target_mask=None,  # which state dims get GP residuals
        input_mask=None,  # which (x, u) dims feed the GP
        **kwargs,
    ):
        super().__init__(env, horizon=horizon, q_mpc=q_mpc, r_mpc=r_mpc, **kwargs)
        nx, nu = self.model.nx, self.model.nu
        self.target_mask = np.asarray(target_mask if target_mask is not None else range(nx))
        self.input_mask = np.asarray(input_mask if input_mask is not None else range(nx + nu))
        f32 = dict(dtype=torch.float32, device=self.device)
        self._input_idx = torch.as_tensor(self.input_mask, device=self.device)
        # The residual dims into the state: res = mean @ scatter (exact: one
        # 1 a row, and x + 0.0 = x).
        self._scatter = torch.as_tensor(np.eye(nx)[self.target_mask], **f32)
        self.prob = prob
        self.num_samples = num_samples
        self.num_inducing = num_inducing
        self.gp_iters = gp_iters
        # The inverse CDF z-score of the tightening (gp_mpc.py:286-358 uses
        # norm.ppf on per-dim probabilities).
        self.z_score = NormalDist().inv_cdf(prob)
        self.gp_state: GPState | None = None
        self._margins = None
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # The prior: the frozen linearization at hover (the reference's
        # GPMPC extends LinearMPC).
        self._Ad, self._Bd, self._x_eq, self._u_eq2 = hover_linearization(env)
        # The prior's LQR gain, which closes the loop of the covariance
        # propagation (the margins): the Riccati equation of the float32
        # model solved in float64 (the float32 SDA is off by a few percent
        # on the quadrotors' near-identity Ad).
        self.K_prior = dlqr_gain(*(t.double() for t in (self._Ad, self._Bd, self.Q, self.R)))[0]
        self.K_prior = self.K_prior.float()

    # -- prior + residual dynamics ---------------------------------------------
    def _fd_prior(self, x, u):
        return linear_fd(x, u, self._Ad, self._Bd, self._x_eq, self._u_eq2)

    def _gp_input(self, x, u):
        return torch.cat([x, u], -1).index_select(-1, self._input_idx)

    def _fd_gp(self, gp: GPState, x, u):
        """Prior plus GP mean residual, on states with any leading dims."""
        return self._fd_prior(x, u) + gp_mean(gp, self._gp_input(x, u)) @ self._scatter

    # -- learning ----------------------------------------------------------------
    @torch.no_grad()
    def learn(self, num_samples: int | None = None, **kwargs):
        """Collect (x, u) -> residual data with hover-centred exploratory
        inputs on one env (normal draws from the controller's generator) and
        fit the GPs (reference learn(), gp_mpc.py:672-837)."""
        env, dev = self.env, self.device
        n = num_samples or self.num_samples
        nu = self.model.nu
        state, _, _ = env.reset(torch.tensor([self.seed], dtype=torch.int32, device=dev))
        u_lo = torch.as_tensor(env.spaces.action_low, dtype=torch.float32, device=dev)
        u_hi = torch.as_tensor(env.spaces.action_high, dtype=torch.float32, device=dev)
        xs, us, residuals = [], [], []
        x_prev = state.x[0]
        for _ in range(n):
            noise = torch.randn(nu, generator=self._gen, device=dev)
            u = torch.clamp(self._u_eq2 * (1.0 + 0.2 * noise), u_lo, u_hi)
            state, _, _, done, _ = env.step(state, u[None])
            x_next = state.x[0]
            xs.append(x_prev)
            us.append(u)
            residuals.append(x_next - self._fd_prior(x_prev, u))
            x_prev = x_next
            if bool(done[0]):
                state, _, _ = env.extras["reset_episode"](state)
                x_prev = state.x[0]
        Z = self._gp_input(torch.stack(xs), torch.stack(us))
        Y = torch.stack(residuals)[:, torch.as_tensor(self.target_mask, device=dev)]
        # An inducing-point subset by k-means (gp_mpc.py FITC path) when the
        # dataset is large; the exact GP on that set.
        if Z.shape[0] > self.num_inducing:
            cent = kmeans(self._gen, Z, self.num_inducing)
            idx = torch.unique(((Z[:, None] - cent[None]) ** 2).sum(-1).argmin(0))
            Z, Y = Z[idx], Y[idx]
        self.gp_state = gp_fit(Z, Y, iters=self.gp_iters)
        # The solver around the GP-corrected dynamics.
        self._solve = self._make_gp_solver()
        self._margins = None
        self._prev_us = None
        self._prev_mu = None
        return {"train_points": Z.shape[0]}

    def _make_gp_solver(self):
        T, Q, R, u_eq, P = self.T, self.Q, self.R, self.u_eq, self.P_term
        gp, cc, tol, alphas = self.gp_state, self._cc, self.constraint_tol, self._alphas
        iters = self.al_iters * self.inner_iters
        margins_fn = self._build_margins_fn() if cc is not None else None

        def fd(x, u):
            return self._fd_gp(gp, x, u)

        def stage_cost(x, u, s):
            dx = x - s[0]
            du = u - u_eq
            return 0.5 * dx @ Q @ dx + 0.5 * du @ R @ du

        def constraint_fn(x, u, s):
            return cc.get_values_raw(x, u) + tol + s[1]

        def solve(x0, ref, us_init, mu0):
            def term_cost(x):
                dx = x - ref[T]
                return 0.5 * dx @ P @ dx

            refs = ref[None, :T]
            if cc is None:
                res = ilqr_solve(fd, stage_cost, term_cost, x0, us_init, iters=iters,
                                 alphas=alphas, stage_data=(refs,))
                return res.us, res.cost, mu0
            res, mu = al_ilqr_solve(fd, stage_cost, term_cost, constraint_fn, x0, us_init,
                                    al_iters=self.al_iters, inner_iters=self.inner_iters,
                                    mu0=mu0, stagewise=True, alphas=alphas,
                                    stage_data=(refs, margins_fn(x0, us_init)))
            return res.us, res.cost, mu

        return solve

    @torch.no_grad()
    def probabilistic_margins(self, x0, us):
        """Public hook: the (T, nc) per-row tightening margins of a candidate
        input sequence us (T, nu) from x0 (nx,) (reference
        precompute_probabilistic_limits)."""
        if self.gp_state is None or self._cc is None:
            raise ValueError("learn() first / no constraints")
        if self._margins is None:
            self._margins = self._build_margins_fn()
        f32 = dict(dtype=torch.float32, device=self.device)
        return self._margins(torch.as_tensor(x0, **f32)[None], torch.as_tensor(us, **f32)[None])[0]

    def _build_margins_fn(self):
        """Batched (B, T, nc) horizon-propagated tightening margins along
        candidate rollouts (reference precompute_probabilistic_limits,
        gp_mpc.py:286-358).

        The residual covariance accumulates through the prior closed loop,
        Sigma_{k+1} = A_cl Sigma_k A_cl' + Sigma_gp(z_k) with Sigma_0 = 0 (x0
        is measured), so the first node is untightened and the margins grow
        along the horizon.  The per-row margins are assembled in the STACKED
        block order of ``CompiledConstraints.get_values_raw`` (linear,
        quadratic, symmetric) and then permuted by ``row_order``: writing the
        linear margins to output rows 0..nc_lin-1 would tighten the wrong
        constraints whenever quadratic or symmetric rows interleave.
        Quadratic rows take the gradient at the rollout point (|grad x'Px| =
        |2Px|); symmetric rows take |F|."""
        gp, cc, nx = self.gp_state, self._cc, self.model.nx
        A_cl = self._Ad - self._Bd @ self.K_prior
        abs_Ax = cc.A_x.abs()
        z_score = self.z_score

        def margins_from_std(std, x):
            parts = [std @ abs_Ax.T]
            for P, _, on_input in cc.quadratics:
                if on_input:
                    parts.append(torch.zeros_like(std[..., :1]))
                else:
                    parts.append(((2.0 * x @ P.T).abs() * std).sum(-1, keepdim=True))
            for F, _ in cc.symmetrics:
                parts.append(std @ F.abs().T)
            stacked = torch.cat(parts, -1)
            if cc.row_order is not None:
                stacked = stacked[..., cc.row_order]
            return stacked * z_score

        def margins(x0, us):
            B, T = us.shape[:2]
            x, xs = x0, []
            for t in range(T):
                xs.append(x)
                x = self._fd_gp(gp, x, us[:, t])
            xs = torch.stack(xs, 1)  # (B, T, nx)
            _, var = gp_predict(gp, self._gp_input(xs, us).reshape(B * T, -1))
            var = (var @ self._scatter).reshape(B, T, nx)
            S = torch.zeros((B, nx, nx), dtype=x0.dtype, device=x0.device)
            stds = []
            for k in range(T):
                stds.append(torch.sqrt(torch.clamp_min(torch.diagonal(S, dim1=-2, dim2=-1), 0.0)))
                S = A_cl @ S @ A_cl.T + torch.diag_embed(var[:, k])
            return margins_from_std(torch.stack(stds, 1), xs)

        return margins

    def select_action(self, obs, info=None):
        if self.gp_state is None:
            self.learn()
        return super().select_action(obs, info)
