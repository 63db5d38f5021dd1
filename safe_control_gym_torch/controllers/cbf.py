"""CBF-QP safety filter with a learned Lie-derivative residual.

Port of ``safe_control_gym_tpu/controllers/cbf.py`` (reference
safe_control_gym/controllers/cbf/cbf_qp.py + cbf_qp_utils.py):

  * the ellipsoidal barrier h(x) = 0.5 (1 - x^2/x_max^2 - x_dot^2/v_max^2)
    (cbf_cartpole, cbf_qp_utils.py:10-35), generalized to any state dims;
  * L_f h = grad h . f(x, u) by ``torch.func``; the dynamics are affine in
    u, so the CBF condition is a linear constraint in u;
  * the learned residual: an MLP(x) -> (a, b) with residual a'u + b,
    trained on the gap between finite-difference and nominal-model barrier
    derivatives (cbf_qp.py:380-483);
  * ``certify``: min ||u - u_des||^2 s.t. L_f h + residual >= -slope h and
    the input box, a small QP by ADMM (``ops/qp.py``), optionally
    slack-softened, on a batch of states at once;
  * ``is_cbf``: the grid verification over the barrier's box, one batched
    evaluation (the supremum over the input box is at a corner).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.func import grad, vmap

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.models.networks import MLP
from safe_control_gym_torch.models.optim import Adam
from safe_control_gym_torch.ops.qp import solve_qp


class CBF_QP(BaseController):
    def __init__(
        self,
        env,
        slope: float = 0.1,
        soft_constrained: bool = True,
        slack_weight: float = 10000.0,
        slack_tolerance: float = 1e-3,
        x_max_scale: float = 1.0,
        barrier_dims=None,
        barrier_bounds=None,
        hidden_dim: int = 64,
        learning_rate: float = 1e-3,
        max_buffer_size: int = 1_000_000,
        train_batch_size: int = 64,
        **kwargs,
    ):
        super().__init__(env, **kwargs)
        self.model = env.symbolic
        self.device = env.device
        nx, nu = self.model.nx, self.model.nu
        self.nu = nu
        self.slope = slope
        self.soft_constrained = soft_constrained
        self.slack_weight = slack_weight
        self.slack_tolerance = slack_tolerance
        f32 = dict(dtype=torch.float32, device=self.device)
        self.u_lo = torch.as_tensor(env.spaces.action_low, **f32)
        self.u_hi = torch.as_tensor(env.spaces.action_high, **f32)
        # Barrier semi-axes from the env's state box.
        lows = np.asarray(env.spaces.state_low)
        self.x_max = float(min(abs(lows[0]), 100.0)) * x_max_scale
        self.v_max = 2.0 * x_max_scale  # the velocity box is unbounded: 2 m/s
        # h(x) = 0.5 (1 - sum_i x[d_i]^2 / b_i^2); the defaults are the
        # reference's cartpole barrier over (x, x_dot) (cbf_qp_utils.py:10-40).
        if barrier_dims is None:
            barrier_dims = (0, 1)
            barrier_bounds = (self.x_max, self.v_max)
        if barrier_bounds is None or len(barrier_bounds) != len(barrier_dims):
            raise ValueError("barrier_bounds must give one bound per barrier dim")
        self.barrier_dims = tuple(int(d) for d in barrier_dims)
        self.barrier_bounds = tuple(float(b) for b in barrier_bounds)

        # The residual model: state -> (a (nu,), b).
        gen = torch.Generator().manual_seed(self.seed)
        self.mlp = MLP(nx, nu + 1, (hidden_dim, hidden_dim), act="relu", generator=gen).to(
            self.device)
        self.opt = Adam(self.mlp.parameters(), lr=learning_rate, max_norm=float("inf"))
        self.train_batch_size = train_batch_size
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)

    # -- barrier and derivatives ---------------------------------------------
    def barrier(self, x):
        """h(x) >= 0 inside the safe set (cbf_qp_utils.py:33-34), on states
        with any leading dims."""
        q = sum(x[..., d] ** 2 / b**2 for d, b in zip(self.barrier_dims, self.barrier_bounds))
        return 0.5 * (1.0 - q)

    def lie_derivative_coeffs(self, x):
        """L_f h(x, u) = c0 + c1'u (affine in u) at one state x (nx,)."""
        u0 = torch.zeros(self.nu, dtype=x.dtype, device=x.device)
        dh = grad(self.barrier)(x)
        _, Bx = self.model.df_func(x, u0)
        return dh @ self.model.fc_func(x, u0), dh @ Bx

    def certify(self, x, u_des, use_learned_model: bool = True):
        """The certified inputs (B, nu) and slacks (B,) for states x (B, nx)
        and desired inputs u_des (B, nu)."""
        nu = self.nu
        B = x.shape[0]
        c0, c1 = vmap(self.lie_derivative_coeffs)(x)
        h = self.barrier(x)
        ab = self.mlp(x) if use_learned_model else torch.zeros((B, nu + 1), dtype=x.dtype,
                                                                device=x.device)
        # The condition c0 + c1'u + a'u + b + slope h >= 0, as w'u >= d.
        w = c1 + ab[:, :nu]
        d = -(c0 + ab[:, nu] + self.slope * h)
        like = dict(dtype=x.dtype, device=x.device)
        eye = torch.eye(nu, **like).expand(B, nu, nu)
        big = torch.full((B, 1), 1e8, **like)
        lo, hi = self.u_lo.expand(B, nu), self.u_hi.expand(B, nu)
        if self.soft_constrained:
            # Variables [u; s]: min 1/2 ||u - u_des||^2 + w_s s^2
            # s.t. w'u + s >= d, s >= 0, the input box.
            z1 = torch.zeros((B, 1), **like)
            P = torch.zeros((B, nu + 1, nu + 1), **like)
            P[:, :nu, :nu] = eye
            P[:, nu, nu] = 2 * self.slack_weight
            q = torch.cat([-u_des, z1], -1)
            A = torch.cat([torch.cat([w, z1 + 1.0], -1)[:, None],
                           torch.cat([torch.zeros((B, 1, nu), **like), z1[:, None] + 1.0], -1),
                           torch.cat([eye, torch.zeros((B, nu, 1), **like)], -1)], 1)
            l = torch.cat([d[:, None], z1, lo], -1)
            ub = torch.cat([big, big, hi], -1)
            sol, _, _ = solve_qp(P, q, A, l, ub)
            return sol[:, :nu], sol[:, nu]
        A = torch.cat([w[:, None], eye], 1)
        sol, _, _ = solve_qp(eye, -u_des, A, torch.cat([d[:, None], lo], -1),
                             torch.cat([big, hi], -1))
        return sol, torch.zeros(B, **like)

    # -- reference API ---------------------------------------------------------
    @torch.no_grad()
    def certify_action(self, current_state, unsafe_action, use_learned_model=True):
        f32 = dict(dtype=torch.float32, device=self.device)
        x = torch.as_tensor(np.asarray(current_state, np.float32)[: self.model.nx], **f32)
        u, slack = self.certify(x[None], torch.as_tensor(unsafe_action, **f32).reshape(1, -1),
                                use_learned_model)
        return u[0].cpu().numpy(), bool(slack[0] <= self.slack_tolerance)

    @torch.no_grad()
    def is_cbf(self, num_points: int = 10, tolerance: float = 0.0):
        """Grid verification (cbf_qp.py:115-192), one batched evaluation:
        sup_u [L_f h + slope h] >= 0 wherever h >= 0.  The condition is
        linear in u, so the supremum over the input box is at a corner."""
        nx = self.model.nx
        axes = [np.zeros(1)] * nx
        for d, b in zip(self.barrier_dims, self.barrier_bounds):
            axes[d] = np.linspace(-b - tolerance, b + tolerance, num_points)
        grid = np.stack([g.ravel() for g in np.meshgrid(*axes)], -1).astype(np.float32)
        corners = np.stack(list(itertools.product(*zip(self.u_lo.cpu().numpy(),
                                                       self.u_hi.cpu().numpy()))))
        f32 = dict(dtype=torch.float32, device=self.device)
        x = torch.as_tensor(grid, **f32)
        c0, c1 = vmap(self.lie_derivative_coeffs)(x)
        h = self.barrier(x)
        vals = c0[:, None] + c1 @ torch.as_tensor(corners, **f32).T + (self.slope * h)[:, None]
        ok = torch.where(h >= 0, vals.amax(-1) >= 0, torch.ones_like(h, dtype=torch.bool))
        ok = ok.cpu().numpy()
        return bool(ok.all()), grid[~ok]

    def learn(self, env=None, max_samples: int = 2000, epochs: int = 50, **kwargs):
        """Collect transitions on one env (uniform inputs from the
        controller's generator) and fit the Lie-derivative residual
        (cbf_qp.py:380-483): target = (h(x') - h(x))/dt - L_f h_nominal."""
        env = env or self.env
        dev = self.device
        state, _, _ = env.reset(torch.tensor([self.seed], dtype=torch.int32, device=dev))
        dt = env.ctrl_timestep
        xs, us, targets = [], [], []
        x_prev = state.x[0]
        with torch.no_grad():
            for _ in range(max_samples):
                r = torch.rand(self.nu, generator=self._gen, device=dev)
                u = self.u_lo + (self.u_hi - self.u_lo) * r
                state, _, _, done, _ = env.step(state, u[None])
                x_next = state.x[0]
                h_dot_emp = (self.barrier(x_next) - self.barrier(x_prev)) / dt
                c0, c1 = self.lie_derivative_coeffs(x_prev)
                xs.append(x_prev)
                us.append(u)
                targets.append(h_dot_emp - (c0 + c1 @ u))
                x_prev = x_next
                if bool(done[0]):
                    state, _, _ = env.extras["reset_episode"](state)
                    x_prev = state.x[0]
        X, U, Y = torch.stack(xs), torch.stack(us), torch.stack(targets)
        loss = None
        for _ in range(epochs):
            loss = self.train_epoch(X, U, Y)
        return {"residual_loss": float(loss)}

    def train_epoch(self, X, U, Y):
        """One full-batch Adam step (optax.adam) on the residual's mean
        squared error; returns the loss before the step."""
        params = list(self.mlp.parameters())
        with torch.enable_grad():
            ab = self.mlp(X)
            pred = (ab[:, : self.nu] * U).sum(-1) + ab[:, self.nu]
            loss = ((pred - Y) ** 2).mean()
            grads = torch.autograd.grad(loss, params)
        self.opt.step(grads)
        return loss.detach()

    def select_action(self, obs, info=None):
        """Filter the unsafe controller's action (``info['unsafe_action']``,
        zeros by default)."""
        u_des = np.zeros(self.nu) if info is None else np.asarray(
            info.get("unsafe_action", np.zeros(self.nu)))
        u, _ = self.certify_action(np.asarray(obs), u_des)
        return u
