"""Fixed-iteration trajectory optimization (iLQR / AL-iLQR) on batched tensors.

Port of ``safe_control_gym_tpu/ops/trajopt.py`` (the replacement of the
reference's CasADi+IPOPT NLP solves, controllers/mpc/mpc.py:188-325): an
iLQR inner solver (DDP backward pass with Levenberg regularization, a line
search over a fixed set of step sizes) and an augmented-Lagrangian outer
loop for the inequality constraints g(x, u) <= 0 (PHR multiplier updates).

Every solve is batch-first: ``x0`` (B, nx), ``us_init`` (B, T, nu) and
``mu0`` (B, T, nc) carry a leading batch of independent problems that step
in lockstep, where the JAX package ``vmap``s one problem.  The line search's
step sizes are one more batch dim, so an iteration makes one batched
rollout.  The derivatives come from ``torch.func`` under ``vmap`` over the
stacked (B*T) stage inputs.  Shapes and iteration counts are fixed, the
accept/reject decisions are per-problem masks, and nothing reads a value
back to the host: a solve makes no host sync on CUDA (``linalg.solve_ex``
in place of ``solve``, whose error check syncs).  A singular ``Quu`` gives
non-finite gains, whose rollouts cost ``inf`` and are rejected, as in the
JAX package.

Callables, as in the JAX package, work on one problem's stage:

  * ``fd(x, u) -> x_next`` on states with any leading dims (the rollouts
    call it on the whole batch, the Jacobians on a batch of one);
  * ``stage_cost(x, u, k) -> scalar`` on one (nx,) state and (nu,) input.
    ``k`` is the stage's slice of ``stage_data`` (a tensor or nested tuple
    of tensors with leading dims (B, T) or (1, T), sliced per problem and
    stage), or the
    stage index where ``stage_data`` is None.  Stage-dependent data (MPC
    references, GP-MPC margins) comes in this way, not by indexing a tensor
    with ``k`` inside the function;
  * ``term_cost(x) -> scalar`` on one state;
  * ``constraint_fn(x, u) -> (nc,)``, or ``(x, u, k)`` with ``stagewise``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, jacfwd, vmap

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)


class ILQRResult(NamedTuple):
    xs: torch.Tensor  # (B, T+1, nx)
    us: torch.Tensor  # (B, T, nu)
    cost: torch.Tensor  # (B,)
    lamb: torch.Tensor  # (B,) final regularizer


def _tree_map(f, data):
    if isinstance(data, tuple):
        return tuple(_tree_map(f, a) for a in data)
    return f(data)


def _flat(data, lead: int):
    """Merge the first ``lead`` dims of every tensor of ``data``."""
    return _tree_map(lambda a: a.reshape(-1, *a.shape[lead:]), data)


def _stage_data(stage_data, B: int, T: int, device):
    if stage_data is None:
        return torch.arange(T, device=device).expand(B, T)
    return _tree_map(lambda a: a.expand(B, *a.shape[1:]), stage_data)


def _grad_and_hessian(f, argnums):
    """``x -> (hessian, grad)`` of a scalar function in one forward-over-
    reverse pass."""
    g = grad(f, argnums=argnums)

    def g_aux(*a):
        out = g(*a)
        return out, out

    return jacfwd(g_aux, argnums=argnums, has_aux=True)


def _derivs(stage_cost, term_cost, fd, xs, us, sd):
    """All cost and dynamics derivatives along a batch of trajectories."""
    B, T, nu = us.shape
    nx = xs.shape[-1]
    X, U, S = xs[:, :-1].reshape(B * T, nx), us.reshape(B * T, nu), _flat(sd, 2)
    ((lxx, _), (lux, luu)), (lx, lu) = vmap(_grad_and_hessian(stage_cost, (0, 1)))(X, U, S)
    A, Bm = vmap(jacfwd(lambda x, u: fd(x[None], u[None])[0], argnums=(0, 1)))(X, U)
    vxx, vx = vmap(_grad_and_hessian(term_cost, 0))(xs[:, -1])

    def per(t):
        return t.reshape(B, T, *t.shape[1:])

    return (per(lx), per(lu), per(lxx), per(luu), per(lux), per(A), per(Bm), vx, vxx)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _backward(lx, lu, lxx, luu, lux, A, B, vx, vxx, lamb):
    """The reversed Riccati sweep over the horizon, batched: the gains
    (B, T, nu) and (B, T, nu, nx)."""
    T, nu = lu.shape[1], lu.shape[-1]
    I_u = torch.eye(nu, dtype=lu.dtype, device=lu.device)
    reg = lamb[:, None, None] * I_u
    Vx, Vxx = vx, vxx
    k_ff, K = [None] * T, [None] * T
    for k in range(T - 1, -1, -1):
        A_k, B_k = A[:, k], B[:, k]
        At, Bt = A_k.mT, B_k.mT
        Qx = lx[:, k] + _mv(At, Vx)
        Qu = lu[:, k] + _mv(Bt, Vx)
        Qxx = lxx[:, k] + At @ Vxx @ A_k
        Quu = luu[:, k] + Bt @ Vxx @ B_k
        Qux = lux[:, k] + Bt @ Vxx @ A_k
        Quu_reg = 0.5 * (Quu + Quu.mT) + reg
        # One solve for both right-hand sides; Levenberg keeps it PD.
        sol = -torch.linalg.solve_ex(Quu_reg, torch.cat([Qu[..., None], Qux], -1))[0]
        kf, Kk = sol[..., 0], sol[..., 1:]
        Kt = Kk.mT
        Vx = Qx + _mv(Kt @ Quu, kf) + _mv(Kt, Qu) + _mv(Qux.mT, kf)
        Vxx = Qxx + Kt @ Quu @ Kk + Kt @ Qux + Qux.mT @ Kk
        Vxx = 0.5 * (Vxx + Vxx.mT)
        k_ff[k], K[k] = kf, Kk
    return torch.stack(k_ff, 1), torch.stack(K, 1)


def _rollout_open(fd, x0, us):
    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append(fd(xs[-1], us[..., t, :]))
    return torch.stack(xs, -2)


def _rollout_policy(fd, x0, xs_ref, us_ref, k_ff, K, alpha):
    """Closed-loop rollouts of u = u_ref + alpha k_ff + K (x - x_ref) for
    step sizes ``alpha`` (A,): states (A, B, T+1, nx), inputs (A, B, T, nu)."""
    x = x0.expand(alpha.shape[0], *x0.shape)
    a = alpha[:, None, None]
    xs, us = [x], []
    for t in range(us_ref.shape[1]):
        u = us_ref[:, t] + a * k_ff[:, t] + _mv(K[:, t], x - xs_ref[:, t])
        x = fd(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, -2), torch.stack(us, -2)


def _total_cost(stage_cost, term_cost, xs, us, sd):
    """Costs of trajectories xs (..., B, T+1, nx), us (..., B, T, nu) with
    stage data of leading dims (B, T): (..., B)."""
    lead, (T, nu), nx = us.shape[:-2], us.shape[-2:], xs.shape[-1]
    S = _flat(_tree_map(lambda a: a.expand(*lead[:-1], *a.shape), sd), len(lead) + 1)
    c = vmap(stage_cost)(xs[..., :-1, :].reshape(-1, nx), us.reshape(-1, nu), S)
    return c.reshape(*lead, T).sum(-1) + vmap(term_cost)(xs[..., -1, :].reshape(-1, nx)).reshape(lead)


def _take(t, idx):
    """t[idx[b], b] for t (A, B, ...) and idx (B,)."""
    i = idx.reshape(1, -1, *([1] * (t.dim() - 2))).expand(1, *t.shape[1:])
    return t.gather(0, i)[0]


def ilqr_solve(
    fd: Callable,
    stage_cost: Callable,
    term_cost: Callable,
    x0: torch.Tensor,
    us_init: torch.Tensor,
    iters: int = 10,
    alphas=ALPHAS,
    lamb_init: float = 1.0,
    lamb_factor: float = 10.0,
    stage_data=None,
) -> ILQRResult:
    """Fixed-iteration iLQR with a batched line search, on a batch of
    problems ``x0`` (B, nx), ``us_init`` (B, T, nu).

    Each iteration: derivatives, backward pass, closed-loop rollouts at all
    ``alphas`` (a tensor on the problems' device makes no host copy), and
    per problem: accept the cheapest candidate if it improves the cost
    (non-finite costs count as ``inf``, ties go to the first step size),
    adapt the Levenberg regularizer."""
    B, T = us_init.shape[:2]
    sd = _stage_data(stage_data, B, T, x0.device)
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    xs = _rollout_open(fd, x0, us_init)
    us = us_init
    cost = _total_cost(stage_cost, term_cost, xs, us, sd)
    lamb = torch.full((B,), lamb_init, dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        lx, lu, lxx, luu, lux, A, Bm, vx, vxx = _derivs(stage_cost, term_cost, fd, xs, us, sd)
        k_ff, K = _backward(lx, lu, lxx, luu, lux, A, Bm, vx, vxx, lamb)
        xs_c, us_c = _rollout_policy(fd, x0, xs, us, k_ff, K, alphas)
        costs = _total_cost(stage_cost, term_cost, xs_c, us_c, sd)
        costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, float("inf")))
        best = torch.argmin(costs, 0)
        c_best = _take(costs, best)
        improved = c_best < cost
        xs = torch.where(improved[:, None, None], _take(xs_c, best), xs)
        us = torch.where(improved[:, None, None], _take(us_c, best), us)
        cost = torch.where(improved, c_best, cost)
        lamb = torch.where(improved, torch.clamp_min(lamb / lamb_factor, 1e-6), lamb * lamb_factor)
    return ILQRResult(xs, us, cost, lamb)


def al_stage_cost(stage_cost: Callable, cfn: Callable, rho: float) -> Callable:
    """The PHR-augmented stage cost ``(x, u, (k, mu_k))``:
    l + (rho/2) |max(0, mu/rho + c)|^2 - |mu|^2 / (2 rho).  The max is
    ``torch.maximum`` against a zero tensor, which splits the derivative at
    an exact tie as ``jnp.maximum`` does (``clamp`` would not)."""

    def aug(x, u, s):
        k, m = s
        c = cfn(x, u, k)
        viol = torch.maximum(torch.zeros((), dtype=c.dtype, device=c.device), m / rho + c)
        pen = 0.5 * rho * torch.sum(viol**2) - torch.sum(m**2) / (2 * rho)
        return stage_cost(x, u, k) + pen

    return aug


def al_ilqr_solve(
    fd: Callable,
    stage_cost: Callable,
    term_cost: Callable,
    constraint_fn: Optional[Callable],
    x0: torch.Tensor,
    us_init: torch.Tensor,
    al_iters: int = 3,
    inner_iters: int = 6,
    rho_init: float = 50.0,
    rho_factor: float = 10.0,
    mu0: Optional[torch.Tensor] = None,
    stagewise: bool = False,
    stage_data=None,
    alphas=ALPHAS,
):
    """Augmented-Lagrangian iLQR for inequality-constrained MPC, batched.

    PHR penalty (:func:`al_stage_cost`), multipliers mu <- max(0, mu + rho c)
    after each inner solve.  ``mu0`` (B, T, nc) warm-starts the multipliers.
    With ``stagewise=True`` the constraint takes (x, u, k), ``k`` the
    stage's slice of ``stage_data`` as for the cost (GP-MPC's
    horizon-propagated tightening).

    ``alphas`` are the inner solves' step sizes (:func:`ilqr_solve`).

    Returns (ILQRResult of the last inner solve, mu_final)."""
    if constraint_fn is None:
        res = ilqr_solve(fd, stage_cost, term_cost, x0, us_init, iters=al_iters * inner_iters,
                         alphas=alphas, stage_data=stage_data)
        return res, None
    cfn = constraint_fn if stagewise else (lambda x, u, k: constraint_fn(x, u))
    B, T = us_init.shape[:2]
    sd = _stage_data(stage_data, B, T, x0.device)
    if mu0 is None:
        nc = cfn(x0[0], us_init[0, 0], _tree_map(lambda a: a[0, 0], sd)).shape[0]
        mu0 = torch.zeros((B, T, nc), dtype=x0.dtype, device=x0.device)
    us, mu, rho = us_init, mu0, float(rho_init)
    res = None
    for _ in range(al_iters):
        res = ilqr_solve(fd, al_stage_cost(stage_cost, cfn, rho), term_cost, x0, us,
                         iters=inner_iters, alphas=alphas, stage_data=(sd, mu))
        c = vmap(cfn)(res.xs[:, :-1].reshape(B * T, -1), res.us.reshape(B * T, -1), _flat(sd, 2))
        mu = torch.clamp_min(mu + rho * c.reshape(B, T, -1), 0.0)
        us, rho = res.us, rho * rho_factor
    return res, mu
