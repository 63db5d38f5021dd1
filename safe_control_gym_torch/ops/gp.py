"""Gaussian-process regression (SE-ARD) on tensors.

Port of ``safe_control_gym_tpu/ops/gp.py`` (the counterpart of the
reference's gpytorch stack, controllers/mpc/gp_utils.py): independent
zero-mean GPs, one per output dim, with squared-exponential ARD kernels
(covSEard, gp_utils.py:17-39), fitted by Adam on the exact negative log
marginal likelihood, and k-means inducing points (gp_utils.py:713-725) by
Lloyd's iterations.  The output dims are a leading batch dim of every
function (the JAX package ``vmap``s them).  Choleskys are
``linalg.cholesky_ex`` (no host sync on a card); ``gp_fit`` checks their
``info`` once, after the fit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from safe_control_gym_torch.models.optim import Adam


def se_ard_kernel(x1, x2, lengthscales, signal_var):
    """K(x1, x2) with ARD lengthscales: x1 (n, d), x2 (m, d), lengthscales
    (..., d), signal_var (...) -> (..., n, m).  Matches covSEard
    (gp_utils.py:17-39)."""
    z1 = x1 / lengthscales[..., None, :]
    z2 = x2 / lengthscales[..., None, :]
    d2 = ((z1[..., :, None, :] - z2[..., None, :, :]) ** 2).sum(-1)
    return signal_var[..., None, None] * torch.exp(-0.5 * d2)


class GPParams(NamedTuple):
    log_lengthscales: torch.Tensor  # (ny, d)
    log_signal_var: torch.Tensor  # (ny,)
    log_noise_var: torch.Tensor  # (ny,)


class GPState(NamedTuple):
    params: GPParams
    train_x: torch.Tensor  # (n, d)
    train_y: torch.Tensor  # (n, ny)
    alpha: torch.Tensor  # (ny, n): K^-1 y, precomputed
    L: torch.Tensor  # (ny, n, n): Cholesky of K + noise


def _gram_cholesky(x, log_ls, log_sv, log_nv):
    """Cholesky of K(x, x) + (noise + 1e-6) I per output dim, and its info."""
    n = x.shape[0]
    K = se_ard_kernel(x, x, torch.exp(log_ls), torch.exp(log_sv))
    K = K + (torch.exp(log_nv) + 1e-6)[..., None, None] * torch.eye(n, dtype=x.dtype,
                                                                      device=x.device)
    return torch.linalg.cholesky_ex(K)


def _nll(params_i, x, y, info=None):
    """Negative log marginal likelihood: params (..., d+2) (log
    lengthscales, log signal and noise variance), x (n, d), y (..., n)
    -> (...).  ``info``, where given, gathers the Choleskys' failures."""
    n = x.shape[0]
    L, bad = _gram_cholesky(x, params_i[..., :-2], params_i[..., -2], params_i[..., -1])
    if info is not None:
        info |= bad != 0
    a = torch.cholesky_solve(y[..., None], L)[..., 0]
    logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return 0.5 * (y * a).sum(-1) + logdet + 0.5 * n * math.log(2 * math.pi)


def gp_fit(train_x, train_y, iters: int = 200, lr: float = 0.05) -> GPState:
    """Fit independent GPs to train_x (n, d), train_y (n, ny): Adam (optax's,
    lr ``lr``) on each output dim's NLL, all dims at once."""
    n, d = train_x.shape
    ny = train_y.shape[1]
    like = dict(dtype=train_x.dtype, device=train_x.device)
    theta = torch.cat([torch.zeros((ny, d), **like), torch.zeros((ny, 1), **like),
                       torch.full((ny, 1), -4.0, **like)], -1)
    y = train_y.T.contiguous()
    # The dims' losses are independent, so the sum's gradient is each
    # dim's own; no clipping (max_norm inf), as optax.adam.
    opt = Adam([theta], lr=lr, max_norm=float("inf"))
    info = torch.zeros(ny, dtype=torch.bool, device=train_x.device)
    for _ in range(iters):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            g, = torch.autograd.grad(_nll(th, train_x, y, info).sum(), th)
        opt.step([g])
    params = GPParams(log_lengthscales=theta[:, :d].clone(), log_signal_var=theta[:, d].clone(),
                      log_noise_var=theta[:, d + 1].clone())
    L, bad = _gram_cholesky(train_x, *params)
    if bool((info | (bad != 0)).any()):
        raise RuntimeError("gp_fit: a Gram matrix is not positive definite")
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    return GPState(params, train_x, train_y, alpha, L)


def gp_mean(state: GPState, z):
    """Posterior mean at z (..., d) -> (..., ny), on any leading dims (the
    GP-MPC dynamics evaluate it inside ``torch.func`` transforms)."""
    p = state.params
    ls, sv = torch.exp(p.log_lengthscales), torch.exp(p.log_signal_var)  # (ny, d), (ny,)
    zs = z[..., None, None, :] / ls[:, None, :]  # (..., ny, 1, d)
    d2 = ((zs - state.train_x / ls[:, None, :]) ** 2).sum(-1)  # (..., ny, n)
    return (sv[:, None] * torch.exp(-0.5 * d2) * state.alpha).sum(-1)


def gp_predict(state: GPState, x_query):
    """Posterior mean and variance at x_query (m, d) -> ((m, ny), (m, ny))."""
    p = state.params
    sv = torch.exp(p.log_signal_var)
    Ks = se_ard_kernel(x_query, state.train_x, torch.exp(p.log_lengthscales), sv)  # (ny, m, n)
    v = torch.linalg.solve_triangular(state.L, Ks.mT, upper=False)
    var = sv[:, None] - (v**2).sum(-2)
    return gp_mean(state, x_query), torch.clamp_min(var, 1e-8).T


def lloyd(x, centroids, iters: int = 20):
    """Lloyd's iterations from the given centroids (k, d); an empty
    cluster keeps its centroid."""
    k = centroids.shape[0]
    for _ in range(iters):
        d2 = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        onehot = F.one_hot(d2.argmin(-1), k).to(x.dtype)
        counts = onehot.sum(0)[:, None]
        sums = onehot.T @ x
        centroids = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centroids)
    return centroids


def kmeans(generator: torch.Generator, x, k: int, iters: int = 20):
    """k-means (inducing points; gp_utils.py:713-725): k distinct rows of x
    drawn from ``generator`` (on x's device), then :func:`lloyd`."""
    idx = torch.randperm(x.shape[0], generator=generator, device=x.device)[:k]
    return lloyd(x, x[idx], iters)
