"""Control linear algebra: Riccati solvers and LQR gains.

Port of ``safe_control_gym_tpu/ops/linalg.py`` (the counterpart of the
reference's scipy calls, lqr_utils.py:18-37 and mpc_utils.py:58-77): both
algebraic Riccati equations are solved by fixed-iteration matrix recursions
on batched ``torch.linalg`` calls, so a tracking controller solves one
equation per waypoint in one batch on the device.  Every function takes
leading batch dims (the JAX package ``vmap``s them).

  * DARE: the structured doubling algorithm (SDA), quadratic convergence.
  * CARE: the matrix sign function by Newton's iteration with determinant
    scaling, then the stable subspace in least squares.
"""

from __future__ import annotations

import numpy as np
import torch


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _broadcast(*mats):
    """The matrices expanded to their common leading batch dims."""
    batch = torch.broadcast_shapes(*(m.shape[:-2] for m in mats))
    return [m.expand(batch + m.shape[-2:]) for m in mats]


def solve_discrete_are(A, B, Q, R, iters: int = 30):
    """Solve A'PA - P - A'PB(R + B'PB)^-1 B'PA + Q = 0 by SDA."""
    A, B, Q, R = _broadcast(A, B, Q, R)
    G = B @ torch.linalg.inv(R) @ B.mT
    I = _eye(A.shape[-1], A)
    Ak, Gk, Hk = A, G, Q
    for _ in range(iters):
        W = torch.linalg.inv(I + Gk @ Hk)
        AW = Ak @ W
        Ak, Gk, Hk = AW @ Ak, Gk + AW @ Gk @ Ak.mT, Hk + Ak.mT @ Hk @ W @ Ak
    return Hk


def solve_continuous_are(A, B, Q, R, iters: int = 40):
    """Solve A'P + PA - PB R^-1 B'P + Q = 0 by the matrix sign function.

    Z <- (c Z + Z^-1 / c) / 2 from the Hamiltonian H = [[A, -G], [-Q, -A']]
    with c = |det Z|^(-1/(2n)).  The JAX package takes ``det`` itself, which
    leaves the float32 range for the 3D quadrotor's 24x24 Hamiltonian; here c
    comes from ``slogdet``, the same number where ``det`` is finite.  The
    stable subspace of H has sign -1, so S12 P = -(S11 + I) and
    (S22 + I) P = -S21 (Roberts' method): the stacked (2n, n) system has
    full rank and is solved in least squares (by QR on CUDA)."""
    A, B, Q, R = _broadcast(A, B, Q, R)
    n = A.shape[-1]
    G = B @ torch.linalg.inv(R) @ B.mT
    Z = torch.cat([torch.cat([A, -G], -1), torch.cat([-Q, -A.mT], -1)], -2)
    for _ in range(iters):
        _, logabsdet = torch.linalg.slogdet(Z)
        c = torch.exp(-logabsdet / (2 * n))[..., None, None]
        Z = 0.5 * (c * Z + torch.linalg.inv(Z) / c)
    I = _eye(n, A)
    M = torch.cat([Z[..., :n, n:], Z[..., n:, n:] + I], -2)
    rhs = -torch.cat([Z[..., :n, :n] + I, Z[..., n:, :n]], -2)
    P = torch.linalg.lstsq(M, rhs).solution
    return 0.5 * (P + P.mT)


def dlqr_gain(A, B, Q, R):
    """Discrete LQR gain K of u = -K x (lqr_utils.py:25-31), and P."""
    A, B, Q, R = _broadcast(A, B, Q, R)
    P = solve_discrete_are(A, B, Q, R)
    BtP = B.mT @ P
    return torch.linalg.solve(R + BtP @ B, BtP @ A), P


def clqr_gain(A, B, Q, R):
    """Continuous LQR gain K = R^-1 B'P (lqr_utils.py:33-36), and P."""
    A, B, Q, R = _broadcast(A, B, Q, R)
    P = solve_continuous_are(A, B, Q, R)
    return torch.linalg.solve(R, B.mT @ P), P


def get_cost_weight_matrix(weights, dim):
    """Diagonal weight matrix from a scalar or list (mpc_utils.py:9-21),
    float64 NumPy."""
    w = np.asarray(weights, dtype=float).reshape(-1)
    if w.size == 1:
        w = np.full(dim, w[0])
    if w.size != dim:
        raise ValueError(f"Wrong dimension for cost weights: {w.size} for {dim}")
    return np.diag(w)
