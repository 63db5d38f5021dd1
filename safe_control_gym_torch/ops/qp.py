"""Small dense QPs by ADMM (OSQP splitting), batched.

Port of ``safe_control_gym_tpu/ops/qp.py`` (the replacement of the
reference's qpoases/qrqp solves in the CBF safety filter, cbf_qp.py:193-304):
a fixed iteration count and fixed shapes, over any leading batch dims.

    minimize   1/2 u' P u + q' u
    subject to l <= A u <= ub

The KKT inverse is ``linalg.inv_ex`` (no host sync on a card); a singular
KKT matrix gives non-finite iterates, which the caller sees in ``u``.
"""

from __future__ import annotations

import torch


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def solve_qp(P, q, A, l, ub, iters: int = 200, rho: float = 1.0, sigma: float = 1e-6):
    """ADMM on P (..., n, n), q (..., n), A (..., m, n), l and ub (..., m).
    Returns (u, z, y): primal, auxiliary, dual."""
    n = q.shape[-1]
    At = A.mT
    KKT = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device) + rho * (At @ A)
    KKT_inv = torch.linalg.inv_ex(KKT)[0]
    u = torch.zeros_like(q)
    z = torch.zeros_like(l)
    y = torch.zeros_like(l)
    for _ in range(iters):
        rhs = sigma * u - q + _mv(At, rho * z - y)
        u = _mv(KKT_inv, rhs)
        Au = _mv(A, u)
        z = torch.minimum(torch.maximum(Au + y / rho, l), ub)
        y = y + rho * (Au - z)
    return u, z, y


def qp_primal_residual(u, A, l, ub):
    """The largest bound violation of A u, (...)."""
    Au = _mv(A, u)
    return torch.clamp_min(torch.maximum(l - Au, Au - ub), 0.0).amax(-1)
