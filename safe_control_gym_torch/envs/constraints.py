"""Batched constraint evaluation (box forms).

Port of ``safe_control_gym_tpu/envs/constraints.py`` for the forms the
config-4 main path uses: ``default_constraint`` and ``bounded_constraint``
on state or input.  The spec list compiles once into stacked matrices, and
evaluation is one affine map over (state, input).  Semantics kept from the
reference: every row is g(x) <= 0, values are rounded to 8 decimals before
the violation test, ``strict`` rows violate at >= 0 and others at > 0, and
rows follow the spec order.  Linear, quadratic and symmetric forms raise
``NotImplementedError`` when the env is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from safe_control_gym_torch.envs.benchmark import EnvSpaces

BIG = 1e30  # Stand-in for the reference's float32 max bounds.


@dataclasses.dataclass(frozen=True)
class CompiledConstraints:
    """Stacked box-constraint program: values = x A_x^T + u A_u^T - b."""

    num_constraints: int
    A_x: torch.Tensor  # (nc, nx)
    A_u: torch.Tensor  # (nc, nu)
    b: torch.Tensor  # (nc,)
    strict: torch.Tensor  # (nc,) bool
    tolerance: torch.Tensor  # (nc,) float; -inf disables almost-active
    state_only_rows: np.ndarray  # (nc,) bool: rows of state constraints
    rounding: int = 8

    def get_values(self, x, u):
        """x: (B, nx), u: (B, nu) -> (B, nc), rounded to 8 decimals."""
        vals = x @ self.A_x.T + u @ self.A_u.T - self.b
        scale = 10.0 ** self.rounding
        return torch.round(vals * scale) / scale

    def is_violated(self, values):
        """Any row violated -> (B,) bool."""
        hit = torch.where(self.strict, values >= 0.0, values > 0.0)
        return hit.any(-1)

    def is_almost_active(self, values):
        """Any row within tolerance of violation -> (B,) bool."""
        return (values + self.tolerance > 0.0).any(-1)

    def get_state_values(self, x):
        """State-constraint rows only (reset info)."""
        u = torch.zeros(x.shape[:-1] + (self.A_u.shape[1],), dtype=x.dtype, device=x.device)
        idx = torch.as_tensor(np.nonzero(self.state_only_rows)[0], device=x.device)
        return self.get_values(x, u)[..., idx]


def _filter_matrix(dim: int, active_dims) -> np.ndarray:
    if active_dims is None:
        return np.eye(dim)
    if isinstance(active_dims, int):
        active_dims = [active_dims]
    return np.eye(dim)[np.asarray(active_dims)]


def build_constraints(
    specs: Optional[Sequence[dict]], spaces: EnvSpaces, device, dtype=torch.float32
) -> Optional[CompiledConstraints]:
    """Compile YAML box-constraint specs (reference create_constraint_list,
    constraints.py:594-612)."""
    if not specs:
        return None
    nx, nu = spaces.state_dim, spaces.action_dim
    Axs, Aus, bs, strict_v, tol_v, state_v = [], [], [], [], [], []
    for spec in specs:
        spec = dict(spec)
        form = spec.pop("constraint_form")
        var = spec.pop("constrained_variable")
        strict = bool(spec.pop("strict", False))
        active_dims = spec.pop("active_dims", None)
        tolerance = spec.pop("tolerance", None)
        if form not in ("bounded_constraint", "default_constraint"):
            raise NotImplementedError(
                f"constraint_form {form!r} is not ported yet (box forms only)")
        if var not in ("state", "input"):
            raise NotImplementedError(
                f"constrained_variable {var!r} is not ported yet (state or input)")
        dim = nx if var == "state" else nu
        F = _filter_matrix(dim, active_dims)
        if form == "default_constraint":
            # Bounds default to the env spaces (constraints.py:307-368),
            # clamped to a finite BIG so the affine evaluation stays NaN-free.
            if var == "state":
                lo_def, hi_def = spaces.state_low, spaces.state_high
            else:
                lo_def, hi_def = spaces.action_low, spaces.action_high
            lo = np.maximum(np.asarray(spec.get("lower_bounds", lo_def), float), -BIG)
            hi = np.minimum(np.asarray(spec.get("upper_bounds", hi_def), float), BIG)
        else:
            lo = np.array(spec["lower_bounds"], ndmin=1, dtype=float)
            hi = np.array(spec["upper_bounds"], ndmin=1, dtype=float)
        d = lo.shape[0]
        A_full = np.vstack([-np.eye(d), np.eye(d)]) @ F  # (2d, dim)
        zeros = np.zeros((2 * d, nu if var == "state" else nx))
        Axs.append(A_full if var == "state" else zeros)
        Aus.append(zeros if var == "state" else A_full)
        bs.append(np.hstack([-lo, hi]))
        strict_v += [strict] * (2 * d)
        if tolerance is None:
            tol_v += [-np.inf] * (2 * d)
        else:
            t = np.array(tolerance, ndmin=1, dtype=float)
            tol_v += (t if t.size == 2 * d else np.full(2 * d, t[0])).tolist()
        state_v += [var == "state"] * (2 * d)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return CompiledConstraints(
        num_constraints=len(strict_v),
        A_x=dev(np.vstack(Axs)),
        A_u=dev(np.vstack(Aus)),
        b=dev(np.hstack(bs)),
        strict=dev(strict_v, torch.bool),
        tolerance=dev(tol_v),
        state_only_rows=np.asarray(state_v, bool),
    )


def box_bounds_view(specs, nx: int, nu: int, spaces=None):
    """Per-dim box bounds when ``specs`` is a pure box program, else None.

    The whole-rollout kernel counts violations with per-dimension bound
    tests, which is exact only when every spec is a non-strict default or
    bounded box on ``state`` or ``input``.  Returns ``(s_lo, s_hi, u_lo,
    u_hi)`` with bounds intersected across specs and ``±BIG`` where
    unconstrained; with ``spaces=None`` default-constraint bounds degrade to
    ``±BIG`` placeholders (enough for a validity check)."""
    if not specs:
        return None
    s_lo, s_hi = np.full(nx, -BIG), np.full(nx, BIG)
    u_lo, u_hi = np.full(nu, -BIG), np.full(nu, BIG)
    for spec in specs:
        form = spec.get("constraint_form")
        var = spec.get("constrained_variable")
        if form not in ("bounded_constraint", "default_constraint"):
            return None
        if var not in ("state", "input"):
            return None
        if spec.get("strict", False):
            return None
        dim = nx if var == "state" else nu
        ad = spec.get("active_dims")
        dims = np.arange(dim) if ad is None else np.atleast_1d(np.asarray(ad, int))
        if dims.ndim != 1 or (dims < 0).any() or (dims >= dim).any():
            return None
        if form == "default_constraint":
            if spaces is not None:
                lo_def = np.asarray(
                    spaces.state_low if var == "state" else spaces.action_low, float)
                hi_def = np.asarray(
                    spaces.state_high if var == "state" else spaces.action_high, float)
            else:
                lo_def, hi_def = np.full(dim, -BIG), np.full(dim, BIG)
            lo = np.asarray(spec.get("lower_bounds", lo_def[dims]), float).ravel()
            hi = np.asarray(spec.get("upper_bounds", hi_def[dims]), float).ravel()
        else:
            if "lower_bounds" not in spec or "upper_bounds" not in spec:
                return None
            lo = np.asarray(spec["lower_bounds"], float).ravel()
            hi = np.asarray(spec["upper_bounds"], float).ravel()
        if lo.size != dims.size or hi.size != dims.size:
            return None
        tgt_lo, tgt_hi = (s_lo, s_hi) if var == "state" else (u_lo, u_hi)
        np.maximum.at(tgt_lo, dims, np.maximum(lo, -BIG))
        np.minimum.at(tgt_hi, dims, np.minimum(hi, BIG))
    return s_lo, s_hi, u_lo, u_hi
